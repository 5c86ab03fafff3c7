"""The W8A8 prefill's kernels (csrc/w8a8_gemm.cu: quantize_rows_kernel,
kmajor_transpose_kernel, s8gemm_kernel) and their wrappers in ops/quant.py.

On the CPU: the plain versions and the dispatch (the route the JAX-parity
tests hold), the tile-width plan, and the wrappers' argument checks (run on
`meta` tensors, which take the CUDA branch up to the launch). On a CUDA card
(marked `card`; skipped without one): the quantizer's int8 values and scales
and the GEMM's output bit-equal to the PyTorch route they replace
(quantize_activation_rows' maths, `_int8_dot` on torch._int_mm, `_w8a8_scale`)
at the two benchmark cells' shapes, each with a planted fault the measure
must catch, and a 2-layer CUDA prefill that runs 7 GEMMs a layer and no
torch._int_mm. This file imports nothing of JAX, so the card tests run on
the card as they are:

    python -m pytest tests/test_torch_w8a8_gemm.py -m card
"""

import pytest
import torch

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.models import llama
from revisionllm_tpu_torch.ops import quant as Q
from revisionllm_tpu_torch.utils import kernels

torch.set_num_threads(2)

T_CELL = 304                 # positions a row of the cells' 64-row chunk (302-314)
M_CELL = 64 * T_CELL
# (K, N) of the cells' matrices: ChatGLM2-6B's q/o, k/v, gate/up, down;
# DeepSeek-LLM-7B's gate/up, down
CELL_SHAPES = ((4096, 4096), (4096, 256), (4096, 13696), (13696, 4096), (4096, 11008),
               (11008, 4096))


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    Q.set_w8a8(None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/w8a8_gemm.cu runs only there")
    return torch.device("cuda")


def _rows(M, K, device, seed):
    """bf16 [M, K] of normals, with a zero row (scale 1) and a row whose
    absmax is 127 (scale 1 exactly), so that its quotients x.5 test the
    rounding half to even."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device)
    x[0] = 0.0
    x[1] = torch.arange(K, device=device) % 8 - 3.5
    x[1, 0] = 127.0
    return x.to(torch.bfloat16)


def _weight(K, N, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return Q.quantize_int8(torch.randn((K, N), generator=gen, device=device) * K ** -0.5)


def _old_route(x, x_q8, x_scale, w_q8, w_scale):
    """The PyTorch route the GEMM replaces: torch._int_mm's int32 product,
    then the two f32 scales and the cast."""
    return Q._w8a8_scale(Q._int8_dot(x_q8, w_q8), x, x_scale, w_scale)


# ------------------------------------------------------------------- the CPU


def test_quantize_rows_plain_rounds_half_to_even_and_keeps_zero_rows():
    x = _rows(3, 16, "cpu", 0)
    q, s = Q.quantize_rows_plain(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 1)
    assert s[0].item() == 1.0 and not q[0].any()
    assert s[1].item() == 1.0
    assert q[1].tolist() == [127, -2, -2, 0, 0, 2, 2, 4] + [-4, -2, -2, 0, 0, 2, 2, 4]


@pytest.mark.parametrize("shape", [(37, 64), (2, 5, 3, 128)], ids=["rows", "prompt_cache"])
def test_quantize_rows_on_the_cpu_is_its_plain_version(shape):
    """quantize_rows on a CPU tensor keeps the leading shape, equals the plain
    version and quantize_activation_rows, and launches nothing."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    kernels.reset_launches()
    q, s = Q.quantize_rows(x)
    assert q.shape == shape and s.shape == (*shape[:-1], 1)
    pq, ps = Q.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    aq, as_ = Q.quantize_activation_rows(x)
    assert torch.equal(aq, q.reshape(-1, shape[-1])) and torch.equal(as_, s.reshape(-1, 1))
    assert not any(kernels.LAUNCHES.values())


def test_quantize_activation_rows_takes_a_given_absmax():
    """The row-parallel slice: quantized by its whole row's absmax (the
    plain route, as before)."""
    x = torch.randn(5, 32).to(torch.bfloat16)
    amax = torch.full((5, 1), 8.0)
    q, s = Q.quantize_activation_rows(x, amax)
    assert torch.equal(s, torch.full((5, 1), 8.0 / 127.0))
    assert torch.equal(q, torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8a8_gemm_on_the_cpu_is_the_old_route(out_dtype):
    x = _rows(300, 64, "cpu", 2).to(out_dtype)
    xq, xs = Q.quantize_rows_plain(x.to(torch.bfloat16))
    wq, ws = _weight(64, 48, "cpu", 3)
    kernels.reset_launches()
    got = Q.w8a8_gemm(xq, xs, wq, ws, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, _old_route(x, xq, xs, wq, ws))
    assert torch.equal(Q.w8a8_gemm_plain(xq, xs, wq, ws, out_dtype), got)
    assert torch.equal(Q.w8a8_prequant_matmul(xq, xs, wq, ws, out_dtype=out_dtype), got)
    wide = torch.zeros((300, 3 * 48), dtype=out_dtype)
    part = wide[:, 48:96]
    assert Q.w8a8_gemm(xq, xs, wq, ws, out=part) is part
    assert torch.equal(part, got) and not wide[:, :48].any() and not wide[:, 96:].any()
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("concat", [False, True], ids=["matrices", "column_chunks"])
def test_w8a8_products_on_the_cpu_share_one_quantization(concat):
    """q8_apply_multi and q8c_apply's W8A8 route on the CPU: each product
    equals the old route on the shared quantization; nothing launches."""
    Q.set_w8a8(True)
    x = torch.randn(3, 100, 64).to(torch.bfloat16)
    mats = [_weight(64, 32, "cpu", s) for s in (4, 5)]
    kernels.reset_launches()
    if concat:
        q8c = torch.stack([m[0] for m in mats])
        outs = Q.q8c_apply(x, {"q8c": q8c, "scale": torch.cat([m[1] for m in mats])})
        outs = outs.split(32, dim=-1)
    else:
        outs = Q.q8_apply_multi(x, [{"q8": q, "scale": s} for q, s in mats])
    xq, xs = Q.quantize_rows_plain(x.reshape(-1, 64))
    for got, (wq, ws) in zip(outs, mats):
        assert torch.equal(got.reshape(-1, 32), _old_route(x, xq, xs, wq, ws).reshape(-1, 32))
    assert not any(kernels.LAUNCHES.values())


def test_prompt_cache_quantization_is_quantize_rows():
    kv = {n: torch.randn(2, 3, 7, 2, 128).to(torch.bfloat16) for n in ("k", "v")}
    out = llama.quantize_prompt_kv(kv)
    for n in ("k", "v"):
        q, s = Q.quantize_rows_plain(kv[n])
        assert torch.equal(out[n], q) and torch.equal(out[f"{n}_scale"], s[..., 0])


@pytest.mark.parametrize("M,N,nb", [
    (M_CELL, 256, 1),      # ChatGLM2's k and v: 152 wide tiles leave a second wave of 20
    (M_CELL, 4096, 2),
    (M_CELL, 11008, 2),
    (M_CELL, 13696, 2),
    (257, 4096, 1),        # 48 wide tiles fill 48 SMs; 96 narrow ones finish first
])
def test_w8a8_tile_columns(M, N, nb):
    assert Q.w8a8_tile_columns(M, N, 132) == nb


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,dtype", [
    ((64, 4096), torch.float32),
    ((64, 4100), torch.bfloat16),
    ((64, Q.QROWS_MAX_K + 8), torch.bfloat16),
], ids=["f32", "k_not_multiple_of_8", "k_too_wide"])
def test_quantize_rows_checks_its_arguments(shape, dtype):
    """The wrapper's CUDA branch (taken by any device but the CPU) refuses
    what the kernel does not take, before any launch."""
    with pytest.raises(ValueError, match="quantize_rows kernel"):
        Q.quantize_rows(_meta(shape, dtype))


def test_quantize_rows_of_no_rows_launches_nothing():
    kernels.reset_launches()
    q, s = Q.quantize_rows(_meta((0, 4, 128), torch.bfloat16))
    assert q.shape == (0, 4, 128) and s.shape == (0, 4, 1)
    assert not any(kernels.LAUNCHES.values())


def _gemm_args(M=300, K=64, N=48, **over):
    args = {"x_q8": _meta((M, K), torch.int8), "x_scale": _meta((M, 1), torch.float32),
            "w_q8": _meta((K, N), torch.int8), "w_scale": _meta((N,), torch.float32)}
    args.update(over)
    return args


@pytest.mark.parametrize("case", [
    "k_not_multiple_of_16", "n_not_multiple_of_16", "weight_rows", "x_scale_shape",
    "w_scale_shape", "x_dtype", "f16_out", "out_shape", "out_column_stride", "out_odd_row_stride",
    "bf16_out_row_stride_not_multiple_of_8",
])
def test_w8a8_gemm_checks_its_arguments(case):
    kw = {}
    if case == "k_not_multiple_of_16":
        args = _gemm_args(K=72, w_q8=_meta((72, 48), torch.int8))
    elif case == "n_not_multiple_of_16":
        args = _gemm_args(N=40, w_scale=_meta((40,), torch.float32))
    elif case == "weight_rows":
        args = _gemm_args(w_q8=_meta((80, 48), torch.int8))
    elif case == "x_scale_shape":
        args = _gemm_args(x_scale=_meta((300,), torch.float32))
    elif case == "w_scale_shape":
        args = _gemm_args(w_scale=_meta((1, 48), torch.float32))
    elif case == "x_dtype":
        args = _gemm_args(x_q8=_meta((300, 64), torch.uint8))
    elif case == "f16_out":
        args, kw = _gemm_args(), {"out_dtype": torch.float16}
    elif case == "out_shape":
        args, kw = _gemm_args(), {"out": _meta((300, 64), torch.bfloat16)}
    elif case == "out_column_stride":
        args, kw = _gemm_args(), {"out": _meta((48, 300), torch.bfloat16).t()}
    elif case == "out_odd_row_stride":
        args, kw = _gemm_args(), {"out": _meta((300, 99), torch.float32)[:, :48]}
    else:
        args, kw = _gemm_args(), {"out": _meta((300, 100), torch.bfloat16)[:, :48]}
    with pytest.raises(ValueError, match="w8a8_gemm kernel"):
        Q.w8a8_gemm(**args, **kw)


# ------------------------------------------------------------------ the card


@pytest.mark.card
@pytest.mark.parametrize("M,K", [(M_CELL, 4096), (M_CELL, 13696), (M_CELL, 11008), (257, 4096),
                                 (M_CELL * 2, 128), (M_CELL * 32, 128)],
                         ids=["x_4096", "glm_ffn", "deepseek_ffn", "m257", "glm_kv_rows",
                              "deepseek_kv_rows"])
def test_card_quantize_rows_is_bit_equal(card, M, K):
    """The kernel's int8 values and scales equal the plain version's (on the
    card PyTorch's absmax / 127.0 multiplies by the f32 reciprocal); the
    scale by an IEEE division (the planted fault: the CPU's rounding) must
    differ from them."""
    x = _rows(M, K, card, M + K)
    kernels.reset_launches()
    q, s = Q.quantize_rows(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_rows"] == 1
    pq, ps = Q.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    fault = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    assert not torch.equal(s, fault)


@pytest.mark.card
@pytest.mark.parametrize("K,N", CELL_SHAPES, ids=[f"k{k}_n{n}" for k, n in CELL_SHAPES])
@pytest.mark.parametrize("M", [M_CELL, 257], ids=["m_cell", "m257"])
def test_card_w8a8_gemm_is_bit_equal(card, M, K, N):
    """One transpose and one GEMM launch give the old route's bf16 output
    bit for bit, and its f32 product before the cast. Planted faults the
    measure must catch in the f32 output (where every rounding shows): the
    two scales multiplied together first (another epilogue rounding), and
    the weight's last 16 K rows dropped (a transpose that loses the K
    tail)."""
    x = _rows(M, K, card, K + N)
    xq, xs = Q.quantize_rows_plain(x)
    wq, ws = _weight(K, N, card, N)
    kernels.reset_launches()
    got = Q.w8a8_gemm(xq, xs, wq, ws)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["w8a8_transpose"] == 1 and kernels.LAUNCHES["w8a8_gemm"] == 1
    acc = Q._int8_dot(xq, wq)
    assert torch.equal(got, Q._w8a8_scale(acc, x, xs, ws))
    f32 = Q.w8a8_gemm(xq, xs, wq, ws, out_dtype=torch.float32)
    assert torch.equal(f32, acc.float() * xs * ws)
    assert not torch.equal(f32, acc.float() * (xs * ws))
    cut = wq.clone()
    cut[-16:] = 0
    assert not torch.equal(f32, Q._int8_dot(xq, cut).float() * xs * ws)


# (M, K, N): M 1 and 130 (a second row tile of 2 rows), K 80 (one stage,
# zeros past K) and 4112 (a 16-byte last stage), N 160, 272 and 4112 (a 32-
# or 16-column last box)
EDGES = ((1, 4096, 256), (130, 80, 160), (257, 4112, 4112), (300, 13696, 272), (2000, 11008, 4112))


@pytest.mark.card
@pytest.mark.parametrize("M,K,N", EDGES, ids=[f"m{m}_k{k}_n{n}" for m, k, n in EDGES])
@pytest.mark.parametrize("nb", [1, 2], ids=["tile128", "tile256"])
def test_card_w8a8_gemm_edges(card, monkeypatch, nb, M, K, N):
    """The ragged edges at both tile widths (the plan overridden)."""
    monkeypatch.setattr(Q, "w8a8_tile_columns", lambda *a: nb)
    x = _rows(M, K, card, M * N + K) if M > 1 else torch.randn((1, K), device=card).bfloat16()
    xq, xs = Q.quantize_rows(x)
    pq, ps = Q.quantize_rows_plain(x)
    wq, ws = _weight(K, N, card, M)
    assert torch.equal(xq, pq) and torch.equal(xs, ps)
    assert torch.equal(Q.w8a8_gemm(xq, xs, wq, ws), _old_route(x, xq, xs, wq, ws))


@pytest.mark.card
def test_card_w8a8_gemm_writes_a_column_slice_and_f32(card):
    """The serving layout's column chunks (an output row stride) and the
    f32 output of w8a8_prequant_matmul under tensor parallelism."""
    M, K, N = 1000, 4096, 1024
    x = _rows(M, K, card, 7)
    xq, xs = Q.quantize_rows_plain(x)
    wq, ws = _weight(K, N, card, 8)
    wide = torch.zeros((M, 3 * N), dtype=torch.bfloat16, device=card)
    Q.w8a8_gemm(xq, xs, wq, ws, out=wide[:, N:2 * N])
    assert torch.equal(wide[:, N:2 * N], _old_route(x, xq, xs, wq, ws))
    assert not wide[:, :N].any() and not wide[:, 2 * N:].any()
    f32 = Q.w8a8_prequant_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
    assert torch.equal(f32, Q._int8_dot(xq, wq).float() * xs * ws)


@pytest.mark.card
def test_card_prefill_runs_the_kernels_and_no_int_mm(card, monkeypatch):
    """A 2-layer prefill on the card (M = 2 x 160 > 256 rows, W8A8 on by
    default there, int8 prompt cache) launches 7 GEMMs a layer, one
    quantization per group of matrices sharing x and one per k and v, and
    never calls torch._int_mm."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=2, head_dim=128)
    params = llama.init_params(cfg, seed=0, device=card, quantize="int8")
    calls = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda *a: calls.append(1) or real(*a))
    gen = torch.Generator(device=card).manual_seed(1)
    embeds = torch.randn((2, 160, 256), generator=gen, device=card).to(torch.bfloat16)
    positions = torch.arange(160, device=card).expand(2, 160)
    kv_lens = torch.tensor([160, 97], device=card)
    kernels.reset_launches()
    logits, cache = llama.prefill_kv(cfg, params, embeds, positions, kv_lens, kv_quant=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["w8a8_gemm"] == 7 * 2 and kernels.LAUNCHES["w8a8_transpose"] == 7 * 2
    assert kernels.LAUNCHES["quantize_rows"] == (4 + 2) * 2
    assert not calls and bool(logits.isfinite().all()) and cache["k"].dtype == torch.int8
