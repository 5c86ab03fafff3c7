"""Port parity: the serving weight layout and its whole-step decode
(ops/decode_serve.py, kernel row 10's plain version; ops.quant.q8c_apply and
the host packer; llama's slab prefill; generate's serve branch; the loader's
host pack) against revisionllm_tpu on the CPU, the Pallas kernel in
interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import revisionllm_tpu.models.llama as jllama
from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.ops import decode_serve as JDSV
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.ops.rope import rope_angles
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.eval import loader as tloader
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.ops import decode_serve as TDSV
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import CPU, assert_stage1_equal, engines, np_of, to_torch

torch.set_num_threads(2)

# tests/test_decode_serve.py's geometry: hidden 256, F 384, 2 heads of 128,
# 2 layers, B 4, S 40; block_n 128 and block_f 160 pad F to lcm 640
CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
           num_kv_heads=2, head_dim=128, max_position_embeddings=1024, dtype="float32")
BLOCKS = dict(block_n=128, block_f=160)
JAX_SERVE = functools.partial(JDSV.decode_step_serve, interpret=True)


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    for mod in (JQ, TQ):
        mod.set_w8a8(None)
        mod.set_exact_trace(False)
    for mod in (jgen, tgen):
        mod.set_kv8(None)
        mod.set_serve(None)


def _jpack(qp):
    return {**qp, "layers": JDSV.pack_serving_weights(qp["layers"], **BLOCKS)}


@pytest.fixture(scope="module")
def setup():
    """The int8 tree (lm_head too), its pack in both packages, and a KV8
    prefill of 4 ragged prompts of 40 positions (lengths 40, 37, 33, 39)."""
    jcfg = JCfg(**CFG)
    qp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    B, S = 4, 40
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(5, 256, (B, S)), jnp.int32)
    embeds = jllama.embed_tokens(qp, ids).astype(jnp.float32)
    positions = jnp.arange(S)[None, :].repeat(B, 0)
    lens = jnp.asarray([S, S - 3, S - 7, S - 1], jnp.int32)
    _, split = jllama.prefill_kv(jcfg, qp, embeds, positions, kv_lens=lens, kv_quant=True)
    tsplit = {k: torch.from_numpy(np.array(v)) for k, v in split.items()}
    tp = to_torch(qp)
    return dict(jcfg=jcfg, qp=qp, jpk=_jpack(qp), tp=tp,
                tpk={**tp, "layers": TDSV.pack_serving_weights(tp["layers"], **BLOCKS)},
                split=split, tsplit=tsplit, lens=lens, embeds=embeds, positions=positions)


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("blocks", [(128, 160), (128, 128), (256, 128)],
                         ids=["ragged-f", "square", "wide-n"])
def test_pack_and_unpack_match_jax(setup, blocks):
    """pack_serving_weights, its host variant and unpack_serving_weights
    equal JAX's element for element: column chunks with zero-padded columns
    and zero scales, row chunks with zero rows, norms passed through."""
    bn, bf = blocks
    jl, tl = setup["qp"]["layers"], setup["tp"]["layers"]
    jp = JDSV.pack_serving_weights(jl, block_n=bn, block_f=bf)
    tp = TDSV.pack_serving_weights(tl, block_n=bn, block_f=bf)
    hp = TQ.pack_serving_weights_host(jax.tree.map(np.asarray, jl), block_n=bn, block_f=bf)
    assert set(tp) == set(jp) == set(hp)
    for name, w in jp.items():
        for key, want in (w.items() if isinstance(w, dict) else [(None, w)]):
            got = tp[name][key] if key else tp[name]
            host = hp[name][key] if key else hp[name]
            assert got.dtype == (torch.int8 if key in ("q8c", "q8r") else got.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name} {key}")
            np.testing.assert_array_equal(np.asarray(host), np.asarray(want))
    ju, tu = JDSV.unpack_serving_weights(jp), TDSV.unpack_serving_weights(tp)
    assert set(tu) == set(ju)
    for name in ju:
        for key, want in (ju[name].items() if isinstance(ju[name], dict) else [(None, ju[name])]):
            got = tu[name][key] if key else tu[name]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    N = tl["gate_proj"]["q8"].shape[-1]
    assert torch.equal(tu["gate_proj"]["q8"][..., :N], tl["gate_proj"]["q8"])
    assert not tp["gate_proj"]["scale"][:, N:].any()


def test_unified_slab_matches_jax(setup):
    """pack_unified_kv: the same slab (head-major, k and v side by side,
    zero past S) and the same Sp = round_up(S + G, 128) and s0 = S."""
    for G in (8, 100):
        jslab, js0 = JDSV.pack_unified_kv(setup["split"], gen_slots=G)
        tslab, ts0 = TDSV.pack_unified_kv(setup["tsplit"], gen_slots=G)
        assert ts0 == js0 == 40 and tslab["kv"].shape == jslab["kv"].shape
        np.testing.assert_array_equal(tslab["kv"].numpy(), np.asarray(jslab["kv"]))
        np.testing.assert_array_equal(tslab["kvsc"].numpy(), np.asarray(jslab["kvsc"]))
    assert tslab["kv"].shape[4] == 256


def test_land_new_kv_matches_jax(setup):
    """land_new_kv quantizes newkv [L, 2, B, KH, hd] per (position, head)
    and writes slot s0 + step in place: int8 values equal JAX's, scales to
    f32 rounding, every other slot untouched."""
    jslab, s0 = JDSV.pack_unified_kv(setup["split"], gen_slots=8)
    tslab, _ = TDSV.pack_unified_kv(setup["tsplit"], gen_slots=8)
    before = {k: v.clone() for k, v in tslab.items()}
    newkv = np.random.default_rng(4).normal(size=(2, 2, 4, 2, 128)).astype(np.float32)
    newkv[0, 1, 2, 1] = 0.0  # an all-zero row takes scale 1, as in JAX
    want = JDSV.land_new_kv(jslab, jnp.asarray(newkv), s0, jnp.int32(3))
    got = TDSV.land_new_kv(tslab, torch.from_numpy(newkv), s0, 3)
    assert got is tslab
    np.testing.assert_array_equal(got["kv"].numpy(), np.asarray(want["kv"]))
    np.testing.assert_allclose(got["kvsc"].numpy(), np.asarray(want["kvsc"]), rtol=1e-7, atol=0)
    assert got["kvsc"][0, 2, 1, 1, s0 + 3] == 1.0
    keep = torch.ones(got["kv"].shape[4], dtype=torch.bool)
    keep[s0 + 3] = False
    assert torch.equal(got["kv"][..., keep, :], before["kv"][..., keep, :])


def test_supports_serve_matches_jax(setup):
    """MHA int8 trees, standard or packed with D a whole number of chunks;
    not GQA, dense, int4 or a pack whose chunks do not tile D."""
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jgqa, tgqa = JCfg(**{**CFG, "num_kv_heads": 1}), TCfg(**{**CFG, "num_kv_heads": 1})
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    qp = setup["qp"]
    ragged = {**qp, "layers": JDSV.pack_serving_weights(qp["layers"], block_n=96, block_f=96)}
    trees = (dense, qp, setup["jpk"], ragged, JQ.quantize_llama_params_int4(dense))
    got = [[TDSV.supports_serve(tc, to_torch(t)) for t in trees] for tc in (tcfg, tgqa)]
    assert got == [[JDSV.supports_serve(jc, t) for t in trees] for jc in (jcfg, jgqa)]
    assert got[0] == [False, True, True, False, False]


# ------------------------------------------------------- the chunked dispatch


def _chunk(layers, name):
    w = layers[name]
    key = "q8c" if "q8c" in w else "q8r"
    return {key: w[key][0], "scale": w["scale"][0]}


@pytest.mark.parametrize("route,M", [("K1 per chunk", 5), ("exact dequant", 300)])
@pytest.mark.parametrize("name", ["q_proj", "gate_proj"])
def test_q8c_apply_column_chunks_match_jax(setup, route, M, name):
    """Column chunks in f32 at M <= 256 (K1's plain version per chunk;
    JAX's CPU route dequantizes) and above it with W8A8 off (the exact
    route on both): within 1e-5 of JAX (f32 rounding of another order), and
    the padded columns exactly 0. Both equal the standard tree's result."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(M, 256)).astype(np.float32)
    jw, tw = _chunk(setup["jpk"]["layers"], name), _chunk(setup["tpk"]["layers"], name)
    want = np.asarray(JQ.q8_apply(jnp.asarray(x), jw))
    got = TQ.q8_apply(torch.from_numpy(x), tw).numpy()
    N = setup["tp"]["layers"][name]["q8"].shape[-1]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.shape == want.shape and not got[:, N:].any()
    lw = setup["tp"]["layers"][name]
    std = TQ.q8_apply(torch.from_numpy(x), {"q8": lw["q8"][0], "scale": lw["scale"][0]})
    np.testing.assert_allclose(got[:, :N], std.numpy(), rtol=1e-5, atol=1e-5)


def test_q8c_apply_row_chunks_match_jax(setup):
    """down_proj's row chunks: the padded [Fp, D] matrix through the
    standard dispatch; x's padded columns meet zero rows."""
    rng = np.random.default_rng(8)
    Fp = 640
    for M in (5, 300):
        x = np.zeros((M, Fp), np.float32)
        x[:, :384] = rng.normal(size=(M, 384))
        jw, tw = (_chunk(p["layers"], "down_proj") for p in (setup["jpk"], setup["tpk"]))
        want = np.asarray(JQ.q8_apply(jnp.asarray(x), jw))
        got = TQ.q8_apply(torch.from_numpy(x), tw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_q8c_exact_route_rounds_the_scale_to_bf16_as_jax(setup):
    """In bf16 JAX's exact route for column chunks multiplies int8 by the
    scale rounded to bf16 (ops/quant.py:431), not by the f32 scale as the
    standard route does (dequantize_int8). The port keeps the quirk: its
    outputs differ from JAX's by at most one bf16 step, in 0.004% of them
    (f32 sums in another order), where the standard route's differ in 50%."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 256)).astype(np.float32)
    jw = {k: v for k, v in _chunk(setup["jpk"]["layers"], "gate_proj").items()}
    tw = _chunk(setup["tpk"]["layers"], "gate_proj")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = np_of(JQ.q8_apply(jx, jw))
    got = np_of(TQ.q8_apply(tx, tw))
    lw = setup["tp"]["layers"]["gate_proj"]
    std = np_of(TQ.q8_apply(tx, {"q8": lw["q8"][0], "scale": lw["scale"][0]}))
    step = np.abs(want) * 2.0 ** -7 + 1e-6   # one bf16 step at each value
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got != want) < 1e-3
    assert np.mean(std != want[:, :384]) > 0.3


def test_exact_trace_forces_the_exact_route(setup, monkeypatch):
    """set_exact_trace(True): no K1 per chunk at M <= 256 and no W8A8
    above it, only the differentiable dequant route, as JAX's _EXACT_TRACE."""
    monkeypatch.setattr(TQ, "int8_matmul", lambda *a: pytest.fail("K1 under the exact trace"))
    monkeypatch.setattr(TQ._W8A8Product, "apply", lambda *a: pytest.fail("W8A8 under the trace"))
    TQ.set_w8a8(True)
    TQ.set_exact_trace(True)
    JQ.set_exact_trace(True)
    x = np.random.default_rng(10).normal(size=(300, 256)).astype(np.float32)
    tw = _chunk(setup["tpk"]["layers"], "q_proj")
    jw = _chunk(setup["jpk"]["layers"], "q_proj")
    for M in (8, 300):
        got = TQ.q8_apply(torch.from_numpy(x[:M]), tw).numpy()
        want = np.asarray(JQ.q8_apply(jnp.asarray(x[:M]), jw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_w8a8_colchunk_is_bit_equal_and_its_gradient_matches_jax(setup):
    """W8A8 over column chunks (M > 256) is bit-equal to the standard
    w8a8_matmul on the unpacked weight and to JAX's column-chunk W8A8;
    the straight-through gradient of sum(y^2) equals JAX's to f32
    rounding."""
    TQ.set_w8a8(True)
    JQ.set_w8a8(True)
    x = np.random.default_rng(21).normal(size=(300, 256)).astype(np.float32)
    lw = setup["tp"]["layers"]["q_proj"]
    tw, jw = _chunk(setup["tpk"]["layers"], "q_proj"), _chunk(setup["jpk"]["layers"], "q_proj")
    tx = torch.from_numpy(x).requires_grad_()
    got = TQ.q8_apply(tx, tw)
    std = TQ.w8a8_matmul(torch.from_numpy(x), lw["q8"][0], lw["scale"][0])
    assert torch.equal(got.detach(), std)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(JQ.q8_apply(jnp.asarray(x), jw)))
    (got ** 2).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(JQ.q8_apply(v, jw) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    assert tx.grad.abs().max() > 0


def test_q8_apply_multi_sends_chunks_matrix_by_matrix(setup, monkeypatch):
    """The shared W8A8 quantization takes standard int8 dicts only: packed
    matrices fall back to q8_apply one by one, as JAX's `plain` test."""
    TQ.set_w8a8(True)
    calls, real = [], TQ._W8A8Product.apply

    def spy(x, concat, *weights):
        calls.append((concat, len(weights)))
        return real(x, concat, *weights)

    monkeypatch.setattr(TQ._W8A8Product, "apply", spy)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(300, 256)).astype(np.float32))
    ws = [_chunk(setup["tpk"]["layers"], n) for n in ("q_proj", "k_proj")]
    outs = TQ.q8_apply_multi(x, ws)
    for out, w in zip(outs, ws):
        assert torch.equal(out, TQ.q8_apply(x, w))
    # each matrix alone over its 2 column chunks, never the shared standard path
    assert calls == [(True, 4)] * 4


# ---------------------------------------------------------- prefill and step


def test_prefill_kv_slab_matches_jax(setup):
    """prefill_kv(kv_slab_slots=G) on the packed trees: the slab JAX's
    prefill writes, int8 values within 1 and 99.9% equal (a value half an
    int8 step from a rounding boundary can round the other way after f32
    sums in another order), scales within 1e-5; zero past T; and the port's
    slab equals its own split cache repacked."""
    tcfg, jcfg = TCfg(**CFG), setup["jcfg"]
    G = 8
    jlog, jslab = jllama.prefill_kv(jcfg, setup["jpk"], setup["embeds"], setup["positions"],
                                    kv_lens=setup["lens"], kv_quant=True, kv_slab_slots=G)
    args = (tcfg, setup["tpk"], torch.from_numpy(np.array(setup["embeds"])),
            torch.from_numpy(np.array(setup["positions"])),
            torch.from_numpy(np.array(setup["lens"])))
    tlog, tslab = tllama.prefill_kv(*args, kv_quant=True, kv_slab_slots=G)
    assert set(tslab) == {"kv", "kvsc"} and tslab["kv"].shape == jslab["kv"].shape
    dq = np.abs(tslab["kv"].numpy().astype(np.int32) - np.asarray(jslab["kv"], np.int32))
    assert dq.max() <= 1 and (dq == 0).mean() >= 0.999
    np.testing.assert_allclose(tslab["kvsc"].numpy(), np.asarray(jslab["kvsc"]), rtol=1e-5)
    assert not tslab["kv"][:, :, :, :, 40:].any() and not tslab["kvsc"][:, :, :, :, 40:].any()
    np.testing.assert_allclose(np_of(tlog), np_of(jlog), rtol=1e-4, atol=1e-4)
    _, split = tllama.prefill_kv(*args, kv_quant=True)
    repacked, s0 = TDSV.pack_unified_kv(split, G)
    assert s0 == 40
    for k in ("kv", "kvsc"):
        assert torch.equal(tslab[k], repacked[k])
    with pytest.raises(AssertionError, match="kv_quant"):
        tllama.prefill_kv(*args, kv_slab_slots=G)


def test_decode_step_serve_plain_matches_pallas_interpret(setup):
    """Three steps of row 10's plain version against the Pallas kernel in
    interpret mode, on the packed trees and the slab, fed the same
    embeddings each step. As for row 9's (test_torch_decode_step.py), both
    sides round the same values to bf16 (h, q, p * v_scale, the attention
    output, m), but their f32 sums run in another order, so a value one f32
    ulp from a bf16 boundary can round the other way on one side: the
    hidden state and the landed k/v (dequantized) within 1e-2 of the
    largest value, their median element within 1e-5 of it (the same
    arithmetic; measured 1.7e-3 and 2.1e-7 of the largest value on this
    seed). The landed int8 values differ by at most 1 (23 of the 4096 a
    step lands here)."""
    jcfg = setup["jcfg"]
    lens = setup["lens"]
    jslab, s0 = JDSV.pack_unified_kv(setup["split"], gen_slots=8)
    tslab, _ = TDSV.pack_unified_kv(setup["tsplit"], gen_slots=8)
    tlens = torch.from_numpy(np.array(lens))
    rng = np.random.default_rng(2)
    for s in range(3):
        x = rng.normal(size=(4, 256)).astype(np.float32)
        cos, sin = rope_angles((lens + s)[:, None], 128, jcfg.rope_theta)
        want, jslab = JAX_SERVE(setup["jpk"]["layers"], jslab, lens, jnp.int32(s),
                                jnp.asarray(x), cos[:, 0], sin[:, 0], s0=s0,
                                eps=jcfg.rms_norm_eps)
        got, tslab = TDSV.decode_step_serve(
            setup["tpk"]["layers"], tslab, tlens, s, torch.from_numpy(x),
            torch.from_numpy(np.array(cos[:, 0])), torch.from_numpy(np.array(sin[:, 0])), s0,
            eps=jcfg.rms_norm_eps)
        live = slice(s0, s0 + s + 1)
        jkv, tkv = np.asarray(jslab["kv"])[..., live, :], tslab["kv"][..., live, :].numpy()
        jdq = jkv * np.asarray(jslab["kvsc"])[..., live, None]
        tdq = tkv * tslab["kvsc"][..., live, None].numpy()
        for g, w in ((np_of(got), np_of(want)), (tdq, jdq)):
            top = np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * top)
            assert np.median(np.abs(g - w)) <= 1e-5 * top
        assert np.abs(tkv.astype(np.int32) - jkv.astype(np.int32)).max() <= 1
        assert not tslab["kv"][..., s0 + s + 1:, :].any()


def test_decode_step_serve_reads_only_the_two_ranges(setup):
    """The dead range [plen, s0) and the slots at or past s0 + step do not
    enter the result: filling them with noise changes nothing."""
    jcfg = setup["jcfg"]
    tslab, s0 = TDSV.pack_unified_kv(setup["tsplit"], gen_slots=8)
    lens = torch.tensor([30, 37, 33, 39], dtype=torch.int32)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 256)).astype(np.float32))
    cos, sin = (torch.from_numpy(np.array(t[:, 0]))
                for t in rope_angles((np.array(lens) + 2)[:, None], 128, jcfg.rope_theta))
    args = (lens, 2, x, cos, sin, s0)
    want, _ = TDSV.decode_step_serve_plain(setup["tpk"]["layers"], tslab, *args)
    noisy = {k: v.clone() for k, v in tslab.items()}
    noisy["kv"][:, 0, :, :, 30:s0] = 77
    noisy["kv"][:, :, :, :, s0 + 2:] = -55
    noisy["kvsc"][:, :, :, :, s0 + 2:] = 3.0
    got, _ = TDSV.decode_step_serve_plain(setup["tpk"]["layers"], noisy, *args)
    assert torch.equal(got, want)


# ----------------------------------------------------------------- generate


def _prompts(B, T, P, lens, seed):
    """Right-padded f32 prompts whose rows share their first P embeddings."""
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, T, 256)) * 0.5).astype(np.float32)
    embeds[:, :P] = embeds[:1, :P]
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return embeds, positions, np.asarray(lens, np.int32)


@pytest.mark.parametrize("shared_prefix_len", [0, 9], ids=["full-prefill", "shared-prefix"])
def test_generate_on_a_packed_tree_matches_jax(setup, monkeypatch, shared_prefix_len):
    """The slice as a whole: generate on the packed tree with KV8 in both
    packages, full prefill (the slab written by the prefill) and
    shared-prefix prefill (the split cache repacked): greedy tokens and
    validity identical at every step; the entropy within 2e-3 and the
    chosen token's log-probability within 2e-2, row 9's measure (bf16
    roundings see inputs that differ in the last f32 bits; measured 1.0e-3
    and 3.8e-3 here). The port runs row 10's step G - 1 times (JAX's scan runs a
    last step whose logits it drops) and never decode_step_split."""
    monkeypatch.setattr(JDSV, "decode_step_serve", JAX_SERVE)
    for mod in (jgen, tgen):
        mod.set_kv8(True)
    calls = []
    orig = TDSV.decode_step_serve
    monkeypatch.setattr(TDSV, "decode_step_serve",
                        lambda *a, **k: calls.append(a[3]) or orig(*a, **k))
    monkeypatch.setattr(tllama, "decode_step_split", lambda *a, **k: pytest.fail("split step"))
    embeds, positions, lens = _prompts(3, 60, shared_prefix_len or 1, [60, 51, 44], seed=4)
    G = 5
    j = jgen.generate(setup["jcfg"], setup["jpk"], jnp.asarray(embeds), jnp.asarray(positions),
                      jnp.asarray(lens), eos_id=-1, max_new_tokens=G,
                      shared_prefix_len=shared_prefix_len)
    t = tgen.generate(TCfg(**CFG), setup["tpk"], torch.from_numpy(embeds),
                      torch.from_numpy(positions), torch.from_numpy(lens), eos_id=-1,
                      max_new_tokens=G, shared_prefix_len=shared_prefix_len)
    assert calls == list(range(G - 1))
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
    np.testing.assert_allclose(np_of(t["entropy"]), np_of(j["entropy"]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_of(t["logprob"]), np_of(j["logprob"]), rtol=0, atol=2e-2)


def test_serve_opt_out_takes_the_split_step_through_q8c_apply(setup, monkeypatch):
    """REVISIONLLM_SERVE=0 on a packed tree: decode_step_split through the
    chunked dispatch in both packages (JAX's test_serve_opt_out_env), the
    same tokens; neither row 10 nor row 9 runs in the port."""
    monkeypatch.setenv("REVISIONLLM_SERVE", "0")
    monkeypatch.setenv("REVISIONLLM_MEGAKERNEL", "1")
    jgen.set_serve(None)
    jgen.set_megakernel(None)
    for mod in (jgen, tgen):
        mod.set_kv8(True)
    monkeypatch.setattr(TDSV, "decode_step_serve", lambda *a, **k: pytest.fail("row 10 ran"))
    from revisionllm_tpu_torch.ops import decode_step as TDS
    monkeypatch.setattr(TDS, "decode_step_fused", lambda *a, **k: pytest.fail("row 9 ran"))
    embeds, positions, lens = _prompts(4, 24, 1, [24, 24, 20, 17], seed=12)
    try:
        j = jgen.generate(setup["jcfg"], setup["jpk"], jnp.asarray(embeds),
                          jnp.asarray(positions), jnp.asarray(lens), eos_id=-1, max_new_tokens=3)
    finally:
        jgen.set_serve(None)
        jgen.set_megakernel(None)
    t = tgen.generate(TCfg(**CFG), setup["tpk"], torch.from_numpy(embeds),
                      torch.from_numpy(positions), torch.from_numpy(lens), eos_id=-1,
                      max_new_tokens=3)
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    np.testing.assert_allclose(np_of(t["entropy"]), np_of(j["entropy"]), rtol=0, atol=2e-3)


def test_serve_switch(monkeypatch):
    """REVISIONLLM_SERVE unset follows the layout (None); 0/1 and set_serve
    override, as JAX's _serve_enabled."""
    monkeypatch.delenv("REVISIONLLM_SERVE", raising=False)
    assert tgen._serve_enabled() is None
    monkeypatch.setenv("REVISIONLLM_SERVE", "0")
    assert tgen._serve_enabled() is False
    monkeypatch.setenv("REVISIONLLM_SERVE", "1")
    assert tgen._serve_enabled() is True
    tgen.set_serve(False)
    assert tgen._serve_enabled() is False


def test_generate_needs_kv8_for_the_serve_step(setup, monkeypatch):
    """With KV8 off the packed tree takes decode_step_split, as in JAX."""
    tgen.set_kv8(False)
    monkeypatch.setattr(TDSV, "decode_step_serve", lambda *a, **k: pytest.fail("row 10 ran"))
    embeds, positions, lens = _prompts(2, 12, 1, [12, 9], seed=5)
    out = tgen.generate(TCfg(**CFG), setup["tpk"], torch.from_numpy(embeds),
                        torch.from_numpy(positions), torch.from_numpy(lens), eos_id=-1,
                        max_new_tokens=3)
    assert out["tokens"].shape == (2, 3)


def _quantize_and_pack(params):
    qp = JQ.quantize_llama_params(params)
    return {**qp, "layers": JDSV.pack_serving_weights(qp["layers"], block_n=64, block_f=96)}


def test_ground_windows_on_a_packed_tree_matches_jax(monkeypatch):
    """Stage-1 grounding on a packed int8 tree with KV8 in both packages
    (the tiny MHA engine of tests/test_engine_batch.py; hidden 128 in
    chunks of 64, F 256 padded to 384): identical answers and frames,
    scores within 1e-4, the port's decode through row 10's plain version."""
    monkeypatch.setattr(JDSV, "decode_step_serve", JAX_SERVE)
    for mod in (jgen, tgen):
        mod.set_kv8(True)
    calls = []
    orig = TDSV.decode_step_serve_plain
    monkeypatch.setattr(TDSV, "decode_step_serve_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rng = np.random.default_rng(0)
    movie = rng.normal(size=(400, 16)).astype(np.float32)
    qf = rng.normal(size=(3, 16)).astype(np.float32)
    qc = rng.normal(size=(16,)).astype(np.float32)
    qc /= np.linalg.norm(qc)
    jeng, teng = engines(kv_heads=4, quantize=_quantize_and_pack)
    assert "q8c" in teng.params["layers"]["q_proj"] and "q8r" in teng.params["layers"]["down_proj"]
    want = jeng.ground_windows(movie, "a red car drives by.", qf, qc)
    got = teng.ground_windows(movie, "a red car drives by.", qf, qc, movie_key="m")
    assert got["num_windows"] == 19 and calls
    assert_stage1_equal(want, got)


# ------------------------------------------------------- loader and weights


def test_loader_packs_on_the_host_under_serve(monkeypatch, setup):
    """serving_params_host: REVISIONLLM_QUANT (int8 by default on CUDA,
    none on the CPU) then, with REVISIONLLM_SERVE=1 and supports_serve, the
    host pack -- JAX's quantize_llama_params_host + pack_serving_weights_host
    element for element; without the switch the standard int8 tree."""
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    dense = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(6), jnp.float32))
    monkeypatch.delenv("REVISIONLLM_QUANT", raising=False)
    monkeypatch.delenv("REVISIONLLM_SERVE", raising=False)
    assert tloader.serving_params_host(tcfg, dense, "cpu") is dense
    std = tloader.serving_params_host(tcfg, dense, "cuda")
    assert "q8" in std["layers"]["q_proj"] and "q8" in std["lm_head"]
    monkeypatch.setenv("REVISIONLLM_SERVE", "1")
    got = tloader.serving_params_host(tcfg, dense, "cuda")
    jq = JQ.quantize_llama_params_host(dense)
    want = {**jq, "layers": JQ.pack_serving_weights_host(jq["layers"])}
    for (kp, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(kp))
    assert got["layers"]["q_proj"]["q8c"].shape == (2, 1, 256, 1024)
    gqa = TCfg(**{**CFG, "num_kv_heads": 1})
    assert "q8" in tloader.serving_params_host(gqa, dense, "cuda")["layers"]["q_proj"]


def test_params_from_numpy_carries_a_packed_tree(setup):
    """A packed tree crosses with its types: q8c and q8r int8, scales f32
    even when the floating leaves are cast to bf16."""
    tree = jax.tree.map(np.asarray, setup["jpk"])
    t = params_from_numpy(tree, CPU, torch.bfloat16)
    lay = t["layers"]
    assert lay["q_proj"]["q8c"].dtype == torch.int8 and lay["down_proj"]["q8r"].dtype == torch.int8
    assert lay["gate_proj"]["scale"].dtype == torch.float32
    assert lay["attn_norm"].dtype == torch.bfloat16 and t["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lay["up_proj"]["q8c"].numpy(), tree["layers"]["up_proj"]["q8c"])
    np.testing.assert_array_equal(lay["down_proj"]["scale"].numpy(),
                                  tree["layers"]["down_proj"]["scale"])
