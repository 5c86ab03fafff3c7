"""chip_smoke.rel_errs, the measure that holds the row-4 kernels against
their plain versions on the card: it must pass equal tensors and reject a
mis-scaled or dropped tile even where the whole tensor barely moves. Runs
on the CPU on the plain versions (causal, T = 512, two heads)."""

import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from revisionllm_tpu_torch.ops import flash_attention as FA  # noqa: E402
from revisionllm_tpu_torch.utils import kernels  # noqa: E402

B, H, T, D = 1, 2, 512, 128


@pytest.fixture(scope="module")
def grads():
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((B, T, H, D), generator=gen).to(torch.bfloat16) for _ in range(4))
    o, lse = FA.flash_fwd_lse_plain(q, k, v, kv_lens=torch.tensor([T]))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, o, lse, delta


def test_equal_tensors_pass_and_zero_blocks_must_stay_zero():
    x = torch.randn(B, T, H, D)
    assert chip_smoke.rel_errs(x, x) == (0.0, 0.0)
    want = x.clone()
    want[:, 64:128] = 0
    assert chip_smoke.rel_errs(want, want) == (0.0, 0.0)
    assert chip_smoke.rel_errs(x, want)[1] == math.inf


@pytest.mark.parametrize("n", [T, 200])
def test_planted_faults_fail_the_limits(grads, n):
    """The last live tile scaled by 0.9, and the last live kv tile dropped:
    each moves its worst (64-row tile, head) block by about 10% or more,
    four times the card's tile limit and more."""
    q, k, v, do, _, _, _ = grads
    lens = torch.tensor([n])
    o, lse = FA.flash_fwd_lse_plain(q, k, v, kv_lens=lens)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq = FA.flash_dq_plain(*args, kv_lens=lens)
    dk, dv = FA.flash_dkv_plain(*args, kv_lens=lens)
    short = torch.tensor([64 * ((n - 1) // 64)])
    o3, _ = FA.flash_fwd_lse_plain(q, k, v, kv_lens=short)
    dq3 = FA.flash_dq_plain(*args, kv_lens=short)
    dk3, dv3 = FA.flash_dkv_plain(*args, kv_lens=short)
    last_q, last_kv = slice(T - 64, T), slice(short.item(), n)
    for want, dropped, tile in ((o, o3, last_q), (dq, dq3, last_q), (dk, dk3, last_kv), (dv, dv3, last_kv)):
        scaled = want.clone()
        scaled[:, tile] *= 0.9
        for bad in (scaled, dropped):
            rel, worst = chip_smoke.rel_errs(bad, want)
            assert worst >= 4 * chip_smoke.VJP_TILE_TOL, (rel, worst)


@pytest.mark.parametrize("P", [25, 70])
def test_prefix_planted_faults_fail_the_limits(P):
    """Row 6's planted faults, on its plain version: the prefix's last
    64-row tile dropped (all of a prefix of one tile) and the last causal
    tile scaled by 0.9 each move the worst (64-row tile, head) block by 10%
    or more, four times the card's tile limit and more; `hold` rejects a
    fault that passes and returns the max abs error of a good result."""
    gen = torch.Generator().manual_seed(1)
    T2 = 150
    q, k, v = (torch.randn((B, T2, H, D), generator=gen).to(torch.bfloat16) for _ in range(3))
    pk, pv = (torch.randn((1, P, H, D), generator=gen).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([T2])
    want = FA.flash_attention_prefixed_plain(q, k, v, pk, pv, kv_lens=lens)
    scaled = want.clone()
    scaled[:, 128:T2] *= 0.9
    for bad in (chip_smoke.dropped_prefix_tile(q, k, v, pk, pv, lens), scaled):
        rel, worst = chip_smoke.rel_errs(bad, want)
        assert worst >= 4 * chip_smoke.VJP_TILE_TOL, (rel, worst)
    assert chip_smoke.hold("row 6", want, want, {"x0.9": scaled}) == 0.0
    with pytest.raises(AssertionError, match="accept planted faults"):
        chip_smoke.hold("row 6", want, want, {"none": want.clone()})


def test_stage2_geometry_of_the_pipeline():
    """The kernels phase sizes stage 2 as the pipeline runs it: 143 strided
    windows, 6 + 3 + 2 passes, the 14-row bucket; the prompts' shared
    prefix is the same for both stages."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine

    assert chip_smoke.stage2_passes_1h() == 11
    assert GroundingEngine._stage2_row_bucket(11) == 14
    p1, t1, live1 = chip_smoke.prompt_geometry("mad_grounding", 250, 12)
    p2, t2, live2 = chip_smoke.prompt_geometry("retrieval", 100, 8)
    assert p1 == p2 > 1 and t1 == live1 + 12 and t2 == live2 + 8


def test_row7_and_row8_planted_faults_fail_the_limits():
    """Rows 7 and 8's planted faults, on their plain versions: the nibbles
    of each byte swapped, and the last K rank's partial dropped from the
    cluster sum (here 1 of 4 ranks); the absmax taken over the first 64
    columns only and silu left out. Each moves the worst (64-row,
    128-column) block by far more than the card's tile limit; the plain
    versions hold against themselves."""
    from revisionllm_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((64, 512), generator=gen).to(torch.bfloat16)
    q, s = Q.quantize_int4(torch.randn((512, 384), generator=gen) * 512 ** -0.5)
    want = Q.int4_matmul_plain(x, q, s)
    bad = Q.int4_matmul_plain(x, ((q & 0xF) << 4) | (q >> 4), s)
    plan = Q.q4_plan(64, 512, 384, 132, (396, 198, 92, 45))
    assert plan.splitk == 4
    dropped = chip_smoke.dropped_last_rank(x, q, s, plan, Q.Q4_BK, Q.int4_matmul_plain)
    assert chip_smoke.hold_cols("row 7", want, want, {"nibbles swapped": bad,
                                                      "last K rank dropped": dropped}) == 0.0
    with pytest.raises(AssertionError, match="accept planted faults"):
        chip_smoke.hold_cols("row 7", want, want, {"none": want.clone()})
    xq, xs = Q.quantize_activation_rows(torch.randn((128, 256), generator=gen))
    gq, gs = Q.quantize_int8(torch.randn((256, 512), generator=gen) * 256 ** -0.5)
    uq, us = Q.quantize_int8(torch.randn((256, 512), generator=gen) * 256 ** -0.5)
    hq, hs = Q.w8a8_mlp_fused_plain(xq, xs, gq, gs, uq, us)
    g = (xq.int() @ gq.int()).float() * xs * gs
    u = (xq.int() @ uq.int()).float() * xs * us
    h = (g / (1.0 + torch.exp(-g))) * u
    tile = h[:, :64].abs().amax(dim=-1, keepdim=True) / 127.0
    out = hq.float() * hs
    for bad in (h.div(tile).round().clamp(-127, 127) * tile, chip_smoke._quantize_per_row(g * u)):
        assert chip_smoke.hold_cols("row 8", out, out, {"fault": bad}) == 0.0


def test_configurations_expect_the_chunk_launches(monkeypatch):
    """One stage-1 chunk is one prefill and 11 decode steps of 32 layers:
    A launches row 8 once per prefill layer and row 9 once per step (the
    lm_head on K1 after the prefill and each step), B row 7 for the 7
    matrices of every layer and the lm_head at each step, plus the
    prefill's lm_head (M = 64 <= 256). `switched` sets a configuration's
    switches and restores the environment."""
    a, b = (chip_smoke.CONFIGS[k]["launches"] for k in ("A (fused int8)", "B (int4)"))
    assert (a["w8a8_mlp_fused"], a["decode_step_fused"], a["int8_matmul"]) == (32, 11, 12)
    assert b["int4_matmul"] == 11 * (32 * 7 + 1) + 1 and b["decode_attention"] == 11 * 32
    monkeypatch.setenv("REVISIONLLM_Q4_PALLAS", "all")
    monkeypatch.delenv("REVISIONLLM_MEGAKERNEL", raising=False)
    with chip_smoke.switched({"REVISIONLLM_MEGAKERNEL": "1"}):
        assert os.environ["REVISIONLLM_MEGAKERNEL"] == "1"
        assert "REVISIONLLM_Q4_PALLAS" not in os.environ
    assert os.environ["REVISIONLLM_Q4_PALLAS"] == "all"
    assert "REVISIONLLM_MEGAKERNEL" not in os.environ


def test_row10_planted_faults_fail_the_limits():
    """Row 10's check (serve_inputs, serve_faults, landed) on its plain
    version at a narrow width that packs into 1024-column chunks (D 1024,
    8 heads, F 2752 padded to 3072), 2 layers, B 64: the dead range read as
    prompt and the last gate chunk dropped each move the worst (64-row,
    128-column) block of the hidden state by five times the card's block
    limit and more; the plain version holds against itself, hidden and
    landed k/v."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_serve as DSV

    cfg = LlamaConfig(vocab_size=512, hidden_size=1024, intermediate_size=2752, num_layers=2,
                      num_heads=8, num_kv_heads=8, head_dim=128, dtype="bfloat16")
    params = llama.init_params(cfg, seed=0, device="cpu", quantize="int8")
    packed, slab, args = chip_smoke.serve_inputs(cfg, params, 64, 60, 48, 12,
                                                 torch.device("cpu"))
    assert packed["gate_proj"]["q8c"].shape == (2, 3, 1024, 1024)
    assert slab["kv"].shape == (2, 64, 2, 8, 128, 128) and args[1] == 11 and args[5] == 60
    want, _ = DSV.decode_step_serve_plain(packed, slab, *args, eps=cfg.rms_norm_eps)
    kv = chip_smoke.landed(slab, 60, 11)
    assert kv.shape == (2 * 64 * 2, 1024) and bool(kv.isfinite().all())
    faults = chip_smoke.serve_faults(packed, slab, args, cfg.rms_norm_eps)
    for bad in faults.values():
        rel, worst = chip_smoke.rel_errs(*(t.float().reshape(1, 64, 8, 128) for t in (bad, want)))
        assert worst >= 5 * chip_smoke.VJP_TILE_TOL, (rel, worst)
    assert chip_smoke.hold_cols("row 10", want, want, faults) == 0.0
    assert chip_smoke.hold_cols("row 10 k/v", kv, kv) == 0.0


def test_row10_bound_counts_no_padding():
    """Row 10's bound counts its matrices up to their logical extents: the
    bytes and multiply-adds of the standard int8 tree it was packed from,
    not the Fp padding (F 2752 padded to 3072 here)."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_serve as DSV

    cfg = LlamaConfig(vocab_size=512, hidden_size=1024, intermediate_size=2752, num_layers=2,
                      num_heads=8, num_kv_heads=8, head_dim=128, dtype="bfloat16")
    layers = llama.init_params(cfg, seed=0, device="cpu", quantize="int8")["layers"]
    packed = DSV.pack_serving_weights(layers)
    mats = [w for n, w in layers.items() if isinstance(w, dict)]
    assert len(mats) == 7
    nbytes, macs = chip_smoke.serve_matrix_work(cfg, packed)
    assert nbytes == sum(w["q8"].numel() + 4 * w["scale"].numel() for w in mats)
    assert macs == sum(w["q8"].numel() for w in mats)
    padded = sum(t.numel() * t.element_size() for w in packed.values() if isinstance(w, dict)
                 for t in w.values())
    assert padded - nbytes == 2 * (3 * 1024 * 320 + 2 * 320 * 4)


def test_configuration_c_expects_the_serve_launches(monkeypatch):
    """C's chunk is one prefill and 11 decode steps over the packed tree:
    row 10 once per step, K1 only for the standard lm_head (after the
    prefill and each step), K2 once per prefill layer, no K3, row 8 or row
    9. REVISIONLLM_SERVE is one of the switches `switched` sets and
    restores, and the CPU side of C's compare must reach row 10's plain
    version."""
    c = chip_smoke.CONFIGS["C (packed int8 serving)"]
    assert c["env"] == {"REVISIONLLM_SERVE": "1"} and c["pack"] and c["step"] == "serve"
    assert c["launches"] == {"decode_step_serve": 11, "int8_matmul": 12, "flash_attention": 32,
                             "decode_attention": 0, "decode_step_fused": 0,
                             "w8a8_mlp_fused": 0, "int4_matmul": 0}
    assert c["kernels"] == ("decode_step_serve",)
    assert chip_smoke.REPLACES["decode_step_serve"] == "revisionllm_tpu/ops/decode_serve.py:227"
    assert chip_smoke.SOURCES["decode_step_serve"] == "decode_serve"
    monkeypatch.setenv("REVISIONLLM_SERVE", "0")
    with chip_smoke.switched(c["env"]):
        assert os.environ["REVISIONLLM_SERVE"] == "1"
    assert os.environ["REVISIONLLM_SERVE"] == "0"
    with chip_smoke.switched({}):
        assert "REVISIONLLM_SERVE" not in os.environ


def test_kernel_groups_name_rows_9_and_10():
    """The breakdown's groups find rows 9 and 10 by their __global__ names
    (one step_kernel template over each row's attention phase), so neither
    falls into the PyTorch elementwise group."""
    names = ["void (anonymous namespace)::step_kernel<(anonymous namespace)::GenCacheAttn>"
             "((anonymous namespace)::Args)",
             "void (anonymous namespace)::step_kernel<(anonymous namespace)::SlabAttn>"
             "((anonymous namespace)::Args)"]
    events = [type("Event", (), {"name": n, "device_time_total": 2000.0})() for n in names]
    groups, other = chip_smoke.group_kernels(events)
    assert groups["row 9 decode_step_fused"] == [2.0, 1]
    assert groups["row 10 decode_step_serve"] == [2.0, 1]
    assert other == {}


def test_device_launches_count_each_kernel_under_its_counter():
    """A serving run's launches come from the profiler's kernel names
    (chip_smoke.DeviceLaunches): each hand-written kernel counts under its
    wrapper's counter and no other (K3 at groups 1 and 16 both as
    decode_attention, row 8 by its GEMM alone, K1 and the W8A8 GEMM apart
    from the grouped expert kernels that share their bodies), and PyTorch's
    kernels under none."""
    ns = "(anonymous namespace)::"
    names = [
        f"{ns}q8_matmul_kernel(CUtensorMap_st, CUtensorMap_st, float const*, "
        "__nv_bfloat16*, int, int, int)",
        f"void {ns}decode_attn_kernel<signed char>({ns}KArgs)",
        f"void {ns}decode_attn_kernel_g16<signed char>({ns}GArgs)",
        f"{ns}flash_fwd_kernel({ns}FArgs)", f"{ns}flash_fwd_lse_kernel({ns}FArgs)",
        f"{ns}flash_prefix_kernel({ns}FArgs)", f"{ns}q4_matmul_kernel(CUtensorMap_st)",
        f"{ns}mlp_transpose_kernel(signed char const*)", f"{ns}mlp_gemm_kernel(CUtensorMap_st)",
        f"{ns}mlp_quant_kernel(float const*)",
        f"void {ns}step_kernel<{ns}GenCacheAttn>({ns}Args)",
        f"void {ns}step_kernel<{ns}SlabAttn>({ns}Args)",
        f"void {ns}quantize_rows_kernel<16>(__nv_bfloat16 const*)",
        f"{ns}kmajor_transpose_kernel(signed char const*)",
        f"void {ns}s8gemm_kernel<2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
        "float const*, float const*, float*, int, int, int, long long)",
        f"void {ns}moe_w8a8_kernel<2>(CUtensorMap_st)", f"{ns}moe_w8a16_kernel(CUtensorMap_st)",
        "void at::native::vectorized_elementwise_kernel<8, at::native::BinaryFunctor<c10::"
        "BFloat16, c10::BFloat16, c10::BFloat16, at::native::binary_internal::MulFunctor",
    ]
    got = chip_smoke.device_launches(names)
    assert got == {k: 2 if k == "decode_attention" else 1 for k in chip_smoke.DEVICE_KERNELS}
    assert set(chip_smoke.DEVICE_KERNELS) <= set(kernels.COUNTERS)
    assert set(chip_smoke.SERVING + chip_smoke.W8A8 + chip_smoke.PIPELINE) \
        <= set(chip_smoke.DEVICE_KERNELS)
    assert all(not n for n in chip_smoke.device_launches(names[-1:]).values())


def test_row7_checks_cover_the_edges_and_spills():
    """Row 7's edge cases reach M 1, both sides of the 16-row tile, several
    64-row m tiles and two launches, K 4224 and N 4112 and 32000; the
    breakdown finds row 7 by its one kernel; ptxas's spill check covers it,
    with its dynamic shared memory from its library."""
    from revisionllm_tpu_torch.ops import quant as Q

    ms = {m for m, _, _ in chip_smoke.Q4_EDGES}
    assert {1, 16, 17, 65, 200, 256} <= ms and max(ms) > Q.KERNEL_MAX_M
    assert {k for _, k, _ in chip_smoke.Q4_EDGES} >= {4224}
    assert {n for _, _, n in chip_smoke.Q4_EDGES} >= {4112, 32000}
    assert chip_smoke.NO_SPILL_KERNELS["q4_matmul_kernel"] == (
        "int4_matmul", "q4_matmul_smem_bytes", ())
    assert set(chip_smoke.ATTENTION_KERNELS) < set(chip_smoke.NO_SPILL_KERNELS)
    name = "void (anonymous namespace)::q4_matmul_kernel(__nv_bfloat16 const*, " \
           "unsigned char const*, float const*, __nv_bfloat16*, int, int, int)"
    event = type("Event", (), {"name": name, "device_time_total": 3000.0})()
    groups, other = chip_smoke.group_kernels([event])
    assert groups["row 7 int4_matmul (q4_matmul, one launch)"] == [3.0, 1] and other == {}


def test_k1_planted_faults_fail_the_limits():
    """K1's planted faults, on its plain version: neighbouring k rows 2i and
    2i + 1 of q8 swapped (the k pair of each bf16x2 A register reversed), and
    the last K rank's partial dropped from the cluster sum (here 1 of 4
    ranks). Each moves the worst (64-row, 128-column) block by far more than
    the card's tile limit; the plain version holds against itself."""
    from revisionllm_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(4)
    x = torch.randn((64, 512), generator=gen).to(torch.bfloat16)
    q, s = Q.quantize_int8(torch.randn((512, 384), generator=gen) * 512 ** -0.5)
    want = Q.int8_matmul_plain(x, q, s)
    plan = Q.q8_plan(64, 512, 384, 132, (396, 198, 92, 45))
    assert plan.splitk == 4
    faults = {"k rows 2i, 2i + 1 swapped": chip_smoke.k1_rows_swapped(x, q, s),
              "last K rank dropped": chip_smoke.dropped_last_rank(x, q, s, plan, Q.Q8_BK,
                                                                  Q.int8_matmul_plain)}
    assert chip_smoke.hold_cols("K1", want, want, faults) == 0.0
    with pytest.raises(AssertionError, match="accept planted faults"):
        chip_smoke.hold_cols("K1", want, want, {"none": want.clone()})


def test_k1_checks_cover_the_edges_and_spills():
    """K1's edge cases reach M 1, the stage-2 bucket 14, both sides of 16,
    25, 64, 65, 200 and 256; K 4104 (a tail tile of 8 rows) and 4224; N 1024
    (a q8c_apply chunk), 4112 and 32000. ptxas's spill check covers K1 with
    its dynamic shared memory from its library, and the breakdown finds K1
    by its one kernel."""
    ms = {m for m, _, _ in chip_smoke.K1_EDGES}
    assert {1, 14, 16, 17, 25, 64, 65, 200, 256} <= ms
    assert max(ms) <= 256
    assert {k for _, k, _ in chip_smoke.K1_EDGES} >= {4104, 4224}
    assert {n for _, _, n in chip_smoke.K1_EDGES} >= {1024, 4112, 32000}
    assert chip_smoke.NO_SPILL_KERNELS["q8_matmul_kernel"] == (
        "int8_matmul", "q8_matmul_smem_bytes", ())
    name = "void (anonymous namespace)::q8_matmul_kernel(CUtensorMap, CUtensorMap, " \
           "float const*, __nv_bfloat16*, int, int, int)"
    event = type("Event", (), {"name": name, "device_time_total": 4000.0})()
    groups, other = chip_smoke.group_kernels([event])
    assert groups["K1 int8_matmul (q8_matmul, one launch)"] == [4.0, 1] and other == {}


def test_row8_checks_cover_the_edges_and_spills():
    """Row 8's edge cases reach M 1, 64 and 130, K 80 and 4112, N 160 and
    11024 (all multiples of 16, as the kernel takes); ptxas's spill check
    covers its three kernels, with the GEMM's dynamic shared memory from its
    library; the breakdown finds row 8 by each of its three kernels."""
    ms = {m for m, _, _ in chip_smoke.MLP_EDGES}
    ks = {k for _, k, _ in chip_smoke.MLP_EDGES}
    ns = {n for _, _, n in chip_smoke.MLP_EDGES}
    assert {1, 64, 130} <= ms and {80, 4112} <= ks and {160, 11024} <= ns
    assert all(k % 16 == 0 for k in ks) and all(n % 16 == 0 for n in ns)
    assert chip_smoke.ROW8_KERNELS == ("mlp_transpose_kernel", "mlp_gemm_kernel",
                                       "mlp_quant_kernel")
    for i, name in enumerate(("mlp_gemm_kernel", "mlp_transpose_kernel", "mlp_quant_kernel")):
        assert chip_smoke.NO_SPILL_KERNELS[name] == ("w8a8_mlp_fused", "w8a8_mlp_smem_bytes", (i,))
    names = ["void (anonymous namespace)::mlp_transpose_kernel(signed char const*, signed char "
             "const*, signed char*, unsigned int*, int, int, int)",
             "void (anonymous namespace)::mlp_gemm_kernel(CUtensorMap, CUtensorMap, CUtensorMap, "
             "float const*, float const*, float const*, float*, unsigned int*, int, int, int)",
             "void (anonymous namespace)::mlp_quant_kernel(float const*, unsigned int const*, "
             "signed char*, float*, int)"]
    events = [type("Event", (), {"name": n, "device_time_total": 1000.0})() for n in names]
    groups, other = chip_smoke.group_kernels(events)
    assert groups["row 8 w8a8_mlp_fused (transpose + GEMM + requantize)"] == [3.0, 3]
    assert other == {}


def test_row8_measure_rejects_a_moved_code_or_scale():
    """hold_mlp passes the plain version against itself and fails an hq off
    by one in 1% of places (under 99.9% equal), an hq off by two in one
    place, and an hs off by 1e-5 relative."""
    from revisionllm_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(8)
    xq, xs = Q.quantize_activation_rows(torch.randn((128, 256), generator=gen))
    gq, gs = Q.quantize_int8(torch.randn((256, 512), generator=gen) * 256 ** -0.5)
    uq, us = Q.quantize_int8(torch.randn((256, 512), generator=gen) * 256 ** -0.5)
    hq, hs = Q.w8a8_mlp_fused_plain(xq, xs, gq, gs, uq, us)
    assert chip_smoke.hold_mlp("row 8", (hq, hs), (hq, hs)) == 0.0
    moved = hq.clone()
    moved.view(-1)[::100] = (moved.view(-1)[::100].int().clamp(-126, 126) + 1).to(torch.int8)
    two = hq.clone()
    two[0, 0] = (two[0, 0].int() + 2).clamp(-127, 127).to(torch.int8) if two[0, 0] < 126 \
        else (two[0, 0].int() - 2).to(torch.int8)
    for bad in ((moved, hs), (two, hs), (hq, hs * (1 + 1e-5))):
        with pytest.raises(AssertionError, match="differs from its plain version"):
            chip_smoke.hold_mlp("row 8", bad, (hq, hs))


def test_two_call_check_rejects_one_flipped_bit():
    """same_bits, the check that two calls of rows 9 and 10 give the same
    hidden state and new k/v: equal tensors pass; one element one bf16 ulp
    off, or a missing tensor, fails."""
    gen = torch.Generator().manual_seed(5)
    hidden = torch.randn((64, 256), generator=gen).to(torch.bfloat16)
    kv = torch.randn((2, 64, 256), generator=gen)
    chip_smoke.same_bits("row", (hidden, kv), (hidden.clone(), kv.clone()))
    off = hidden.clone()
    off.view(torch.int16)[3, 7] += 1
    with pytest.raises(AssertionError, match="two calls differ"):
        chip_smoke.same_bits("row", (hidden, kv), (off, kv))
    with pytest.raises(AssertionError, match="two calls differ"):
        chip_smoke.same_bits("row", (hidden, kv), (hidden,))


@pytest.mark.parametrize("S,low", [(318, 280), (4084, 4020), (chip_smoke.chat_geometry())])
def test_k3_planted_faults_fail_the_limits(S, low):
    """K3's check (k3_inputs, k3_faults, hold_k3) on its plain version at
    the card's shapes cut to 2 rows and 4 kv heads: the second half of
    every prompt masked and one V tile (prompt positions 64..127) dropped
    each move the worst (row, head) vector by five times the block limit
    and more, at the stage-1 prompt, at 4096 positions and at the chat's
    prompt cache; the plain version holds against itself."""
    from revisionllm_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator().manual_seed(5)
    args = (*chip_smoke.k3_inputs(gen, 2, 4, S, 12, 1, low, torch.device("cpu")), 11)
    want = DA.decode_attention_plain(*args)
    faults = chip_smoke.k3_faults(args, DA.decode_attention_plain)
    assert set(faults) == {"the second half of every prompt masked", "one V tile dropped"}
    for bad in faults.values():
        rel, worst = chip_smoke.rel_errs(chip_smoke.k3_view(bad), chip_smoke.k3_view(want))
        assert worst >= 5 * chip_smoke.VJP_TILE_TOL and rel > chip_smoke.VJP_TOL, (rel, worst)
    assert chip_smoke.hold_k3("K3", want, want, faults) == 0.0


def test_checkpoint_writer_round_trips(tmp_path):
    """chip_smoke's .safetensors writer: the port's reader and
    safetensors.safe_open read back what it wrote."""
    import numpy as np

    from revisionllm_tpu_torch.models.convert import read_safetensors

    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(5, 3)).astype(np.float16),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "q": rng.integers(-127, 128, size=(2, 4)).astype(np.int8)}
    path = str(tmp_path / "x.safetensors")
    n = chip_smoke.write_safetensors(path, arrays)
    assert n == os.path.getsize(path)
    got = read_safetensors(path)
    safe_open = pytest.importorskip("safetensors").safe_open
    with safe_open(path, framework="np") as f:
        theirs = {k: f.get_tensor(k) for k in f.keys()}
    for k, a in arrays.items():
        for other in (got, theirs):
            assert other[k].dtype == a.dtype and np.array_equal(other[k], a)


def test_checkpoint_tree_check_catches_the_planted_fault(tmp_path, monkeypatch):
    """The checkpoint phase's checks at a tiny width on the CPU: the loaded
    int8 tree equals the reference built in memory leaf for leaf, and the
    first-step logits agree; with layer 0's q_proj written untransposed
    the tree check names it and the logits check reads above its limit."""
    import numpy as np

    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.eval import loader, stage1

    monkeypatch.setenv("REVISIONLLM_QUANT", "int8")
    monkeypatch.delenv("REVISIONLLM_SERVE", raising=False)
    torch.set_num_threads(2)
    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=32)
    cpu = torch.device("cpu")
    # std 0.1 at width 128 gives attention scores of about the spread the
    # phase's std 0.02 gives at 4096, so the fault moves the logits as there
    tree = chip_smoke.ckpt_tree(cfg, cpu, std=0.1)
    movie = np.random.default_rng(1).normal(size=(300, 16)).astype(np.float32)
    qf = np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32)
    flags = ["--data_path", "d.json", "--feat_folder", "f", "--log_path", "l",
             "--stage2", str(tmp_path / "stage"), "--adapter_d_model", "16",
             "--adapter_heads", "4", "--adapter_ffn", "32", "--device", "cpu"]
    flags += chip_smoke.S1_FLAGS
    acfg = loader.adapter_cfg_from_args(stage1.parse_args(flags)).with_hidden(128)
    lora, lora_cfg, vision = chip_smoke.write_stage_dir(str(tmp_path / "stage"), cfg, acfg)
    ref_params, ref_vision = chip_smoke.as_loaded(
        chip_smoke.ckpt_reference(tree, lora, lora_cfg), vision, False)
    engines = {}
    for name, fault in (("good", False), ("fault", True)):
        chip_smoke.write_checkpoint(
            str(tmp_path / name), cfg, tree, fault=fault,
            shard2=str(tmp_path / "good" / "model-00002-of-00002.safetensors") if fault else None)
        args = stage1.parse_args(flags + ["--model_base", str(tmp_path / name)])
        engines[name] = loader.build_engine_from_args(args, tokenizer=chip_smoke.fake_tokenizer())
    assert chip_smoke.tree_mismatches(engines["good"].params, ref_params) == []
    assert chip_smoke.tree_mismatches(engines["good"].vision_params, ref_vision) == []
    assert "layers/q_proj/q8" in chip_smoke.tree_mismatches(engines["fault"].params, ref_params)
    want = chip_smoke.first_step_logits(engines["good"], movie, qf)
    assert want.shape == (1, 512) and want.isfinite().all()
    assert chip_smoke.rel_l2(chip_smoke.first_step_logits(engines["good"], movie, qf), want) == 0
    assert chip_smoke.rel_l2(chip_smoke.first_step_logits(engines["fault"], movie, qf), want) > \
        chip_smoke.CKPT_LOGITS_TOL


@pytest.mark.parametrize("streamed,batch,want", [
    ([5, 6, 7], [5, 6, 7, 2, 2], None),        # equal up to the batch row's eos
    ([5, 6, 7], [5, 6, 7], None),              # no eos within the budget
    ([5, 9, 7], [5, 6, 7, 2], 1),              # a different token
    ([5, 6], [5, 6, 7, 2], 2),                 # the stream stopped early
    ([5, 6, 7, 8], [5, 6, 2, 2], 2),           # the stream ran past the batch's eos
    ([], [2, 2], None),                        # eos first: nothing streamed
])
def test_first_divergence(streamed, batch, want):
    assert chip_smoke.first_divergence(streamed, batch, 2) == want


def test_top2_and_logit_trace():
    """top2 reports the two largest logits with their ids; LogitTrace
    records each step's logits of a greedy generate (the prefill's, then
    every decode step's but the last, which generate skips) and restores
    the functions it wraps."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import generation, llama

    assert chip_smoke.top2(torch.tensor([0.5, 3.0, -1.0, 2.0])) == ((3.0, 1), (2.0, 3))
    cfg = LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=1,
                      num_heads=1, num_kv_heads=1, head_dim=128, dtype="float32")
    params = llama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    embeds = torch.randn(1, 6, 128, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(6)[None]
    orig = (llama.prefill_kv, llama.decode_step_split)
    with chip_smoke.LogitTrace() as tr:
        out = generation.generate(cfg, params, embeds, pos, torch.tensor([6]), eos_id=-1,
                                  max_new_tokens=4)
    assert (llama.prefill_kv, llama.decode_step_split) == orig
    assert len(tr.steps) == 4
    assert [int(s[0].argmax()) for s in tr.steps] == out["tokens"][0].tolist()


def test_t2v_corpus_reads_through_msrvtt(tmp_path):
    """The 1k-A-shaped corpus the surfaces phase writes, at 12 clips and 3
    queries: msrvtt.load_queries gives one query per clip, split 0 of 4
    holds the first 3 and their features load, and t2v_stack samples every
    track to num_frames rows as msrvtt.run does."""
    from revisionllm_tpu_torch.data.feature_store import QueryFeatureStore, open_feature_store
    from revisionllm_tpu_torch.eval import msrvtt

    flags, lengths = chip_smoke.write_t2v_corpus(str(tmp_path), 12, 3, d=16, frames=(30, 90))
    args = msrvtt.parse_args(flags + chip_smoke.T2V_FLAGS + ["--log_path", str(tmp_path / "log"),
                                                            "--total_split", "4"])
    queries = msrvtt.load_queries(args.data_path)
    assert [q["video"] for q in queries] == [f"video{i}" for i in range(12)]
    assert len(set(q["sentence"] for q in queries)) == 12
    assert all(30 <= n <= 90 for n in lengths) and len(set(lengths.tolist())) > 1
    store = open_feature_store(args.feat_folder)
    assert [store.get(f"video{i}").shape for i in range(12)] == [(n, 16) for n in lengths]
    qs = QueryFeatureStore(args.q_feat_dir)
    for i in range(3):
        tokens, cls = qs.get(f"q{i}")
        assert tokens.shape == (25, 16) and cls.shape == (16,)
    stack = chip_smoke.t2v_stack(args, 12)
    assert stack.shape == (12, 100, 16)
    assert np.array_equal(stack[0, -1], store.get("video0")[-1])


def test_chat_geometry_is_the_streams_plan(monkeypatch):
    """chat_geometry gives the prompt cache positions and the live length
    that inference_stream plans for SURF_PROMPT over a SURF_FRAMES window
    (the shapes check_decode_attention holds K3 at for the chat)."""
    from revisionllm_tpu_torch import inference
    from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
    from revisionllm_tpu_torch.models import generation, llama, revisionllm

    seen = {}

    def spy(cfg, params, embeds, positions, prompt_lens, **kw):
        seen.update(rows=embeds.shape[1], live=prompt_lens.tolist(), G=kw["max_new_tokens"])
        yield from ()

    monkeypatch.setattr(generation, "generate_stream", spy)
    cfg = LlamaConfig(vocab_size=512, hidden_size=32, intermediate_size=64, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=16, dtype="float32")
    acfg = AdapterConfig(kind="mlp", hidden_size=32)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    vision = revisionllm.init_vision_params(acfg, seed=1, d_in=16, device="cpu")
    window = np.zeros((1, chip_smoke.SURF_FRAMES, 16), np.float32)
    assert list(inference.inference_stream(cfg, acfg, params, vision, chip_smoke.fake_tokenizer(),
                                           window, chip_smoke.SURF_PROMPT,
                                           max_new_tokens=chip_smoke.SURF_TOKENS)) == []
    rows, live = chip_smoke.chat_geometry()
    assert seen == dict(rows=rows, live=[live], G=chip_smoke.SURF_TOKENS)


def test_hold_steps_holds_every_step_and_token():
    """hold_steps passes two decodes whose every step's logits agree within
    5% of the largest and whose greedy tokens are equal; it fails a decode
    step (not only the first) moved past the limit, a greedy token that
    differs beyond a bf16 tie while the logits hold, and a missing step;
    a token flipped at a tie (one bf16 step apart) stops it there."""
    gen = torch.Generator().manual_seed(3)
    cpu = [torch.randn((2, 50), generator=gen) * 4 for _ in range(4)]
    for s in cpu:
        s[:, 7] = s.max() + 1.0   # a clear greedy token in every row
    near = [s + 0.01 for s in cpu]
    diff, tol, tie = chip_smoke.hold_steps("decode", near, cpu)
    # equal differences: the worst step is the one with the smallest logits
    assert diff == pytest.approx(0.01, abs=1e-6) and tie is None
    assert tol == pytest.approx(5e-2 * min(s.abs().max().item() for s in cpu))
    moved = [s.clone() for s in cpu]
    moved[2][1, 3] += 0.3 * moved[2].abs().max()
    with pytest.raises(AssertionError, match="step 2: logits"):
        chip_smoke.hold_steps("decode", moved, cpu)
    # token 9 above token 7 on the card by 0.2, below it on the CPU by 0.2:
    # within the logits' limit, beyond two bf16 steps (0.125 at 8-16)
    far_cpu, far_card = [s.clone() for s in cpu], [s.clone() for s in cpu]
    far_cpu[2][0, 9] = far_cpu[2][0, 7] - 0.2
    far_card[2][0, 9] = far_cpu[2][0, 7] + 0.2
    with pytest.raises(AssertionError, match=r"step 2: greedy tokens differ beyond a tie in "
                                             r"row 0.*card \(\(.*, 9\), \(.*, 7\)\)"):
        chip_smoke.hold_steps("decode", far_card, far_cpu)
    # token 9 one bf16 step below token 7 on the CPU, one above on the card
    tie_cpu, tie_card = [s.clone() for s in cpu], [s.clone() for s in cpu]
    step = chip_smoke.bf16_spacing(cpu[1][0, 7].item())
    tie_cpu[1][0, 9] = cpu[1][0, 7] - step
    tie_card[1][0, 9] = cpu[1][0, 7] + step
    tie_card[2] += 100.0    # after the tie: not held
    diff, tol, tie = chip_smoke.hold_steps("decode", tie_card, tie_cpu)
    assert tie[0] == 1 and tie[1][0][1] == 9 and tie[2][0][1] == 7
    with pytest.raises(AssertionError, match="3 decode steps on the card, 4"):
        chip_smoke.hold_steps("decode", cpu[:3], cpu)


def test_hold_sharded_exact_and_past_ties():
    """hold_sharded: without tensor parallelism it passes only equal logits,
    answers and entropies (one ulp anywhere fails); with it, every step is
    held on the rows not yet tied: a row that ties leaves the hold, a later
    step that moves another row past the limit still fails, and an untied
    window's entropy beyond 5% fails while a tied one's is not held."""
    gen = torch.Generator().manual_seed(4)
    ref_steps = [torch.randn((3, 50), generator=gen) * 4 for _ in range(4)]
    for s in ref_steps:
        s[:, 7] = s.max() + 1.0
    ref = {"answers": ["a", "b", "c"], "entropy": [1.0, 2.0, 3.0]}
    res = {"answers": list(ref["answers"]), "scores_entropy": list(ref["entropy"])}
    same = [s.clone() for s in ref_steps]
    assert chip_smoke.hold_sharded("m", same, ref_steps, res, ref, exact=True)["diff"] == 0.0
    ulp = [s.clone() for s in ref_steps]
    ulp[3][2, 0] = torch.nextafter(ulp[3][2, 0], torch.tensor(1e9))
    with pytest.raises(AssertionError, match="step 3: logits differ"):
        chip_smoke.hold_sharded("m", ulp, ref_steps, res, ref, exact=True)
    with pytest.raises(AssertionError, match="answers or entropies"):
        chip_smoke.hold_sharded("m", same, ref_steps, {**res, "scores_entropy": [1.0, 2.0, 3.5]},
                                ref, exact=True)
    # row 0 ties at step 1 (token 9 one bf16 step above 7 here, below on one
    # rank), then decodes other tokens: its later logits are not held
    tie, want = [s.clone() for s in ref_steps], [s.clone() for s in ref_steps]
    step = chip_smoke.bf16_spacing(want[1][0, 7].item())
    want[1][0, 9] = want[1][0, 7] - step
    tie[1][0, 9] = want[1][0, 7] + step
    tie[2][0] += 100.0
    other = {**res, "answers": ["x", "b", "c"], "scores_entropy": [9.0, 2.0, 3.0]}
    held = chip_smoke.hold_sharded("m", tie, want, other, ref, exact=False)
    assert held["ties"] == [(1, 0)] and held["entropy_diff"] == 0.0
    assert not held["answers_equal"]
    late = [s.clone() for s in tie]
    late[3][1, 3] += 0.3 * late[3].abs().max()
    with pytest.raises(AssertionError, match="step 3: logits"):
        chip_smoke.hold_sharded("m", late, want, other, ref, exact=False)
    with pytest.raises(AssertionError, match="window 2 \\(no tie\\) entropy"):
        chip_smoke.hold_sharded("m", tie, want, {**other, "scores_entropy": [9.0, 2.0, 3.2]},
                                ref, exact=False)
    # this rank's rows start at window 1: its row 0 is window 1
    with pytest.raises(AssertionError, match="window 2 \\(no tie\\) answers"):
        chip_smoke.hold_sharded("m", [s[:2] for s in tie], [s[:2] for s in want],
                                {**other, "answers": ["x", "y", "z"]}, ref, exact=False,
                                offset=1)


@pytest.mark.parametrize("x,want", [(3.67, 2 ** -6), (4.0, 2 ** -5), (12.0, 2 ** -4),
                                    (-0.6, 2 ** -8), (0.0, 0.0)])
def test_bf16_spacing(x, want):
    """bf16_spacing is the gap from a bf16 value to the next one up."""
    assert chip_smoke.bf16_spacing(x) == want
    if x:
        b = torch.tensor([abs(x)], dtype=torch.bfloat16)
        up = (b.view(torch.int16) + 1).view(torch.bfloat16)
        assert (up.float() - b.float()).item() == want


# ------------------------------------------------------------------ phase 16


def test_clip_shapes_are_hf_clip_vit_l14():
    """clip_shapes(VIT_L14) is the state dict of transformers' CLIPModel
    built from clip_config(VIT_L14) (on the meta device: no memory), key
    for key and shape for shape: 428 M parameters."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(**{k: v for k, v in chip_smoke.clip_config(
        chip_smoke.VIT_L14).items() if k not in ("architectures", "model_type", "torch_dtype")})
    with torch.device("meta"):
        model = transformers.CLIPModel(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items() if "position_ids" not in k}
    got = {name: tuple(shape) for name, shape, _ in chip_smoke.clip_shapes(chip_smoke.VIT_L14)}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert 427e6 < n < 429e6
    assert got["vision_model.embeddings.position_embedding.weight"] == (257, 1024)
    assert got["text_model.embeddings.token_embedding.weight"] == (49408, 768)


TINY_CLIP = {"vision": {"layers": 2, "width": 128, "heads": 2, "mlp": 256, "patch": 14,
                        "image": 28},
             "text": {"layers": 2, "width": 64, "heads": 1, "mlp": 128, "vocab": 99,
                      "positions": 16},
             "projection": 32}


def test_clip_writer_round_trips(tmp_path):
    """write_clip's directory read by the port's reader and convert_hf_clip
    gives the drawn state; transformers' CLIPModel loads the same directory
    and its features equal models/clip.py's within 1e-5."""
    transformers = pytest.importorskip("transformers")
    from revisionllm_tpu_torch.models import clip
    from revisionllm_tpu_torch.models.convert import load_hf_llama_state
    from revisionllm_tpu_torch.models.weights import params_from_numpy

    path = str(tmp_path / "clip")
    chip_smoke.write_clip(path, TINY_CLIP, torch.device("cpu"), seed=3)
    state = load_hf_llama_state(path)
    want = chip_smoke.clip_state(TINY_CLIP, torch.device("cpu"), seed=3)
    assert set(state) == set(want)
    assert all(np.array_equal(state[k], want[k]) for k in want)
    params = params_from_numpy(clip.convert_hf_clip(state), "cpu")
    hf = transformers.CLIPModel.from_pretrained(path).eval()
    pixels = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32))
    ids = torch.from_numpy(chip_smoke.clip_tokenize(["a dog", "the old door opens"], length=16,
                                                    vocab=99))
    with torch.no_grad():
        img = hf.get_image_features(pixel_values=pixels)
        txt = hf.get_text_features(input_ids=ids)
    img, txt = (getattr(x, "pooler_output", x) for x in (img, txt))
    got_img = clip.encode_image(params, pixels)
    got_txt = clip.encode_text(params, ids)["pooler_output"]
    for got, ref in ((got_img, img), (got_txt, txt)):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_clip_tokenize():
    ids = chip_smoke.clip_tokenize(list(chip_smoke.CLIP_QUERIES.values()))
    vocab = chip_smoke.VIT_L14["text"]["vocab"]
    assert ids.shape == (3, 77) and (ids[:, 0] == vocab - 2).all()
    for row, text in zip(ids, chip_smoke.CLIP_QUERIES.values()):
        n = len(text.split())
        assert row.argmax() == n + 1 and row[n + 1] == vocab - 1
        assert (row[1 : n + 1] < vocab - 2).all() and (row[1 : n + 1] > 0).all()
        assert not row[n + 2 :].any()


def test_video_writer_geometry(tmp_path):
    """video_frames at VIDEO's shape scaled down, through write_y4m: the
    header, the frame count, the file size, and a crop at 224 pixels."""
    from revisionllm_tpu_torch.data.feature_extraction import decode_frames
    from revisionllm_tpu_torch.data.video_reader import read_y4m, write_y4m

    v = chip_smoke.VIDEO
    assert int(v["seconds"] * v["fps"]) == 1500 and (v["width"], v["height"]) == (320, 240)
    frames = chip_smoke.video_frames(3, 5, v["width"], v["height"])
    assert frames.shape == (15, 240, 320, 3) and frames.dtype == np.uint8
    assert not np.array_equal(frames[0], frames[5])   # the blocks drift a block a second
    assert np.array_equal(frames[0], frames[4])
    path = str(tmp_path / "v.y4m")
    write_y4m(path, frames, fps=5)
    header = open(path, "rb").readline()
    assert header == b"YUV4MPEG2 W320 H240 F5:1 Ip A1:1 C444\n"
    assert os.path.getsize(path) == len(header) + 15 * (6 + 320 * 240 * 3)
    got, fps = read_y4m(path)
    assert fps == 5.0 and got.shape == frames.shape
    assert decode_frames(path, chip_smoke.VIDEO_FPS).shape == (15, 224, 224, 3)


def test_batch_windows():
    hier = {"images": torch.zeros(1, 100, 250, 8), "text_ids": torch.zeros(1, 256)}
    stream = {"images": torch.zeros(1, 250, 8), "c2_images": torch.zeros(1, 250, 8)}
    assert chip_smoke.batch_windows(hier) == (100, 25000)
    assert chip_smoke.batch_windows(stream) == (2, 500)


def test_phase16_configurations():
    """The flags give TRAIN_STAGE2.json's geometry (100 windows of 250
    frames, the preset's adapter: d 768, 8 heads, 2 layers, FFN 2048, T2V;
    sequence 256, batch 1, int8 base) and the stream preset (mlp, 250
    frames, mean_pool, single); the compares' cuts (stage2_long_33: 33
    windows and the rest the same; the stream's gt_multi at 512), and
    gt_multi's memory rows are the CLI's."""
    from revisionllm_tpu_torch.train import train_cli

    data = ["--data_path", "d.json", "--feat_folder", "f"]
    args = train_cli.parse_args(chip_smoke.train16_argv(chip_smoke.STAGE2_FLAGS, data, "o", 4))
    llama, adapter, dcfg, tcfg = train_cli.build_configs(args)
    assert args.quant_base and args.max_steps == 4 and llama.num_layers == 32
    assert (dcfg.hierarchy, dcfg.hierarchy_num_videos, dcfg.num_frames) == (True, 100, 250)
    assert (adapter.d_model, adapter.num_heads, adapter.num_layers, adapter.ffn_dim,
            adapter.clip_adapter_text, adapter.feature_mode) == (768, 8, 2, 2048, True, "cls")
    assert (tcfg.model_max_length, tcfg.per_device_batch_size) == (256, 1)
    args = train_cli.parse_args(chip_smoke.train16_argv(
        chip_smoke.STAGE2_COMPARE_FLAGS, data, "o", 1))
    llama33, adapter33, dcfg33, tcfg33 = train_cli.build_configs(args)
    assert args.quant_base and (llama33, adapter33, tcfg33) == (llama, adapter, tcfg)
    assert (dcfg33.hierarchy, dcfg33.hierarchy_num_videos, dcfg33.num_frames) == (True, 33, 250)
    args = train_cli.parse_args(chip_smoke.train16_argv(chip_smoke.STREAM_FLAGS, data, "o", 4))
    _, adapter, dcfg, tcfg = train_cli.build_configs(args)
    assert adapter.kind == "mlp" and dcfg.stream and dcfg.num_frames == 250
    assert tcfg.memory_type == "mean_pool" and tcfg.stream_loss == "single"
    args = train_cli.parse_args(chip_smoke.train16_argv(
        chip_smoke.STREAM_COMPARE_FLAGS, data, "o", 1))
    _, adapter, dcfg, tcfg = train_cli.build_configs(args)
    assert adapter.kind == "mlp" and dcfg.stream and dcfg.num_frames == 250
    assert (tcfg.memory_type, tcfg.model_max_length) == ("gt_multi", 512)
    assert chip_smoke.STREAM_MEMORY_ROWS == train_cli.PREFIX_LEN + 5


def test_shared_base():
    """Inside shared_base, a second init_params with the same arguments
    returns the first tree; other arguments draw anew; outside, every call
    draws anew."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama

    cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=8)
    init = llama.init_params
    with chip_smoke.shared_base():
        a = llama.init_params(cfg, seed=0, device="cpu")
        assert llama.init_params(cfg, seed=0, device="cpu") is a
        assert llama.init_params(cfg, seed=1, device="cpu") is not a
    assert llama.init_params is init
    assert llama.init_params(cfg, seed=0, device="cpu") is not a


def test_recording_tokenizer():
    """recording_tokenizer decodes as fake_tokenizer does and keeps each id
    list it decoded, in order, as ints."""
    tok, plain = chip_smoke.recording_tokenizer(), chip_smoke.fake_tokenizer()
    first, second = [5, 17, 42], np.array([1, 2, 300, 7])
    assert tok.decode(first) == plain.decode(first)
    assert tok.decode(second, skip_special_tokens=True) == plain.decode(second)
    assert tok.decoded == [[5, 17, 42], [1, 2, 300, 7]]
    assert all(type(i) is int for ids in tok.decoded for i in ids)
