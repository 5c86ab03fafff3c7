"""What `chip_smoke.py` holds the attention kernels by, checked on the CPU:
the live-pair count and row 4's bounds against a brute-force count over
the explicit causal/kv_lens mask, the planted faults on the kernels' own
64-row tiles (T not a multiple of the tile, kv_len on both sides of a tile
edge), the tile size against csrc/attention_common.cuh, the edge cases the
card runs (on the plain versions here) and the ptxas report's parser."""

import math
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from revisionllm_tpu_torch.ops import flash_attention as FA  # noqa: E402

LENS = {100: [(100,), (1, 37, 64, 65)], 512: [(512,), (63, 128, 129, 330)]}
CASES = [(T, lens, causal) for T in (100, 512) for lens in LENS[T] for causal in (True, False)]


@pytest.mark.parametrize("T,lens,causal", CASES)
def test_pairs_match_the_mask(T, lens, causal):
    mask = FA._kv_mask(len(lens), T, T, torch.tensor(lens), causal, torch.device("cpu"))
    assert chip_smoke._pairs(T, lens, causal) == int(mask.sum())


@pytest.mark.parametrize("T,lens,causal", CASES)
def test_row4_bounds_match_a_brute_force_count(T, lens, causal):
    """Each input read once (k and v to kv_len only), each output written
    once; 2 d flops a product for each live (row, column) pair of each head:
    2 products forward, 3 in dq, 4 in dk/dv."""
    B, H, d = len(lens), 4, 128
    mask = FA._kv_mask(B, T, T, torch.tensor(lens), causal, torch.device("cpu"))
    flops = 2 * d * H * int(mask.sum())
    col_live = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).sum().item()
    tensor_b, kv_b, stat_b, lens_b = B * T * H * d * 2, col_live * H * d * 2, B * H * T * 4, B * 4
    want = {
        "flash_fwd_lse": chip_smoke.bound(2 * tensor_b + 2 * kv_b + stat_b + lens_b, 2 * flops),
        "flash_dq": chip_smoke.bound(3 * tensor_b + 2 * kv_b + 2 * stat_b + lens_b, 3 * flops),
        "flash_dkv": chip_smoke.bound(4 * tensor_b + 2 * kv_b + 2 * stat_b + lens_b, 4 * flops),
    }
    got = chip_smoke.row4_bounds(B, H, T, d, list(lens), causal)
    for name in want:
        assert got[name][1] == want[name][1]
        assert got[name][0] == pytest.approx(want[name][0], rel=1e-12)


def test_training_shape_bounds_are_the_recorded_ones():
    """At T 2048, H 32: operations bound the full length, bytes the ragged
    kv_len 330 (the numbers in PERF.md's kernel table)."""
    full = chip_smoke.row4_bounds(1, 32, 2048, 128, [2048])
    ragged = chip_smoke.row4_bounds(1, 32, 2048, 128, [330])
    assert [by for _, by in full.values()] == ["operations"] * 3
    assert [by for _, by in ragged.values()] == ["bytes"] * 3
    assert full["flash_fwd_lse"][0] == pytest.approx(0.0348, abs=1e-4)
    assert ragged["flash_dkv"][0] == pytest.approx(0.0218, abs=1e-4)


def test_tile_is_the_kernels_tile():
    """The blocks `rel_errs` holds and the faults `check_flash_vjp` plants are
    the kernels' own tiles: TILE rows of a q or kv tile, 4 warps of 16."""
    src = (ROOT / "revisionllm_tpu_torch" / "csrc" / "attention_common.cuh").read_text()
    tile = int(re.search(r"constexpr int TILE = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    assert chip_smoke.TILE == tile == 64 and threads == 4 * 32 and tile == 4 * 16


@pytest.mark.parametrize("n", [65, 129, 300])
def test_planted_faults_fail_at_a_ragged_tile(n):
    """T 300 ends in a partial q tile; kv_len n just past a tile edge drops a
    one-column kv tile. The last live q tile scaled by 0.9 and the last live
    kv tile dropped each move the worst (64-row tile, head) block of o, dq,
    dk and dv by three times the card's tile limit or more (a one-column
    drop of 129 moves o's by 0.080), and `hold` rejects each."""
    T, H, d = 300, 2, 128
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((1, T, H, d), generator=gen).to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor([n])
    o, lse = FA.flash_fwd_lse_plain(q, k, v, kv_lens=lens)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq = FA.flash_dq_plain(*args, kv_lens=lens)
    dk, dv = FA.flash_dkv_plain(*args, kv_lens=lens)
    tile = chip_smoke.TILE
    short = torch.tensor([tile * ((n - 1) // tile)])
    o3, _ = FA.flash_fwd_lse_plain(q, k, v, kv_lens=short)
    dq3 = FA.flash_dq_plain(*args, kv_lens=short)
    dk3, dv3 = FA.flash_dkv_plain(*args, kv_lens=short)
    last_q, last_kv = slice(tile * ((T - 1) // tile), T), slice(short.item(), n)
    for want, dropped, rows in ((o, o3, last_q), (dq, dq3, last_q), (dk, dk3, last_kv),
                                (dv, dv3, last_kv)):
        scaled = want.clone()
        scaled[:, rows] *= 0.9
        for bad in (scaled, dropped):
            rel, worst = chip_smoke.rel_errs(bad, want)
            assert worst >= 3 * chip_smoke.VJP_TILE_TOL, (rel, worst)
        assert chip_smoke.hold("row 4", want, want, {"x0.9": scaled, "dropped": dropped}) == 0.0


def test_edge_cases_cover_the_tile_edges():
    """kv_len on both sides of each of the first two tile edges, T not a
    multiple of the tile, GQA with 32 query heads over 8 kv heads, and a
    call that is not causal."""
    assert set(chip_smoke.EDGE_LENS) >= {1, 63, 64, 65, 127, 128, 129}
    cases = chip_smoke.EDGE_CASES
    assert all(len(lens) == B and max(lens) <= T for _, B, T, _, _, _, lens in cases)
    assert any(set(lens) == set(chip_smoke.EDGE_LENS) for *_, lens in cases)
    assert any(T % chip_smoke.TILE for _, _, T, *_ in cases)
    assert any((H, KH) == (32, 8) for _, _, _, H, KH, _, _ in cases)
    assert any(not causal for *_, causal, _ in cases)


def test_edge_check_runs_on_the_plain_versions():
    """check_flash_edges at a narrow size on the CPU, where every wrapper
    takes its plain version: it holds K2's and row 4's outputs and returns
    the worst max abs error of each kernel."""
    cases = (("edges", 3, 130, 2, 2, True, (1, 64, 129)),
             ("GQA", 1, 70, 4, 2, True, (70,)),
             ("not causal", 1, 70, 2, 2, False, (65,)))
    worst = chip_smoke.check_flash_edges(torch.device("cpu"), cases)
    assert set(worst) == {"flash_attention", "flash_fwd_lse", "flash_dq", "flash_dkv"}
    assert worst["flash_fwd_lse"] == worst["flash_dq"] == worst["flash_dkv"] == 0.0
    assert 0.0 <= worst["flash_attention"] < 0.05 and math.isfinite(worst["flash_attention"])


def test_ptxas_report_is_read_per_entry_function():
    """Kernels in an anonymous namespace are mangled inside nvcc's internal
    namespace, whose name ends in digits and lowercase letters too."""
    ns = "_INTERNAL_b66e6_22_flash_attention_vjp_cu_21159bc1"
    dkv = f"_ZN{len(ns)}{ns}16flash_dkv_kernelEPK13__nv_bfloat16S2_S2_S2_PKfS4_PKiPS0_S7_iiifi"
    log = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'
ptxas info    : Function properties for {dkv}
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_iiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 1024 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16q8_matmul_kernelPKai' for 'sm_90a'
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""
    assert chip_smoke.ptxas_entries(log) == [("flash_dkv_kernel", 255, 0, 8, 12),
                                             ("flash_fwd_kernel", 168, 1024, 0, 0),
                                             ("q8_matmul_kernel", 40, 0, 0, 0)]
    assert set(chip_smoke.ATTENTION_KERNELS) == {
        "flash_fwd_kernel", "flash_fwd_lse_kernel", "flash_prefix_kernel", "flash_dq_kernel",
        "flash_dkv_kernel"}
