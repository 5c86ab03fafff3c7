"""chip_smoke.rel_errs, the measure that holds the row-4 kernels against
their plain versions on the card: it must pass equal tensors and reject a
mis-scaled or dropped tile even where the whole tensor barely moves. Runs
on the CPU on the plain versions (causal, T = 512, two heads)."""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from revisionllm_tpu_torch.ops import flash_attention as FA  # noqa: E402

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
