"""The yardstick's arithmetic against hand counts at small shapes."""

import pytest

from benchlib import roofline as RF

DIMS = {"hidden": 8, "ffn": 16, "layers": 2, "heads": 2, "kv_heads": 1, "head_dim": 4,
        "vocab": 32}
ACFG = {"d_model": 4, "ffn_dim": 8, "num_layers": 1, "clip_adapter_text": True}


def test_linear_params():
    # q 8x8, k 8x4, v 8x4, o 8x8, gate 8x16, up 8x16, down 16x8
    assert RF.linear_params(DIMS) == 64 + 32 + 32 + 64 + 128 + 128 + 128


def test_bound_takes_the_larger():
    assert RF.bound_s(2e12, 0, 1e12) == 2.0
    assert RF.bound_s(0, RF.HBM_BYTES_PER_S * 3, 1e12) == 3.0


def test_w8a8_bound():
    rows, T = 3, 5
    M = rows * T
    want = 0.0
    for a, b in ((8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)):
        want += max(2 * M * a * b / RF.INT8_OPS_PER_S, (M * a + a * b + 4 * M * b)
                    / RF.HBM_BYTES_PER_S)
    assert RF.w8a8_bound_s(DIMS, rows, T) == pytest.approx(2 * want)
    assert RF.w8a8_calls(DIMS) == 14


def test_k1_bound():
    rows, steps = 2, 3

    def call(a, b):   # int8 weight, f32 scales, bf16 in and out
        return max(2 * rows * a * b / RF.BF16_OPS_PER_S,
                   (a * b + 4 * b + 2 * rows * a + 2 * rows * b) / RF.HBM_BYTES_PER_S)

    layer = sum(call(a, b) for a, b in ((8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16),
                                        (16, 8)))
    want = steps * (2 * layer + call(8, 32)) + call(8, 32)
    assert RF.k1_bound_s(DIMS, rows, steps) == pytest.approx(want)
    assert RF.k1_calls(DIMS, steps) == 3 * 15 + 1


def test_adapter_ops():
    frames, t, hidden = 3, 2, 8
    d, f, n = 4, 8, 4
    t2v = 2 * (frames * d * d * 2 + t * d * d * 2 + 2 * frames * t * d + frames * d * f * 2)
    enc = 2 * (n * d * d * 4 + 2 * n * n * d + n * d * f * 2)
    assert RF.adapter_ops(ACFG, frames, t, hidden) == t2v + enc + 2 * frames * d * hidden


def test_query_least_time():
    windows, live, t, frames, G = 2, 5, 2, 3, 3
    P, L, H, hd, D, V = RF.linear_params(DIMS), 2, 2, 4, 8, 32
    int8 = 2 * live * P * L
    bf16 = RF.adapter_ops(ACFG, frames, t, D) + L * 2 * H * hd * live * (live + 1) + 2 * D * V
    for g in range(G - 1):   # decode steps: weights and lm_head, attention over live + g + 1
        bf16 += 2 * (L * P + D * V) + L * 4 * H * hd * (live + g + 1)
    want = windows * (int8 / RF.INT8_OPS_PER_S + bf16 / RF.BF16_OPS_PER_S)
    assert RF.query_least_s(DIMS, ACFG, windows, live, t, frames, G) == pytest.approx(want)
