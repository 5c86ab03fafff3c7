"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes that the stage-1 query's work needs, counted from the model's sizes
and the query's shapes. A frozen copy of the counting behind PERF.md's
kernel table (chip_smoke.py:309-313 `bound`, its K1 and W8A8 rows), so a
change to the program cannot move it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its 700 W limit."""

from __future__ import annotations

from benchlib.weights import matrix_shapes

BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time of a call: the larger of its operations over the peak
    rate and its bytes over the memory bandwidth."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def linear_params(dims) -> int:
    """Weights of one layer's seven matrices."""
    return sum(a * b for _, a, b in matrix_shapes(dims))


def w8a8_bound_s(dims, rows: int, T: int) -> float:
    """The prefill's W8A8 GEMMs (torch._int_mm) of one chunk [rows, T]: in
    every layer one call a matrix, M = rows * T; each reads its int8
    activation and weight once and writes its int32 product once."""
    M = rows * T
    one = sum(bound_s(2 * M * a * b, M * a + a * b + 4 * M * b, INT8_OPS_PER_S)
              for _, a, b in matrix_shapes(dims))
    return dims["layers"] * one


def w8a8_calls(dims) -> int:
    return dims["layers"] * len(matrix_shapes(dims))


def k1_bound_s(dims, rows: int, steps: int) -> float:
    """K1's weight-only int8 products of one chunk: in each of `steps`
    decode steps every layer's seven matrices and the lm_head at M = rows,
    plus the prefill's lm_head at the last positions. Each reads its int8
    weight, f32 scales and bf16 activation once and writes bf16 once."""
    def call(a, b):
        return bound_s(2 * rows * a * b, a * b + 4 * b + 2 * rows * a + 2 * rows * b,
                       BF16_OPS_PER_S)

    D, V = dims["hidden"], dims["vocab"]
    step = dims["layers"] * sum(call(a, b) for _, a, b in matrix_shapes(dims)) + call(D, V)
    return steps * step + call(D, V)


def k1_calls(dims, steps: int) -> int:
    return steps * (dims["layers"] * len(matrix_shapes(dims)) + 1) + 1


def adapter_ops(acfg, frames: int, text_tokens: int, hidden: int) -> float:
    """Multiply-add operations (x2) of the T2V ClipEncoder on one window:
    each T2V layer's cross-attention (frames query the text tokens) and its
    FFN on the frames, each encoder layer's self-attention and FFN over
    CLS + frames, the projector on the frames."""
    d, f, L = acfg["d_model"], acfg["ffn_dim"], acfg["num_layers"]
    t, n = text_tokens, frames + 1
    t2v = 2 * (frames * d * d * 2 + t * d * d * 2 + 2 * frames * t * d + frames * d * f * 2)
    enc = 2 * (n * d * d * 4 + 2 * n * n * d + n * d * f * 2)
    ops = L * enc + 2 * frames * d * hidden
    if acfg["clip_adapter_text"]:
        ops += L * t2v
    return ops


def query_least_s(dims, acfg, windows: int, live: int, text_tokens: int, frames: int,
                  new_tokens: int) -> float:
    """The least time the chip could do one stage-1 query's model arithmetic
    in, at the precision the configuration runs it: for each of `windows`
    live windows the adapter (bf16), the prefill of its `live` positions
    (int8 GEMMs, bf16 causal attention), the lm_head at its last position
    and new_tokens - 1 decode steps (bf16: weight-only int8 widens to bf16;
    attention over the prompt and the steps so far). Padding rows and
    positions count as no work."""
    D, V, H, hd, L = dims["hidden"], dims["vocab"], dims["heads"], dims["head_dim"], dims["layers"]
    P = linear_params(dims)
    int8 = 2 * live * P * L
    bf16 = adapter_ops(acfg, frames, text_tokens, D)
    bf16 += L * 4 * H * hd * live * (live + 1) / 2          # causal QK^T and PV
    bf16 += 2 * D * V                                          # lm_head, last position
    for g in range(new_tokens - 1):
        bf16 += 2 * (L * P + D * V) + L * 4 * H * hd * (live + g + 1)
    return windows * (int8 / INT8_OPS_PER_S + bf16 / BF16_OPS_PER_S)
