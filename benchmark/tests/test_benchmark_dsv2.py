"""The DeepSeek-V2 cell (dsv2-lite.ground-1h) on the CPU at toy sizes: its
small run end to end at trace 0 and 1 with its own result line (at trace 1
the CPU reads only its host-clock metric, mfu.serve.moe); the plain
reference agrees with the program and the int4 control does not; planted
faults underneath the timed path, the expert path's among them (moe_gap),
come out not correct; and the new yardstick's arithmetic against hand
counts."""

import json

import pytest
import torch

import readings as RD
import run as R
from benchlib import roofline as RF
from benchlib import roofline_moe as RM
from benchlib.cell import benchmark_spec
from small import small_cell

WORKLOAD = "dsv2-lite.ground-1h"
LIMITS = {"malformed_queries": 0, "logit_gap": 1.0, "entropy_gap": 1.0, "moe_gap": 1.0}
NEW_METRICS = {"mfu.serve.moe", "moe_w8a8_roofline", "moe_k1_roofline", "moe_ms_per_query",
               "mla_ms_per_query"}
# the generic readers the cell also takes: they read the whole trace
GENERIC_METRICS = {"device_idle_pct.serve", "launches_per_query"}


@pytest.fixture(autouse=True)
def environment():
    R.prepare_environment()


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_end_to_end(trace):
    cell = small_cell(WORKLOAD, LIMITS)
    out = json.loads(json.dumps(R.run_cell(WORKLOAD, 2**31 + 12345, 0.5, bool(trace),
                                           device="cpu", cell=cell)))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    if trace:
        # the CPU has no device trace or spans: only the host-clock metric
        assert set(out["metrics"]) == {"mfu.serve.moe"}
        assert 0 < out["metrics"]["mfu.serve.moe"]["value"] < 100
    else:
        assert set(out["metrics"]) == {m["name"] for m in benchmark_spec()["end_to_end"]}
    assert set(out["checks"]) == set(LIMITS)


def test_the_cells_metrics_are_declared():
    spec = benchmark_spec()
    mine = {m["name"] for m in spec["per_layer"] if WORKLOAD in m.get("workloads", [WORKLOAD])}
    assert mine == NEW_METRICS | GENERIC_METRICS
    cell = next(w for w in spec["workloads"] if w["name"] == WORKLOAD)
    assert cell["chips"] == 1 and cell["traffic"] == "ground-1h-dsv2"


def test_reference_agrees_and_the_control_fails():
    cell = small_cell(WORKLOAD)
    limits = cell["limits"]
    for row in RD.readings(cell, [21, 22], "int8", 3, "cpu"):
        assert all(row[k] <= limits[k] for k in limits), row
    for row in RD.readings(cell, [21, 22], "int4", 3, "cpu"):
        assert any(row[k] > limits[k] for k in limits), row


def _fault(monkeypatch, fault):
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import moe as MOE

    if fault == "shared experts dropped":
        monkeypatch.setattr(MOE, "swiglu", lambda h, *a: torch.zeros_like(h))
    elif fault == "routed experts dropped":
        real = MOE.routed_experts
        monkeypatch.setattr(MOE, "routed_experts",
                            lambda h, *a: (torch.zeros_like(h), real(h, *a)[1]))
    elif fault == "an expert's offset shifted by one":
        real = MOE.dispatch

        def dispatch(idx, n_experts, pad=1):
            # no host read: the decode steps are captured as CUDA graphs on the card
            d = real(idx, n_experts, pad)
            one = torch.ones(1, dtype=d.starts.dtype, device=d.starts.device)
            return d._replace(starts=d.starts.index_add(0, d.counts.argmax().view(1), one))

        monkeypatch.setattr(MOE, "dispatch", dispatch)
    else:
        monkeypatch.setattr(llama, "mla_softmax_scale", lambda cfg: cfg.qk_head_dim ** -0.5)


FAULTS = ["shared experts dropped", "m squared left out", "routed experts dropped",
          "an expert's offset shifted by one"]


# the routed experts move the logits too little to be seen there at toy
# sizes; moe_gap sees them
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_model_is_not_correct(fault, monkeypatch):
    cell = small_cell(WORKLOAD)
    _fault(monkeypatch, fault)
    out = R.run_cell(WORKLOAD, 31, 0.3, False, device="cpu", cell=cell)
    assert out["correct"] is False, out["checks"]


DIMS = {"hidden": 8, "ffn": 16, "layers": 3, "heads": 2, "vocab": 32, "kv_lora": 4,
        "qk_nope": 2, "qk_rope": 2, "v_head": 3, "experts": 4, "shared": 1, "top_k": 2,
        "moe_ffn": 5, "dense_layers": 1}
ACFG = {"d_model": 4, "ffn_dim": 8, "num_layers": 1, "clip_adapter_text": True}


def test_expert_bounds():
    windows, live, steps = 3, 7, 2
    Rr = 2 * windows * live
    want = 0.0
    for K, N in ((8, 10), (5, 8)):   # gate|up 8 x 2 x 5, down 5 x 8
        want += max(2 * Rr * K * N / RF.INT8_OPS_PER_S,
                    (Rr * K + 4 * K * N + 16 * N + 4 * Rr + 2 * Rr * N) / RF.HBM_BYTES_PER_S)
    assert RM.moe_w8a8_bound_s(DIMS, windows, live) == pytest.approx(2 * want)
    Rd = 2 * windows
    want = 0.0
    for hit in (4, 1):   # all four experts hit, then one
        for K, N in ((8, 10), (5, 8)):
            want += max(2 * Rd * K * N / RF.BF16_OPS_PER_S,
                        (hit * K * N + 4 * hit * N + 2 * Rd * K + 2 * Rd * N)
                        / RF.HBM_BYTES_PER_S)
    counts = [torch.tensor([1, 2, 2, 1]), torch.tensor([0, 6, 0, 0])]
    assert RM.moe_k1_bound_s(DIMS, windows, counts) == pytest.approx(want)
    assert RM.moe_w8a8_calls(DIMS) == 4 and RM.moe_k1_calls(DIMS, steps) == 8


def test_query_least_time():
    windows, live, t, frames, G = 2, 5, 2, 3, 3
    # q 8 x 2 x 4, kv_a 8 x 6, o 6 x 8; kv_b 4 x 2 x 5, or absorbed 2 x (2 x 4 + 4 x 3)
    prefill_attn, decode_attn = 64 + 48 + 48 + 40, 64 + 48 + 48 + 40
    mlp = 3 * 8 * 16 + 2 * 3 * 3 * 8 * 5          # dense, and (2 routed + 1 shared) x 2
    int8 = 2 * live * (3 * prefill_attn + mlp)
    f32 = live * 2 * 2 * 8 * 4
    bf16 = RF.adapter_ops(ACFG, frames, t, 8) + 3 * 2 * 2 * 7 * live * (live + 1) / 2 + 2 * 8 * 32
    for g in range(G - 1):
        f32 += 2 * 2 * 8 * 4
        bf16 += 2 * (3 * decode_attn + mlp + 8 * 32) + 3 * 2 * 2 * (4 + 2 + 4) * (live + g + 1)
    want = windows * (int8 / RF.INT8_OPS_PER_S + bf16 / RF.BF16_OPS_PER_S + f32 / RM.F32_OPS_PER_S)
    assert RM.query_least_s(DIMS, ACFG, windows, live, t, frames, G) == pytest.approx(want)


@pytest.mark.h100
@pytest.mark.parametrize("fault", FAULTS[2:])
def test_a_broken_expert_path_is_not_correct_on_the_card(fault, monkeypatch):
    """At the cell's own size on the card: one seed of the program with the
    routed experts' part dropped, or one expert's offset shifted by a row,
    reads beyond the limits that one seed of the program keeps within."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100")
    from benchlib.cell import cell as find_cell

    cell = find_cell(WORKLOAD)
    limits = cell["limits"]
    _fault(monkeypatch, fault)
    (row,) = RD.readings(cell, [2**31 + 97], "int8", 4, "cuda")
    assert any(row[k] > limits[k] for k in limits), row
