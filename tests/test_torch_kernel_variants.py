"""The kernel probes' source edits (scripts/kernel_variants.py and the
CUTS of scripts/torch_int4_probe.py, torch_int8_kernel.py,
torch_fused_mlp_kernel.py, torch_w8a8_gemm.py, torch_decode_step_phases.py
and torch_decode_attention_kernel.py) against the CUDA
sources as they are: every cut still finds its lines, overrides replace
exactly one constexpr, and a stale edit or an unknown constant stops the
probe. No GPU or nvcc is needed."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import kernel_variants as kv  # noqa: E402
import torch_decode_attention_kernel as k3_probe  # noqa: E402
import torch_decode_step_phases as phases  # noqa: E402
import torch_fused_mlp_kernel as mlp_probe  # noqa: E402
import torch_int4_probe as int4_probe  # noqa: E402
import torch_int8_kernel as int8_probe  # noqa: E402
import torch_w8a8_gemm as w8a8_probe  # noqa: E402

CSRC = ROOT / "revisionllm_tpu_torch" / "csrc"


PROBES = {"int8": int8_probe.CUTS, "int4": int4_probe.CUTS, "mlp": mlp_probe.CUTS,
          "w8a8": w8a8_probe.CUTS}


def _variant(probe, spec):
    """The source of one probe's variant, prepared as the probe prepares it."""
    if probe == "int4":
        return int4_probe.variant_source(spec)
    src = int8_probe.SRC.read_text() if probe == "int8" else \
        (ROOT / (w8a8_probe.SRC if probe == "w8a8" else mlp_probe.SRC)).read_text()
    return kv.variant_source(src, spec, PROBES[probe], probe)


@pytest.mark.parametrize("probe,cut", [(p, c) for p, cuts in PROBES.items() for c in cuts],
                         ids=lambda v: v)
def test_every_cut_still_applies(probe, cut):
    assert _variant(probe, cut) != _variant(probe, "")
    assert kv.has_cut(f"STAGES=3,{cut}", PROBES[probe])


@pytest.mark.parametrize("name,value", [("STAGES", "3"), ("GROUP_M", "1")])
def test_override_replaces_one_constexpr(name, value):
    src = (CSRC / "w8a8_mlp_fused.cu").read_text()
    got = kv.variant_source(src, f"{name}={value}", mlp_probe.CUTS, "w8a8_mlp_fused.cu")
    assert f"constexpr int {name} = {value};" in got
    assert got.count("constexpr int") == src.count("constexpr int")
    assert not kv.has_cut(f"{name}={value}", mlp_probe.CUTS)


def test_unknown_constant_stale_edit_and_unknown_edit_stop():
    src = "constexpr int STAGES = 4;\nint a = 1;\n"
    with pytest.raises(SystemExit, match="no constexpr int MINB"):
        kv.variant_source(src, "MINB=2", {}, "x.cu")
    with pytest.raises(SystemExit, match="not in x.cu any more"):
        kv.variant_source(src, "cut", {"cut": [("int b = 2;", "")]}, "x.cu")
    with pytest.raises(SystemExit, match="unknown edit nope"):
        kv.variant_source(src, "nope", {"cut": []}, "x.cu")
    assert kv.variant_source(src, "STAGES=2,cut", {"cut": [("int a = 1;", "int a = 0;")]},
                             "x.cu") == "constexpr int STAGES = 2;\nint a = 0;\n"


@pytest.mark.parametrize("row", sorted(phases.ROWS))
@pytest.mark.parametrize("spec", ["", "CWG=2,STAGES=3", "AWARPS=12"] + sorted(phases.CUTS))
def test_phase_script_instruments_both_rows(row, spec):
    """Every cut of the phase script still finds its lines in
    decode_common.cuh, overrides replace one constexpr, and the
    instrumented header stamps the kernel's start and each of its 8 grid
    barriers a layer; the row's source gains read_stamps."""
    header, src = phases.instrumented(row, spec)
    plain, _ = phases.instrumented(row, "")
    assert (header != plain) == bool(spec)
    body = header.split("step_kernel(const __grid_constant__ Args a) {", 1)[1]
    assert body.count("grid.sync();") == 8
    assert header.count(phases.STAMP) == 9
    assert 'extern "C" int read_stamps' in src
    assert '#include "decode_common.cuh"' in src
    for item in filter(lambda i: "=" in i, spec.split(",")):
        assert f"constexpr int {item.replace('=', ' = ')};" in header


@pytest.mark.parametrize("spec", sorted(phases.ATTN_CUTS) + ["atime", "anocopy,anoscore,anovalue"])
def test_attention_core_cuts_apply(spec):
    """Every attention cut, and the `atime` instrument, still finds its
    lines in csrc/decode_attn_common.cuh; a cut leaves decode_common.cuh as
    it is, the instrument adds its clocks to both headers and read_attn_t to
    the row's source."""
    core, plain = phases.attn_core(spec), phases.attn_core("")
    assert core != plain
    for row in sorted(phases.ROWS):
        header, src = phases.instrumented(row, spec)
        assert (header != phases.instrumented(row, "")[0]) == ("atime" in spec)
        assert ('extern "C" int read_attn_t' in src) == ("atime" in spec)
    if "atime" in spec:
        assert core.count("ATIME(") == 5 and phases.instrumented("9", spec)[0].count("ATIME(") == 4


@pytest.mark.parametrize("spec", ["", "KBLOCKS=3,KSTAGES=4", "KTILE=16384,KWARPS=8", "noscale",
                                  "anocopy,atime", "anowiden", "noscale,anovalue"])
def test_k3_probe_variants(spec, tmp_path, monkeypatch):
    """The K3 probe's variants: overrides replace one constexpr of
    decode_attention.cu, its own cut `noscale` finds its lines, the core's
    cuts and instrument land in the variant's copy of the header, and
    `atime` appends read_attn_t."""
    monkeypatch.setattr(k3_probe, "OUT", tmp_path)
    (src, got_spec, inc), = k3_probe.sources({"v": spec}).values()
    assert got_spec == spec
    base = k3_probe.SRC.read_text()
    assert (src != base) == any(i in spec for i in ("=", "noscale", "atime"))
    for item in filter(lambda i: "=" in i, spec.split(",")):
        assert f"constexpr int {item.replace('=', ' = ')};" in src
    if "noscale" in spec:
        assert "dattn::tma_load_3d" not in src
    header = (inc / "decode_attn_common.cuh").read_text()
    assert (header != phases.attn_core("")) == any(c in spec for c in ("anocopy", "anowiden",
                                                                      "anovalue", "atime"))
    assert ('extern "C" int read_attn_t' in src) == ("atime" in spec)
