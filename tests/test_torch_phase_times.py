"""scripts/torch_phase_times.py, the same-card comparison of where
chip_smoke.py's whole run spends its time: its tags, its sums by tag, and
a whole comparison over two stand-in checkouts on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_phase_times as PT  # noqa: E402


@pytest.mark.parametrize("line,want", [
    ("# slice: warm-up ground_windows 1.426 s", "slice"),
    ("# decode_attention B=64 KH=32 S=318: max_abs_err 1e-3", "decode_attention"),
    ("# config A (fused int8): switches", "config"),
    ("NVIDIA H100 80GB HBM3, 700.00 W", "other"),
    ('{"ok": true}', "other"),
    ("# ", "other"),
])
def test_tag(line, want):
    assert PT.tag(line) == want


def test_by_tag_gives_the_time_before_a_line_to_its_tag():
    stamped = [(1.0, "NVIDIA"), (3.0, "# build: 2 s"), (4.5, "# slice: a"), (5.0, "# slice: b"),
               (9.0, "# compare (x): c"), (9.5, "# slice: d")]
    got = PT.by_tag(stamped)
    assert list(got) == ["other", "build", "slice", "compare"]
    assert got == pytest.approx({"other": 1.0, "build": 2.0, "slice": 2.5, "compare": 4.0})
    assert sum(got.values()) == pytest.approx(9.5)


def test_main_runs_each_root_in_order(tmp_path, capsys):
    """Two stand-in checkouts, each with a chip_smoke.py that prints phase
    lines: every run's stamped log is written, the table has a column a
    run, and a failing run makes the exit code non-zero."""
    roots = []
    for name, rc in (("a", 0), ("b", 3)):
        root = tmp_path / name
        root.mkdir()
        (root / "chip_smoke.py").write_text(
            "import sys\nprint('# build: ok')\nprint('# slice: " + name + "')\n"
            "print('{\"ok\": true}')\nsys.exit(" + str(rc) + ")\n")
        roots.append(str(root))
    out = tmp_path / "out"
    assert PT.main(["--out", str(out), roots[0], roots[1], roots[0]]) == 1
    text = capsys.readouterr().out
    assert "run 0 (" in text and "exit 3" in text
    assert [line.split()[0] for line in text.splitlines() if line[:5] in ("tag  ", "build",
                                                                          "slice", "other")] \
        == ["tag", "build", "slice", "other"]
    logs = sorted(p.name for p in out.iterdir())
    assert logs == ["run0.err", "run0.log", "run1.err", "run1.log", "run2.err", "run2.log"]
    assert (out / "run1.log").read_text().splitlines()[1].split(None, 1)[1] == "# slice: b"
