"""Answer parsing, copied from revisionllm_tpu/eval/metrics.py (the part the
engine needs). IoU, recall metrics and fusion wait for the stage-2 slice."""

from __future__ import annotations

import re
from typing import Optional, Tuple

SPAN_RE = re.compile(r"(\d+) (to|and) (\d+)")
SINGLE_RE = re.compile(r"(\d+)")


def parse_span(text: str) -> Optional[Tuple[int, int]]:
    """Parse 'From X to Y' / 'X and Y' style answers."""
    m = SPAN_RE.search(text)
    if not m:
        return None
    return int(m.group(1)), int(m.group(3))


def parse_single(text: str) -> Optional[int]:
    """Parse the first integer (stage-2 'In video N' answers)."""
    m = SINGLE_RE.search(text)
    return int(m.group(1)) if m else None
