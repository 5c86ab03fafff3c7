"""Shared CLI helpers (a copy of revisionllm_tpu/utils/cli.py)."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    """argparse bool that actually parses 'False'.

    The reference's `type=bool` pattern (eval_nlq_negative.py:47-65) treats
    ANY non-empty string — including '--normalize False' — as True. Flag
    names and 'True'/'False' value style are kept; the footgun is not.
    """
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")
