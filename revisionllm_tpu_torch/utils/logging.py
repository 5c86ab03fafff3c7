"""Structured metric logging: an append-only JSONL metric stream, a copy of
MetricLogger from revisionllm_tpu/utils/logging.py."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, stream=sys.stderr):
        self.path = path
        self.stream = stream
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **metrics) -> None:
        metrics.setdefault("time", time.time())
        line = json.dumps(metrics)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.stream is not None:
            print(line, file=self.stream)
