"""The benchmark's own tests: benchmark/ and the checkout's root on the
path, and the marker of the tests that need an H100 (they decide inside the
test whether a card is there)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "h100: needs an NVIDIA H100; skips without CUDA")
