"""Tests of the benchmark harness.  CPU tests run here at a tiny size with
the kernels' plain paths; tests marked ``cuda`` need the card and skip
without one (decided inside the test)."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# The native engine's device arena, before anything loads the engine.
os.environ.setdefault("TPUMEM_FAKE_HBM_MB", "64")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
