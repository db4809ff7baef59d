"""Tests of the benchmark's own code, on the CPU at tiny sizes; tests
that need a CUDA card carry the ``card`` marker and skip here."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
