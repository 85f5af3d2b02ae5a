"""The benchmark's own tests: ``python -m pytest gsbench/tests`` from the
repository's root. Tests marked ``card`` need a CUDA device and skip
without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
