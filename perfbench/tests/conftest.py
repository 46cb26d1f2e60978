"""The benchmark's own CPU tests (``python -m pytest perfbench/tests``).

``card``: a test that needs the CUDA card; it decides inside the test
whether one is there, and skips on a machine without it."""

import sys
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")
