"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the repository.  Tests that need an NVIDIA GPU carry the ``chip``
marker and skip, deciding inside the test, where torch sees none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips where torch sees none")
