"""The benchmark's tests: ``portbench/`` on the import path, and the
``card`` marker for the tests that need a CUDA card (they decide inside
the test, and skip here with the reason)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for p in (PORTBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
