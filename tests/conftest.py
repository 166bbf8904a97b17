"""Shared test config.  NOTE: no XLA_FLAGS here — smoke tests must see ONE
device; multi-device tests spawn subprocesses with their own flags."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    from hypothesis import settings
except ImportError:  # property tests skip themselves via importorskip
    settings = None

if settings is not None:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is absent")
