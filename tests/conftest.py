import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:
    # The dev container has no hypothesis and cannot install packages;
    # fall back to a deterministic stub (see _hypothesis_stub.py).
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_stub import install
    install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where none is present")
