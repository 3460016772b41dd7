"""Where torch is not installed, the suite still collects: each port test
module skips itself (``pytest.importorskip("torch")`` before its first
torch, ``repro_torch`` or ``_torch_*`` import), and the JAX package's
tests run as before."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

COLLECT = (
    "import sys, pytest\n"
    "sys.modules['torch'] = None\n"
    "sys.exit(pytest.main(['--collect-only', '-q', '-rs', '-p', "
    "'no:cacheprovider', 'tests/']))\n")


def test_collection_with_torch_blocked_skips_every_port_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", COLLECT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-4000:]
    assert "error" not in text.lower().split("short test summary")[-1], \
        text[-4000:]
    skipped = set(re.findall(
        r"SKIPPED \[1\] tests/(test_torch_\w+\.py):\d+: could not import "
        r"'torch'", text))
    port = {p.name for p in (ROOT / "tests").glob("test_torch_*.py")}
    assert skipped == port, sorted(port ^ skipped)
    # the JAX package's tests are collected
    assert re.search(r"^tests/test_kernels\.py::", out.stdout, re.M)
    assert not re.search(r"^tests/test_torch_", out.stdout, re.M)
