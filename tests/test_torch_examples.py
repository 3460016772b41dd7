"""The port's examples (``python -m repro_torch.examples.*``) run reduced
on the CPU, the counterparts of ``examples/serve_lm.py``,
``examples/train_lm.py`` and ``examples/extend_pipeline.py``; each takes
``--device`` (``cuda`` by default) and imports neither jax nor the JAX
package.  ``tests/test_torch_cuda.py`` runs them on the card."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PASS_REGISTRY
from repro_torch.examples import extend_pipeline, serve_lm, train_lm  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b",
                                  "deepseek-v2-236b", "whisper-base"])
def test_serve_lm_runs_reduced(arch, capsys):
    out = serve_lm.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "6", "--gen", "4"])
    assert out.shape == (2, 10)
    assert out.dtype == np.int32
    assert "generated batch (2, 10)" in capsys.readouterr().out


def test_train_lm_runs_reduced(tmp_path, capsys):
    losses = train_lm.main(["--device", "cpu", "--steps", "6", "--layers",
                            "2", "--d-model", "64", "--seq-len", "32",
                            "--batch", "4", "--ckpt", str(tmp_path)])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert (tmp_path / "step_00000006").is_dir()
    assert "loss:" in capsys.readouterr().out


def test_train_lm_cleans_its_temporary_checkpoints(capsys):
    losses = train_lm.main(["--device", "cpu", "--steps", "2", "--layers",
                            "2", "--d-model", "64", "--seq-len", "16",
                            "--batch", "2", "--arch", "mamba2-130m"])
    assert len(losses) == 2


def test_extend_pipeline_runs():
    """In its own process: it registers an op, a pass and a pattern
    globally, which the registry listings of other tests must not see."""
    assert "unroll-innermost-all" not in PASS_REGISTRY   # import is inert
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.extend_pipeline",
         "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "validated OK" in out.stdout
    assert "fold-double-neg" in out.stdout
