"""The port stands alone: no module of ``repro_torch`` and nothing that
``chip_smoke.py`` or ``tests/test_torch_mesh_ranks.py`` (which also runs
where JAX is not installed) imports may load JAX or the JAX package."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    names = (p.relative_to(ROOT / "src").with_suffix("").parts
             for p in PKG.rglob("*.py"))
    return sorted(".".join(n[:-1] if n[-1] == "__init__" else n)
                  for n in names)


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.kernels.decode_attention", "repro_torch.core",
            "repro_torch.core.backend_cuda", "repro_torch.core.integrate",
            "repro_torch.kernels.ops",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.examples.quickstart",
            "repro_torch.models.recurrent", "repro_torch.models.moe",
            "repro_torch.models.mla", "repro_torch.data.pipeline",
            "repro_torch.optim.schedule", "repro_torch.optim.optimizer",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.train.step", "repro_torch.train.trainer",
            "repro_torch.launch.train",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.launch.mesh", "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun", "repro_torch.core.raise",
            "repro_torch.serve.compiled",
            "repro_torch.examples.serve_lm", "repro_torch.examples.train_lm",
            "repro_torch.examples.extend_pipeline",
            "repro_torch.scripts._docgen",
            *(f"repro_torch.scripts.gen_{d}_md" for d in (
                "lowering", "dse", "rewrite", "raising", "serving",
                "sharing", "fabric"))} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "repro" or m.startswith("repro.")]
    assert not bad, bad
    assert set(mods) <= set(loaded)


def test_model_modules_run_with_jax_blocked():
    """With ``jax`` and ``repro`` unimportable, the recurrent, MoE and MLA
    modules import and a reduced model of each family runs a step."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'): sys.modules[name] = None\n"
        "import torch, repro_torch\n"
        "from repro_torch.models import recurrent, moe, mla\n"
        "from repro_torch.configs.base import get_config, reduced\n"
        "from repro_torch.models.model import Model\n"
        "for arch in ('mamba2-130m', 'recurrentgemma-2b', "
        "'deepseek-v2-236b', 'kimi-k2-1t'):\n"
        "    m = Model(reduced(get_config(arch)), device='cpu')\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    c = m.cache_init(1, 8)\n"
        "    m.apply(p, torch.zeros((1, 3), dtype=torch.long), cache=c)\n"
        "    lg, _ = m.apply(p, torch.zeros((1, 1), dtype=torch.long), "
        "cache=c)\n"
        "    assert bool(torch.isfinite(lg).all()) and c['len'] == 4\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  ROOT / "tests" / "test_torch_mesh_ranks.py",
                                  ROOT / "tests" / "_torch_dist_ranks.py",
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_distribution_layer_runs_with_jax_blocked(tmp_path):
    """With ``jax`` and ``repro`` unimportable, the distribution and
    launch modules import, the launcher trains on a (1, 1) host mesh, the
    dry run lists its cells, and ``make_host_mesh`` starts no group on
    import."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'): sys.modules[name] = None\n"
        "import torch.distributed as dist\n"
        "from repro_torch.distributed import sharding, compression, "
        "fault_tolerance\n"
        "from repro_torch.launch import mesh, hlo_analysis, dryrun, train\n"
        "assert not dist.is_initialized()\n"
        "res = train.main(['--arch', 'qwen2-7b', '--reduced', '--device', "
        "'cpu', '--steps', '2', '--mesh', 'host'])\n"
        "assert res['mesh'].shape == (1, 1)\n"
        "assert dryrun.main(['--list']) == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Here, with no CUDA device, it exits nonzero and prints no result;
    in a directory holding nothing else of the repo it fails too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_training_stack_runs_with_jax_blocked(tmp_path):
    """With ``jax`` and ``repro`` unimportable, the training stack imports
    and the launcher trains a reduced model with checkpoints; whisper and
    pixtral serve a step."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'): sys.modules[name] = None\n"
        "import torch\n"
        "import repro_torch.train.trainer, repro_torch.launch.train\n"
        "import repro_torch.checkpoint.checkpointer\n"
        "from repro_torch.launch import serve, train\n"
        f"res = train.main(['--arch', 'minicpm-2b', '--reduced', '--device', "
        f"'cpu', '--steps', '3', '--checkpoint-dir', {str(tmp_path)!r}])\n"
        "assert len(res['trainer'].metrics_history) == 3\n"
        "for arch in ('whisper-base', 'pixtral-12b'):\n"
        "    serve.main(['--arch', arch, '--reduced', '--device', 'cpu', "
        "'--gen', '2'])\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert os.listdir(tmp_path) == ["step_00000003"]
