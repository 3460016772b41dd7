"""The port's generated docs (``docs/torch/*.md``) against live output and
against the JAX package's ``docs/*.md``.

Each generator (``python -m repro_torch.scripts.gen_*_md``, and ``reproc
--list-passes --markdown`` for PASSES.md) must reproduce its committed
file byte for byte: the docs-check of ``make docs-check``, for the port.
Every fenced block (IR, reports, transcripts, modelled numbers) equals
the block in the same place of the reference's doc once the package name
is read as the reference's, except the blocks listed in ``DIFFERENT``
with their reasons; the raisability table names each jax primitive as its
ATen op.  No generator may import jax or the JAX package.
"""

import contextlib
import importlib
import io
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import reproc

ROOT = pathlib.Path(__file__).resolve().parents[1]
GENERATORS = {"LOWERING": "gen_lowering_md", "DSE": "gen_dse_md",
              "REWRITE": "gen_rewrite_md", "RAISING": "gen_raising_md",
              "SERVING": "gen_serving_md", "SHARING": "gen_sharing_md",
              "FABRIC": "gen_fabric_md"}
FENCE = re.compile(r"^```[^\n]*\n(.*?)^```", re.S | re.M)

# (doc, block index) -> why the port's block differs from the reference's
DIFFERENT = {
    ("RAISING", 6): "the API: raise_fx traces PyTorch where raise_jaxpr "
                    "traces jax; backend 'torch' where the reference has "
                    "'jax'",
    ("SERVING", 1): "the port has no serve_bench, so the line is tagged "
                    "[serve]; the metrics JSON is the reference's",
    ("SERVING", 2): "cuda= for pallas=, the torch backend validated, plain "
                    "torch fallbacks, the ATen op named",
    ("SERVING", 3): "the reference's benchmark commands; the port has no "
                    "benchmark yet, so its launcher and chip_smoke.py",
    ("SERVING", 4): "the snapshot is no BENCH_serve payload in the port",
}


def _generate(doc: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if doc == "PASSES":
            assert reproc.main(["--list-passes", "--markdown"]) == 0
        else:
            mod = importlib.import_module(
                f"repro_torch.scripts.{GENERATORS[doc]}")
            assert mod.main() == 0
    return buf.getvalue()


@pytest.mark.filterwarnings("ignore:invalid value encountered")
@pytest.mark.parametrize("doc", ["PASSES", *GENERATORS])
def test_generator_reproduces_its_doc(doc, tmp_path, monkeypatch):
    monkeypatch.setenv("STAGECC_DSE_CACHE", str(tmp_path / "dse"))
    want = (ROOT / "docs" / "torch" / f"{doc}.md").read_text()
    assert _generate(doc) == want, (
        f"docs/torch/{doc}.md is out of date; regenerate it with "
        f"PYTHONPATH=src python -m repro_torch.scripts."
        f"{GENERATORS.get(doc, 'reproc')} > docs/torch/{doc}.md")


def _blocks(path):
    return FENCE.findall(path.read_text())


@pytest.mark.parametrize("doc", ["PASSES", *GENERATORS])
def test_fenced_blocks_match_the_reference(doc):
    want = _blocks(ROOT / "docs" / f"{doc}.md")
    got = [b.replace("repro_torch", "repro")
           for b in _blocks(ROOT / "docs" / "torch" / f"{doc}.md")]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if (doc, i) in DIFFERENT:
            assert g != w, f"{doc} block {i} now equals the reference's"
            continue
        assert g == w, f"{doc} block {i} differs from docs/{doc}.md"


def test_the_serving_transcripts_differ_only_as_stated():
    want = _blocks(ROOT / "docs" / "SERVING.md")
    got = _blocks(ROOT / "docs" / "torch" / "SERVING.md")
    assert got[1].replace("[serve] ", "[serve_bench] ", 1) == want[1]
    plan = (want[2].replace("pallas=", "cuda=")
            .replace("validated jax backend", "validated torch backend")
            .replace("FALLBACK plain jit", "FALLBACK plain torch")
            .replace("'slice'", "'aten.slice.Tensor'")
            .replace("primitive: slice", "primitive: aten.slice.Tensor"))
    assert got[2] == plan


def _table(path):
    rows = [ln for ln in path.read_text().splitlines()
            if ln.startswith("| ") and ln.count("|") == 4]
    return rows[rows.index(next(r for r in rows if "config" in r)) + 1:]


def test_raisability_table_names_the_aten_ops():
    want = _table(ROOT / "docs" / "RAISING.md")
    got = _table(ROOT / "docs" / "torch" / "RAISING.md")
    assert got == [r.replace("(slice)", "(aten.slice.Tensor)")
                   .replace("(top_k)", "(aten.topk.default)") for r in want]
    assert len(got) == 10


def test_generators_import_no_jax():
    mods = [f"repro_torch.scripts.{m}" for m in GENERATORS.values()]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'): sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
