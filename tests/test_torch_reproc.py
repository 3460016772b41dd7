"""``python -m repro_torch.core.reproc`` against the JAX package's driver.

The same argument vectors through both ``reproc.main``: equal exit codes,
standard output and standard error, and equal bytes in the files they
write (``--pareto-csv``, ``--vcd``, ``-o``), once the package's own name
is read as the reference's.  By design the port lists its own backend
passes (``emit-torch``, ``emit-cuda`` for ``emit-jax``, ``emit-pallas``);
``--raise`` is held to the reference's docs/RAISING.md transcripts and to
its driver with its raiser patched for the installed jax
(``tests/_torch_raise_ref.py``); ``--timing`` prints wall times and is
checked for its shape only.
"""

import io
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import passes as ref_passes
from repro.core import reproc as ref_reproc
from repro_torch.core import passes, reproc

RENAME = {"emit-jax": "emit-torch", "emit-pallas": "emit-cuda"}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("STAGECC_DSE_CACHE", str(tmp_path / "dse-cache"))


def _run(mod, argv, capsys):
    """(exit code, stdout, stderr) of one ``main(argv)``."""
    out = io.StringIO()
    try:
        # with -o, main opens the file itself
        code = mod.main(list(argv), out=None if "-o" in argv else out)
    except SystemExit as e:
        code = e.code
    cap = capsys.readouterr()
    return code, out.getvalue() + cap.out, cap.err


def _foreign():
    """Passes that other tests register in either package's registry (a
    test process shares them): not the packages' own."""
    return sorted({name for mod, reg in ((passes, passes.PASS_REGISTRY),
                                         (ref_passes,
                                          ref_passes.PASS_REGISTRY))
                   for name, pd in reg.items()
                   if not pd.fn.__module__.startswith(mod.__name__)})


def _common(text: str) -> str:
    """Per-pass wall times blanked; the backend passes (whose names sort
    differently) and the foreign passes left out of a listed registry."""
    text = re.sub(r"'emit-(torch|cuda)', ", "", text)
    for name in _foreign():
        text = text.replace(f"'{name}', ", "")
        text = "\n".join(ln for ln in text.split("\n")
                         if not ln.startswith((f"{name} ", f"| `{name}`")))
    return re.sub(r"\d+\.\d{3} ms", "T ms", text)


def _same(text: str) -> str:
    """Port output read as the reference's: its package name."""
    return _common(text.replace("repro_torch.core", "repro.core").replace(
        "repro_torch/core", "repro/core"))


def _ref(text: str) -> str:
    for old, new in RENAME.items():
        text = text.replace(old, new)
    return _common(text)


ARGVS = [
    [],
    ["--emit=tensor"], ["--emit=loop"], ["--emit=hw"], ["--emit=verilog"],
    ["--gemm", "4x4x4", "--emit=hw"],
    ["--gemm", "8x8x8", "--epilogue", "none", "--emit=verilog"],
    ["--gemm", "4x4x4", "--pipeline", "lower", "--simulate"],
    ["--gemm", "4x4x4", "--pipeline", "lower", "--simulate", "--trace"],
    ["--gemm", "8x8x8", "--pipeline", "lower", "--simulate", "host",
     "--crossbar", "axi4_lite"],
    ["--gemm", "8x8x8", "--pipeline", "lower", "--simulate", "host",
     "--crossbar-latency", "40", "--crossbar-width", "64"],
    ["--gemm", "8x8x8", "--epilogue", "none", "--pipeline", "lower",
     "--simulate", "fabric", "--fabric-slots", "2", "--fabric-requests",
     "6"],
    ["--gemm", "8x8x8", "--epilogue", "relu", "--pipeline", "lower",
     "--simulate", "fabric", "--fabric-policy", "priority", "--seed", "3"],
    ["--gemm", "256x128x64", "--epilogue", "bias_relu", "--pipeline",
     "lower{tile_m=32,tile_n=32,tile_k=32},fuse-epilogue"],
    ["--pipeline", "lower;flatten", "--dump-after-each"],
    ["--gemm", "8x8x8", "--epilogue", "none", "--pipeline",
     "lower{tile_m=4,tile_n=4,tile_k=4},lower-to-hw,outline-subcircuits,"
     "share-units,canonicalize", "--dump-after-each", "--emit=verilog"],
    ["--gemm", "8x8x8", "--epilogue", "none", "--pipeline",
     "lower,lower-to-hw,set-sharing{mode=serialize}", "--simulate"],
    ["--gemm", "16x16x16", "--epilogue", "none", "--pipeline",
     "dse,lower-to-hw"],
    ["--gemm", "8x8x8", "--epilogue", "none", "--dse"],
    ["--gemm", "8x8x8", "--epilogue", "bias_relu", "--dse", "0"],
    ["--kernel", "flash:8x16x4", "--pipeline", "lower", "--simulate"],
    ["--kernel", "decode", "--emit=hw"],
    ["--kernel", "ssd:16x2x4", "--pipeline", "lower,canonicalize"],
    ["--gemm", "4x4x4", "--pipeline", "lower", "--no-verify"],
    ["--pipeline", "lower,lower-to-hw,emit-verilog,lower"],
    ["--pipeline", "bogus-pass"],
    ["--pipeline", "lower{tile_m=}"],
    ["--gemm", "axb"],
    ["--markdown"],
    ["--emit=verilg"],
    ["--kernel", "flsh"],
    ["--kernel", "flash:8x16"],
    ["--kernel", "decode", "--gemm", "4x4x4"],
    ["--raise", "qwen2_7b:mlp", "--gemm", "4x4x4"],
    ["--raise", "qwen2_7b", "--pipeline", "lower"],
    ["--trace"],
    ["--vcd", "x.vcd"],
    ["--crossbar", "axi5", "--simulate", "host"],
    ["--crossbar", "axi4"],
    ["--pareto-csv", "p.csv"],
    ["--dse", "--pipeline", "lower"],
    ["--dse", "--emit=hw"],
    ["--input", "missing.ir"],
    ["--emit=hw", "--pipeline", "lower,lower-to-hw,emit-verilog"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
def test_main_matches_reference(argv, capsys):
    want = _run(ref_reproc, argv, capsys)
    got = _run(reproc, argv, capsys)
    assert got[0] == want[0]
    assert _same(got[1]) == _ref(want[1])
    assert _same(got[2]) == _ref(want[2])


def test_written_files_match_reference(tmp_path, capsys):
    """``--pareto-csv``, ``--vcd`` and ``-o`` write the reference's bytes;
    a written module read back with ``--input`` runs the same pipeline."""
    for mod, tag in ((ref_reproc, "ref"), (reproc, "port")):
        d = tmp_path / tag
        d.mkdir()
        runs = [["--gemm", "8x8x8", "--epilogue", "none", "--dse", "2",
                 "--pareto-csv", str(d / "p.csv")],
                ["--gemm", "8x8x8", "--pipeline", "lower", "--simulate",
                 "host", "--trace", "--vcd", str(d / "g.vcd")],
                ["--gemm", "8x8x8", "--epilogue", "none", "--pipeline",
                 "lower{tile_m=4,tile_n=4,tile_k=4}", "-o", str(d / "k.ir")],
                ["--input", str(d / "k.ir"), "--pipeline", "grid{vars=2}",
                 "--emit=verilog"]]
        for argv in runs:
            code, out, err = _run(mod, argv, capsys)
            assert code == 0, err
            (d / f"out{runs.index(argv)}.txt").write_text(
                out.replace(str(d), "D"))
    for name in ("p.csv", "g.vcd", "k.ir", "out0.txt", "out1.txt",
                 "out3.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "ref" / name).read_bytes(), name


def test_list_passes_differs_only_in_the_backend_passes(capsys):
    for argv in (["--list-passes"], ["--list-passes", "--markdown"]):
        code, got, _ = _run(reproc, argv, capsys)
        rcode, want, _ = _run(ref_reproc, argv, capsys)
        assert code == rcode == 0
        rows = [ln for ln in _same(got).splitlines()
                if ln.startswith(("| `", "emit", "lower", "dse", "outline",
                                  "share", "set-", "canonicalize"))]
        want_rows = [ln for ln in _common(want).splitlines()
                     if ln.startswith(("| `", "emit", "lower", "dse",
                                       "outline", "share", "set-",
                                       "canonicalize"))]
        port_only = {ln for ln in rows if "emit-torch" in ln
                     or "emit-cuda" in ln}
        ref_only = {ln for ln in want_rows if "emit-jax" in ln
                    or "emit-pallas" in ln}
        assert len(port_only) == len(ref_only) == 2
        assert [ln for ln in rows if ln not in port_only] == [
            ln for ln in want_rows if ln not in ref_only]
    assert "docs/PASSES.md" not in got


def _doc_transcripts(path=os.path.join(os.path.dirname(__file__), "..",
                                       "docs", "RAISING.md")):
    """``reproc`` argument string -> the output block under it in the
    reference's generated docs/RAISING.md."""
    text = open(path).read()
    pat = re.compile(r"```sh\nPYTHONPATH=src python -m repro\.core\.reproc "
                     r"(.*?)\n```\n\n```\n(.*?)\n```", re.S)
    return dict(pat.findall(text))


RAISE_DOC_ARGVS = [
    ["--raise", "qwen2_7b:mlp"],
    ["--raise", "mamba2_130m"],
    ["--raise", "qwen2_7b:rmsnorm", "--pipeline",
     "lower{tile_m=8,tile_n=8,tile_k=8}", "--simulate"],
]


@pytest.mark.filterwarnings("ignore:invalid value encountered")
@pytest.mark.parametrize("argv", RAISE_DOC_ARGVS, ids=" ".join)
def test_raise_matches_the_reference_docs(argv, capsys):
    """``--raise`` prints the reference's docs/RAISING.md transcripts byte
    for byte: a raised module, a raisability report, and a raised block
    through a pipeline and the co-simulation (1,896 cycles)."""
    code, out, err = _run(reproc, argv, capsys)
    assert code == 0, err
    assert out.rstrip("\n") == _doc_transcripts()[" ".join(argv)]
    if "--simulate" in argv:
        assert "observed=1,896 cycles vs modeled=1,896" in out


@pytest.fixture
def ref_raising():
    import _torch_raise_ref
    with _torch_raise_ref.shim() as mod:
        yield mod


RAISE_ARGVS = [
    ["--raise", "qwen2_7b:head", "--emit=hw"],
    ["--raise", "mamba2_130m:ssd_core", "--pipeline", "lower",
     "--simulate"],
    ["--raise", "recurrentgemma_2b:rglru_core", "--emit=loop"],
    ["--raise", "qwen2_7b:rmsnorm", "--dse", "2"],
    ["--raise", "qwen2_7b:nope"],
    ["--raise", "nope_model"],
    ["--raise", "qwen2_7b", "--emit", "loop"],
    ["--raise", "qwen2_7b", "--simulate"],
    ["--raise", "qwen2_7b", "--dse"],
    ["--raise", "qwen2_7b:mlp", "--kernel", "flash"],
    ["--raise", "qwen2_7b:mlp", "--input", "x.ir"],
]


@pytest.mark.filterwarnings("ignore:invalid value encountered")
@pytest.mark.parametrize("argv", RAISE_ARGVS, ids=" ".join)
def test_raise_matches_reference(argv, capsys, ref_raising):
    """``--raise`` composed with ``--emit`` / ``--pipeline`` /
    ``--simulate`` / ``--dse``, and its error exits, against the
    reference's driver (its raiser patched for the installed jax)."""
    want = _run(ref_reproc, argv, capsys)
    got = _run(reproc, argv, capsys)
    assert got[0] == want[0]
    assert _same(got[1]) == _ref(want[1])
    assert _same(got[2]) == _ref(want[2])


def test_raise_unraisable_block_names_the_aten_op(capsys, ref_raising):
    """A block that does not raise exits 1 as the reference does; its
    diagnostic names the ATen op where the reference names the jax
    primitive."""
    argv = ["--raise", "qwen2_7b:rope"]
    want = _run(ref_reproc, argv, capsys)
    got = _run(reproc, argv, capsys)
    assert got[0] == want[0] == 1 and got[1] == want[1] == ""
    assert got[2].splitlines()[:2] == [
        ln.replace("'slice'", "'aten.slice.Tensor'").replace(
            "primitive: slice", "primitive: aten.slice.Tensor")
        for ln in want[2].splitlines()[:2]]
    assert "in node: " in got[2]


def test_timing_prints_one_row_per_pass(capsys):
    code, out, _ = _run(reproc, ["--gemm", "8x8x8", "--pipeline",
                                 "lower,canonicalize,lower-to-hw",
                                 "--timing"], capsys)
    assert code == 0
    table = out.split("// per-pass timing\n")[1].splitlines()
    assert sum(("lower " in ln or "canonicalize" in ln or "lower-to-hw" in ln)
               for ln in table) >= 3


def test_module_runs_without_jax():
    """``python -m repro_torch.core.reproc`` in a fresh interpreter with
    JAX unimportable: the whole stack, a host transaction and a DSE."""
    env = {**os.environ, "PYTHONPATH": "src"}
    block = ("import sys; sys.modules['jax'] = None; "
             "from repro_torch.core import reproc; "
             "sys.exit(reproc.main(sys.argv[1:]))")
    runs = (["--emit=verilog"],
            ["--gemm", "8x8x8", "--pipeline", "lower", "--simulate", "host"],
            ["--gemm", "8x8x8", "--epilogue", "none", "--dse", "1"])
    procs = [subprocess.Popen([sys.executable, "-c", block, *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env,
                              cwd=os.path.join(os.path.dirname(__file__),
                                               ".."))
             for argv in runs]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out
