"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled for
Hopper (``sm_90a``) by ``nvcc`` into ``build/lib<name>-<hash>.so`` beside
``csrc/`` (the hash is of the source, so an edited source rebuilds) and
loaded with ``ctypes``.  Source text that the compiler generates (the
emitted GEMMs of ``core/backend_cuda.py``) is built the same way by
``load_source``.  Both keys also hash the ``csrc/*.cuh`` headers, so an
edited header rebuilds.  ``nvcc`` runs with ``-Xptxas -v``; what it prints
(each kernel's registers, shared memory and spills) is kept beside the
library as ``<library>.ptxas.txt`` (``ptxas_log``).  Nothing is built at
import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = CSRC.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{CSRC}")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = _source_digest((CSRC / f"{name}.cu").read_text())
    return BUILD / f"lib{name}-{digest}.so"


def ptxas_log(lib: pathlib.Path) -> str:
    """What ``nvcc -Xptxas -v`` printed when ``lib`` was built."""
    return lib.with_suffix(".ptxas.txt").read_text()


def _compile(src: pathlib.Path, lib: pathlib.Path) -> None:
    """nvcc ``src`` into ``lib``; raises with the compiler's output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout)
    os.replace(tmp, lib)                # atomic: never a half-written .so


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, compiled first unless it is built
    already, and loaded once per process.  Raises with the compiler's
    output if the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    lib = library_path(name)
    if not lib.exists():
        _compile(CSRC / f"{name}.cu", lib)
    _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]


def _source_digest(text: str) -> str:
    """Key of a source: its text and the ``csrc/*.cuh`` headers it may
    include, so an edited header rebuilds too."""
    h = hashlib.sha256(text.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def source_library(text: str) -> pathlib.Path:
    """Where ``load_source`` builds the library of ``text``."""
    return BUILD / f"libgen-{_source_digest(text)}.so"


def load_source(text: str) -> ctypes.CDLL:
    """The library of a generated CUDA source ``text``, keyed by
    ``_source_digest``: written to ``build/gen-<digest>.cu``, compiled by
    one synchronous nvcc unless built already, and loaded once per
    process.  Raises with the compiler's output if the build fails."""
    lib = source_library(text)
    key = lib.stem[3:]
    if key in _LOADED:
        return _LOADED[key]
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = BUILD / f"{key}.cu"
        fd, tmp = tempfile.mkstemp(suffix=".cu", dir=BUILD)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, src)
        _compile(src, lib)
    _LOADED[key] = ctypes.CDLL(str(lib))
    return _LOADED[key]
