"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled for
Hopper (``sm_90a``) by ``nvcc`` into ``build/lib<name>-<hash>.so`` beside
``csrc/`` (the hash is of the source, so an edited source rebuilds) and
loaded with ``ctypes``.  Nothing is built at import: the first launch
builds.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, compiled first unless it is built
    already, and loaded once per process.  Raises with the compiler's
    output if the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    lib = library_path(name)
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        os.replace(tmp, lib)            # atomic: never a half-written .so
    _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]
