"""Blocked (flash) attention.

The PyTorch counterpart of ``repro/kernels/flash_attention.py``.  q is
(BH, Sq, D) and k/v are (BH, Sk, D); the result is (BH, Sq, D) in q's
dtype, with the softmax statistics in f32.  Causal and local-window masks
place query row i at position i + (Sk - Sq); masked logits are -1e30, not
-inf, so a row that is masked everywhere returns the mean of V.

On a CUDA tensor ``flash_attention`` launches one of three hand-written
kernels (built at first use), as ``route`` decides: bf16 with a head dim
that is a multiple of 16 up to 256 goes to the tensor-core kernel in
``csrc/flash_attention_sm90.cu`` (``wgmma`` fed by TMA); f32 with a head
dim that is a multiple of 4 up to 256 to the register-tiled CUDA-core
kernel in ``csrc/flash_attention_ffma.cu`` (``ffma``, K and V by
cp.async); everything else to ``csrc/flash_attention.cu`` (``simt``, on
the CUDA cores; head dims above 256 in column slices of the output).  On a
CPU tensor it runs ``flash_attention_plain``, the plain PyTorch version of
the same function.  ``flash_attention.launches`` counts the launches,
``.wgmma_launches`` and ``.ffma_launches`` those on the two newer kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIBS = {}


def _kernel(route: str):
    """The launcher of ``route``'s kernel, built at first use."""
    if route not in _LIBS:
        if route == "wgmma":
            fn = _build.load("flash_attention_sm90").flash_attention_sm90_launch
            head = []
        elif route == "ffma":
            fn = _build.load("flash_attention_ffma").flash_attention_ffma_launch
            head = []
        else:
            fn = _build.load("flash_attention").flash_attention_launch
            head = [ctypes.c_int]
        fn.argtypes = (head + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIBS[route] = fn
    return _LIBS[route]


def route(dtype: torch.dtype, d: int, *ptrs: int):
    """The kernel for inputs of ``dtype`` and head dim ``d`` at data
    pointers ``ptrs`` (all 16-byte aligned, as TMA and the 16-byte copies
    need): ``("wgmma", reason)`` for the tensor-core kernel (bf16, ``d`` a
    multiple of 16 up to 256), ``("ffma", reason)`` for the register-tiled
    CUDA-core one (f32, ``d`` a multiple of 4 up to 256), else ``("simt",
    reason)``: odd head dims, ``d`` above 256 (column slices), and bf16
    off the tensor cores.  A pure function, decided before the launch."""
    if any(p % 16 for p in ptrs):
        return "simt", "data not 16-byte aligned"
    if d > 256:
        return "simt", f"head dim {d} is above 256"
    if dtype == torch.bfloat16:
        if d % 16:
            return "simt", f"bfloat16, head dim {d} not a multiple of 16"
        return "wgmma", "bfloat16, head dim a multiple of 16 up to 256"
    if dtype != torch.float32:
        return "simt", f"{dtype} is neither bfloat16 nor float32"
    if d % 4:
        return "simt", f"float32, head dim {d} not a multiple of 4"
    return "ffma", "float32, head dim a multiple of 4 up to 256"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D) -> (BH, Sq, D).

    ``block_q`` / ``block_k`` are the reference's tiles and must divide
    the lengths, as there.  The CUDA kernels pick their own tiles (64
    query rows by 32 keys; 128 by 64 on the tensor cores and on ``ffma``,
    64 by 64 there at head dims above 128), and the result does not depend
    on them."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or (
            k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: expected q (BH, Sq, D) and "
                         f"k/v (BH, Sk, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lens ({sq},{sk}) must divide blocks "
                         f"({block_q},{block_k})")
    scale = float(scale) if scale is not None else float(1.0 / math.sqrt(d))
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = q.device
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q/k/v must be contiguous")
    out = torch.empty_like(q)
    path, why = route(q.dtype, d, *(t.data_ptr() for t in (q, k, v, out)))
    head = [_DTYPES[q.dtype]] if path == "simt" else []
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel(path)(*head, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), bh, sq, sk, d, int(causal),
                            int(window is not None), int(window or 0), scale,
                            stream)
    if err:
        raise RuntimeError(f"flash_attention kernel ({path}: {why}) launch "
                           f"failed: error {err} (a cudaError, or 1000 + a "
                           f"CUresult from the tensor maps)")
    flash_attention.launches += 1
    if path == "wgmma":
        flash_attention.wgmma_launches += 1
    elif path == "ffma":
        flash_attention.ffma_launches += 1
    return out


flash_attention.launches = 0     # kernel launches (CUDA tensors only)
flash_attention.wgmma_launches = 0   # of those, on the tensor-core kernel
flash_attention.ffma_launches = 0    # of those, on the register-tiled one


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """Plain version: the masked softmax over the whole (BH, Sq, Sk) score
    tensor at once, in f32."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
