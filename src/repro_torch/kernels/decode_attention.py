"""Single-token (decode) attention over a partially-filled KV cache.

The PyTorch counterpart of ``repro/kernels/decode_attention.py``.  One
query token per sequence attends a (Smax)-deep cache of which only
``valid`` entries are live; the ``rep`` query heads of a GQA group share
one KV head.

Layout: q (B, KV, rep, hd); k/v (B, KV, Smax, hd), any strides with the
last one 1 (the model passes transposed views of its (B, Smax, KV, hd)
cache); ``valid`` (B,) int32.

On a CUDA tensor ``decode_attention`` launches the hand-written kernel in
``csrc/decode_attention.cu`` (built at first use); on a CPU tensor it runs
``decode_attention_ref``, the plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, block_k: int = 256
                     ) -> torch.Tensor:
    """q: (B, KV, rep, hd); k/v: (B, KV, Smax, hd); valid: (B,) int32.
    Returns (B, KV, rep, hd) in q's dtype.  ``block_k`` is the number of
    cache positions the kernel handles per tile."""
    B, KV, rep, hd = q.shape
    Smax = k.shape[2]
    block_k = min(block_k, Smax)
    if Smax % block_k:
        raise ValueError(f"Smax={Smax} % block_k={block_k}")
    if k.shape != (B, KV, Smax, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: expected k/v (B, KV, Smax, hd)")
    if valid.shape != (B,):
        raise ValueError(f"valid {tuple(valid.shape)}: expected ({B},)")
    devices = {t.device for t in (q, k, v, valid)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = q.device
    if device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if valid.dtype != torch.int32 or not valid.is_contiguous():
        raise TypeError("valid must be a contiguous int32 tensor")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a unit stride on the head dimension")
    out = torch.empty((B, KV, rep, hd), dtype=q.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), out.data_ptr(), B, KV, rep, hd, Smax, block_k,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(1.0 / hd ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0     # kernel launches (CUDA tensors only)


def decode_attention_ref(q, k, v, valid):
    """Plain version: per-(b, kv-group) masked softmax attention."""
    B, KV, rep, hd = q.shape
    Smax = k.shape[2]
    scale = 1.0 / hd ** 0.5
    s = torch.einsum("bgrh,bgsh->bgrs", q.float(), k.float()) * scale
    kpos = torch.arange(Smax, device=q.device)[None, None, None, :]
    s = torch.where(kpos < valid[:, None, None, None], s,
                    torch.full((), _NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrs,bgsh->bgrh", p, v.float()).to(q.dtype)
