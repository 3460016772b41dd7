"""Single-token (decode) attention over a partially-filled KV cache.

The PyTorch counterpart of ``repro/kernels/decode_attention.py``.  One
query token per sequence attends a (Smax)-deep cache of which only
``valid`` entries are live; the ``rep`` query heads of a GQA group share
one KV head.

Layout: q (B, KV, rep, hd); k/v (B, KV, Smax, hd), any strides with the
last one 1 (the model passes transposed views of its (B, Smax, KV, hd)
cache); ``valid`` (B,) int32.

On a CUDA tensor ``decode_attention`` launches the hand-written split-KV
kernel in ``csrc/decode_attention.cu`` (built at first use): the cache is
cut into ``split_plan``'s ranges, one block each, and a second kernel
merges the ranges' partial softmax sums.  On a CPU tensor it runs
``decode_attention_ref``, the plain PyTorch version of the same function;
``decode_attention_split_ref`` is the plain version of the split and the
merge.  ``decode_attention.launches`` counts the calls that launched,
``.narrow_launches`` those whose K/V rows were not 16-byte aligned and were
copied element by element.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
# split_plan: about two 128-thread blocks per SM of the H100's 132, and at
# least this many positions in a split
TARGET_BLOCKS = 2 * 132
MIN_SPLIT = 16


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def split_plan(smax: int, groups: int, splits: int | None = None):
    """(splits, length): the kernel cuts each of ``groups`` = B * KV caches
    of ``smax`` positions into ``splits`` ranges of ``length`` (the last may
    be shorter; with ``splits`` above ``smax`` the ranges past it are
    empty).  Unless ``splits`` is given it is chosen from ``smax`` and
    ``groups`` alone: enough blocks for about two per SM, each range at
    least ``MIN_SPLIT`` positions long."""
    if splits is None:
        splits = max(1, min(-(-TARGET_BLOCKS // groups),
                            -(-smax // MIN_SPLIT)))
        length = -(-smax // splits)
        return -(-smax // length), length
    if splits < 1:
        raise ValueError(f"splits={splits}: expected at least 1")
    return splits, -(-smax // splits)


def kernels_per_call(splits: int) -> int:
    """Kernel launches of one call: the splits, then the merge (none when
    one split writes the output itself)."""
    return 1 if splits == 1 else 2


def wide(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel copies K/V rows 16 bytes at a time: both data
    pointers and every outer stride 16-byte aligned, and hd a whole number
    of 16-byte vectors.  Else it copies them element by element."""
    el = k.element_size()
    return (k.shape[-1] * el % 16 == 0
            and all(t.data_ptr() % 16 == 0
                    and all(st * el % 16 == 0 for st in t.stride()[:3])
                    for t in (k, v)))


def _any_dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, block_k: int = 256
                     ) -> torch.Tensor:
    """q: (B, KV, rep, hd); k/v: (B, KV, Smax, hd); valid: (B,) int32.
    Returns (B, KV, rep, hd) in q's dtype.  ``block_k`` is the reference's
    tile: it must divide Smax (the reference's rule), and the kernel's own
    ranges (``split_plan``) do not follow it.  A DTensor is refused: under
    a mesh each rank calls this on its own rows and KV heads
    (``layers.apply_attention``'s per-shard region)."""
    if _any_dtensor(q, k, v, valid):
        raise TypeError("decode_attention takes plain tensors, not DTensors:"
                        " under a mesh call it on each rank's own rows and "
                        "KV heads (a local_map region, as "
                        "layers.apply_attention does)")
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
    return _launch(q, k, v, valid, split_plan(Smax, B * KV))


def _launch(q, k, v, valid, plan):
    """Launch the kernel on CUDA tensors of checked shapes, in ``plan``'s
    (splits, length) ranges per (b, group)."""
    B, KV, rep, hd = q.shape
    Smax, (n_splits, length), device = k.shape[2], plan, q.device
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if valid.dtype != torch.int32 or not valid.is_contiguous():
        raise TypeError("valid must be a contiguous int32 tensor")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a unit stride on the head dimension")
    out = torch.empty((B, KV, rep, hd), dtype=q.dtype, device=device)
    ws = torch.empty((B * KV * n_splits * rep * (hd + 2)
                      if n_splits > 1 else 1,),
                     dtype=torch.float32, device=device)
    is_wide = wide(k, v)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel()(
            _DTYPES[q.dtype], int(is_wide), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), valid.data_ptr(), ws.data_ptr(), out.data_ptr(),
            B, KV, rep, hd, Smax, n_splits, length,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(1.0 / hd ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    decode_attention.narrow_launches += not is_wide
    return out


decode_attention.launches = 0     # calls that launched (CUDA tensors only)
decode_attention.narrow_launches = 0   # of those, element-by-element copies


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


def decode_attention_split_ref(q, k, v, valid, splits):
    """Plain version of the kernel's split and merge: each of ``splits``
    ranges of ``split_plan`` (per (b, group)) keeps its own softmax
    statistics over its live positions (min(valid, Smax), or all Smax when
    valid <= 0, where every score is -1e30); a range with no live position
    is left out.  The ranges then merge as online softmax merges tiles."""
    B, KV, rep, hd = q.shape
    Smax = k.shape[2]
    n_splits, length = split_plan(Smax, B * KV, splits)
    scale = 1.0 / hd ** 0.5
    s = torch.einsum("bgrh,bgsh->bgrs", q.float(), k.float()) * scale
    kpos = torch.arange(Smax, device=q.device)
    s = torch.where(kpos < valid[:, None, None, None], s,
                    torch.full((), _NEG, device=q.device))
    npos = torch.where(valid > 0, valid.clamp(max=Smax), Smax)
    ms, ls, accs, live = [], [], [], []
    for i in range(n_splits):
        lo, hi = i * length, min((i + 1) * length, Smax)
        if lo >= hi:        # past Smax: no position at all
            live.append(torch.zeros(B, dtype=torch.bool, device=q.device))
            ms.append(torch.full((B, KV, rep), _NEG, device=q.device))
            ls.append(torch.zeros((B, KV, rep), device=q.device))
            accs.append(torch.zeros((B, KV, rep, hd), device=q.device))
            continue
        sl = s[..., lo:hi]
        inside = (kpos[lo:hi] < npos[:, None])[:, None, None, :]
        m = torch.where(inside, sl, torch.full((), -torch.inf,
                                               device=q.device)).amax(-1)
        m = torch.maximum(m, torch.full((), _NEG, device=q.device))
        p = torch.where(inside, torch.exp(sl - m[..., None]), 0.0)
        live.append(lo < npos)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bgrs,bgsh->bgrh", p, v[:, :, lo:hi].float()))
    live = torch.stack(live, -1)[:, None, None, :]         # (B, 1, 1, n)
    m = torch.where(live, torch.stack(ms, -1), -torch.inf)
    w = torch.where(live, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    l_sum = (w * torch.stack(ls, -1)).sum(-1)
    acc = (w[..., None, :] * torch.stack(accs, -1)).sum(-1)
    return (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)
