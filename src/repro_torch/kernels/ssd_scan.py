"""Mamba-2 SSD (state-space duality) chunked scan.

The PyTorch counterpart of ``repro/kernels/ssd_scan.py``.  Per head h and
chunk of length L, with state dim N and head dim P:

    s_t   = cumsum(dt_t * A)                       (log-decay within chunk)
    y_t   = exp(s_t) * (C_t · h_in)                      [inter-chunk]
          + sum_{u<=t} exp(s_t - s_u) dt_u (C_t·B_u) x_u [intra]
    h_out = exp(s_L) h_in + Σ_u exp(s_L - s_u) dt_u x_u B_u^T

with the (P, N) state in f32, carried from chunk to chunk.

Shapes: x (..., S, H, P), dt (..., S, H), A (H,), B/C (..., S, N), D (H,)
or None.  The reference's functions take (S, H, P) alone and ``ops.ssd``
vmaps them; here leading dims are a batch axis of one launch.

  * ``ssd_scan`` launches the hand-written kernels in ``csrc/ssd_scan.cu``
    on CUDA tensors: three passes (chunk states, state passing, chunk
    outputs), each over every chunk at once.  On CPU tensors it runs
    ``ssd_scan_plain``, the plain version of the kernel's maths.  The D
    skip is added outside the kernels, after y is cast to x's dtype, as the
    reference does.  ``ssd_chunk_states_plain``,
    ``ssd_state_passing_plain`` and ``ssd_chunk_outputs_plain`` are the
    plain versions of the three passes; composed, they are ``_chunk_scan``.
  * ``ssd_chunked`` is the reference's XLA path in plain PyTorch: the
    same chunked maths, with the D skip added in f32 and one cast.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        fn = _build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def _check(x, dt, A, B, C, D, chunk):
    """The shared shape checks; returns the chunk length min(chunk, S)."""
    if x.dim() < 3:
        raise ValueError(f"x {tuple(x.shape)}: expected (..., S, H, P)")
    lead, (S, H, P) = x.shape[:-3], x.shape[-3:]
    N = B.shape[-1]
    if (dt.shape != lead + (S, H) or A.shape != (H,)
            or B.shape != lead + (S, N) or C.shape != B.shape
            or (D is not None and D.shape != (H,))):
        raise ValueError(
            f"x {tuple(x.shape)} dt {tuple(dt.shape)} A {tuple(A.shape)} "
            f"B {tuple(B.shape)} C {tuple(C.shape)}: expected dt (..., S, H),"
            f" A (H,), B/C (..., S, N), D (H,)")
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} must divide chunk={chunk}")
    return chunk


def _chunk_scan(x, dt, A, B, C, chunk):
    """The chunked maths in f32: y (..., S, H, P) without the D skip."""
    lead, (S, H, P) = x.shape[:-3], x.shape[-3:]
    N = B.shape[-1]
    nc = S // chunk
    xc = x.float().reshape(lead + (nc, chunk, H, P))
    dtc = dt.float().reshape(lead + (nc, chunk, H))
    Bc = B.float().reshape(lead + (nc, chunk, N))
    Cc = C.float().reshape(lead + (nc, chunk, N))
    A32 = A.float()
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]      # (t, u, 1)
    h = torch.zeros(lead + (H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk = xc[..., c, :, :, :], dtc[..., c, :, :]      # (.., L, H, P)
        Bk, Ck = Bc[..., c, :, :], Cc[..., c, :, :]           # (.., L, N)
        s = torch.cumsum(dtk * A32, dim=-2)                   # (.., L, H)
        seg = s[..., :, None, :] - s[..., None, :, :]         # s_t - s_u
        M = torch.where(causal, torch.exp(seg), 0.0)          # (.., t, u, H)
        CB = Ck @ Bk.transpose(-1, -2)                        # (.., t, u)
        y_intra = torch.einsum("...tuh,...uhp->...thp", M * CB[..., None],
                               dtk[..., None] * xk)
        y_inter = torch.exp(s)[..., None] * torch.einsum(
            "...tn,...hpn->...thp", Ck, h)
        w = torch.exp(s[..., -1:, :] - s) * dtk               # (.., L, H)
        h = (torch.exp(s[..., -1, :])[..., None, None] * h
             + torch.einsum("...uhp,...un->...hpn", w[..., None] * xk, Bk))
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=-4).reshape(x.shape)


def _add_skip(y, x, D):
    """The D skip as the reference's ``ssd_scan`` adds it, outside the
    kernel: y is already in x's dtype, and D·x is cast to it before the
    add (``ssd_chunked`` adds in f32 and casts once instead)."""
    if D is None:
        return y
    return y + (D[:, None] * x.float()).to(y.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None,
             *, chunk: int = 64) -> torch.Tensor:
    """x (..., S, H, P), dt (..., S, H), A (H,), B/C (..., S, N), D (H,)
    or None -> (..., S, H, P) in x's dtype."""
    chunk = _check(x, dt, A, B, C, D, chunk)
    devices = {t.device for t in (x, dt, A, B, C)
               + ((D,) if D is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = x.device
    if device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"x/dt/B/C must share one dtype of {list(_DTYPES)};"
                        f" got {x.dtype}, {dt.dtype}, {B.dtype}, {C.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, B, C)):
        raise ValueError("x/dt/B/C must be contiguous")
    *lead, S, H, P = x.shape
    y = torch.empty_like(x)
    ws = _workspace(x, B, chunk)
    a32 = A.float().contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel()(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                        a32.data_ptr(), B.data_ptr(), C.data_ptr(),
                        y.data_ptr(), ws.data_ptr(), math.prod(lead), S, H,
                        P, B.shape[-1], chunk, stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return _add_skip(y, x, D)


ssd_scan.launches = 0     # calls that launched (CUDA tensors only)


def _workspace(x, B, chunk):
    """The f32 workspace of one ``ssd_scan`` call: a (P, N) state and a
    decay per (sequence, chunk, head), s = cumsum(dt A) per step and head,
    and each chunk's (L, L) C B^T."""
    *lead, S, H, P = x.shape
    return torch.empty(math.prod(lead) * (S // chunk * H
                                          * (P * B.shape[-1] + 1)
                                          + S * (H + chunk)) + 8,
                       dtype=torch.float32, device=x.device)


def ssd_scan_plain(x, dt, A, B, C, D=None, *, chunk=64):
    """Plain version of ``ssd_scan``: the kernel's chunked maths in f32,
    y cast to x's dtype, then the D skip."""
    chunk = _check(x, dt, A, B, C, D, chunk)
    return _add_skip(_chunk_scan(x, dt, A, B, C, chunk).to(x.dtype), x, D)


def _chunk_parts(x, dt, A, B, chunk):
    """Per chunk, in f32: x, dt, B (..., nc, L, ...) and s = cumsum(dt A)
    (..., nc, L, H)."""
    lead, (S, H, P) = x.shape[:-3], x.shape[-3:]
    nc = S // chunk
    xc = x.float().reshape(lead + (nc, chunk, H, P))
    dtc = dt.float().reshape(lead + (nc, chunk, H))
    Bc = B.float().reshape(lead + (nc, chunk, B.shape[-1]))
    s = torch.cumsum(dtc * A.float(), dim=-2)
    return xc, dtc, Bc, s


def _chunk_state(xc, dtc, Bc, s):
    """S_c = ((exp(s_L - s) dt) o x)^T B: (..., nc, H, P, N)."""
    w = torch.exp(s[..., -1:, :] - s) * dtc
    return torch.einsum("...cuhp,...cun->...chpn", w[..., None] * xc, Bc)


def ssd_chunk_states_plain(x, dt, A, B, *, chunk=64):
    """Pass 1: per (sequence, chunk, head) the chunk's own state
    S_c = ((exp(s_L - s) dt) o x)^T B and its decay exp(s_L).  Returns
    (states (..., nc, H, P, N), decays (..., nc, H)), f32."""
    xc, dtc, Bc, s = _chunk_parts(x, dt, A, B, chunk)
    return _chunk_state(xc, dtc, Bc, s), torch.exp(s[..., -1, :])


def ssd_state_passing_plain(states, decays):
    """Pass 2: the state entering each chunk, h <- decay h + S in chunk
    order from 0.  states (..., nc, H, P, N), decays (..., nc, H)."""
    h, out = torch.zeros_like(states[..., 0, :, :, :]), []
    for k in range(states.shape[-4]):
        out.append(h)
        h = decays[..., k, :, None, None] * h + states[..., k, :, :, :]
    return torch.stack(out, -4)


def ssd_chunk_outputs_plain(x, dt, A, B, C, h_in, *, chunk=64):
    """Pass 3: y = exp(s) o (C h^T) + (M o C B^T)(dt o x) per chunk, h the
    state entering the chunk, ``h_in`` (..., nc, H, P, N).  Returns
    (..., S, H, P) f32, without the D skip."""
    xc, dtc, Bc, s = _chunk_parts(x, dt, A, B, chunk)
    Cc = C.float().reshape(Bc.shape)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]      # (t, u, 1)
    ys = []
    for c in range(xc.shape[-4]):
        h = h_in[..., c, :, :, :]
        sk, Ck = s[..., c, :, :], Cc[..., c, :, :]
        M = torch.where(causal, torch.exp(sk[..., :, None, :]
                                          - sk[..., None, :, :]), 0.0)
        CB = Ck @ Bc[..., c, :, :].transpose(-1, -2)
        y_intra = torch.einsum("...tuh,...uhp->...thp", M * CB[..., None],
                               dtc[..., c, :, :, None] * xc[..., c, :, :, :])
        y_inter = torch.exp(sk)[..., None] * torch.einsum(
            "...tn,...hpn->...thp", Ck, h)
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=-4).reshape(x.shape)


def bracket(x, dt, A, B, C, D=None, *, chunk=64, rtol=1e-3, atol=1e-4):
    """(lo, hi): the range that any run of ``ssd_scan`` lands in whose f32
    y lies within atol + rtol |y| of the plain version's.  The steps after
    y (the cast to x's dtype, the D skip's add and its rounding) are
    nondecreasing in y, so running them on both ends of y's range gives
    the ends of the result's.  In bf16 this holds a kernel to one f32 bound
    and to the plain version's roundings."""
    chunk = _check(x, dt, A, B, C, D, chunk)
    y = _chunk_scan(x, dt, A, B, C, chunk)
    e = atol + rtol * y.abs()
    return (_add_skip((y - e).to(x.dtype), x, D),
            _add_skip((y + e).to(x.dtype), x, D))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                D: torch.Tensor | None = None, chunk: int = 64
                ) -> torch.Tensor:
    """The reference's XLA path: the chunked maths in f32, the D skip
    added in f32, one cast to x's dtype."""
    chunk = _check(x, dt, A, B, C, D, chunk)
    y = _chunk_scan(x, dt, A, B, C, chunk)
    if D is not None:
        y = y + D[:, None] * x.float()
    return y.to(x.dtype)
