"""Plain PyTorch oracles for the kernels of this package.

The port of ``repro/kernels/ref.py``; each oracle lands with the kernel it
checks: the GEMM's, attention's and the SSD scan's so far.  Unlike the
reference's, ``attention_ref`` and ``ssd_ref`` also take leading batch
dimensions, in place of ``jax.vmap``.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) in f32, whatever the operands' dtype."""
    return a.float() @ b.float()


def attention_mask(sq: int, sk: int, causal: bool, window, device
                   ) -> torch.Tensor:
    """(sq, sk) bool, True where query i may attend key j: the query
    positions are offset by sk - sq, causal keeps j <= qpos, ``window``
    keeps j > qpos - window."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Softmax attention oracle.  q: (..., Sq, D), k/v: (..., Sk, D).
    Masked logits are -1e30, not -inf, so a query row that is masked
    everywhere returns the mean of V."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    mask = attention_mask(sq, sk, causal, window, q.device)
    logits = torch.where(mask, logits, torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v.float()).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Mamba-2 SSD recurrence, the naive sequential oracle.

    x (..., S, H, P); dt (..., S, H), positive step sizes; A (H,),
    negative decay rates; B/C (..., S, N), one group; D (H,) or None, the
    skip.  Returns (..., S, H, P) in x's dtype; the state is f32."""
    S, H, P = x.shape[-3:]
    N = B.shape[-1]
    x32, dt32, B32, C32 = (t.float() for t in (x, dt, B, C))
    A32 = A.float()
    h = torch.zeros(x.shape[:-3] + (H, P, N), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dt_t = dt32[..., t, :]                               # (..., H)
        decay = torch.exp(dt_t * A32)
        dbx = (dt_t[..., None, None] * x32[..., t, :, :, None]
               * B32[..., t, None, None, :])                 # (..., H, P, N)
        h = h * decay[..., None, None] + dbx
        ys.append(torch.einsum("...hpn,...n->...hp", h, C32[..., t, :]))
    y = torch.stack(ys, dim=-3)
    if D is not None:
        y = y + D[:, None] * x32
    return y.to(x.dtype)
