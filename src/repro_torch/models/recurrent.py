"""Recurrent blocks: RG-LRU (recurrentgemma/griffin) and SSD (mamba2).

The PyTorch counterpart of ``repro/models/recurrent.py``.  Layouts and
arithmetic are the reference's, so params converted from the JAX package
compute the same function here:

  * RG-LRU's linear recurrence runs as a log-depth (Hillis-Steele) scan
    over the sequence, in place of ``jax.lax.associative_scan``; decode is
    one recurrence step on the cached state;
  * SSD's prefill is the reference's chunked decomposition with an
    initial and final state (``_ssd_with_state``), plain torch as in the
    reference, which never calls the kernels package there; decode is the
    single-token recurrence on the cached state.

The recurrent states (``h``, ``state``) are float32 and the convolution
windows (``conv``) are in the cache's dtype, as in the reference.  Unlike
the reference, which returns a new cache, a given cache is updated in
place (``copy_`` into its own tensors) and returned, so a decode step
captured as a CUDA graph writes the engine's cache.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, reshape, shard
from repro_torch.models.layers import Maker, Params, _gelu, rmsnorm


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C), w: (W, C).  ``state``:
    (B, W-1, C), the previous inputs (decode / prefill continuation).
    Returns (y, new_state); the W taps are summed in f32 in the order
    i = 0..W-1."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    ext = torch.cat([state.to(x.dtype), x], dim=1)       # (B, S+W-1, C)
    w32 = w.float()
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + ext[:, i:i + S].float() * w32[i]
    new_state = (ext[:, -(W - 1):] if W > 1 else
                 torch.zeros((B, 0, C), dtype=x.dtype, device=x.device))
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# RG-LRU (griffin recurrent block)
# --------------------------------------------------------------------------


def init_rglru(cfg, mk: Maker) -> Params:
    d = cfg.d_model
    r = cfg.rglru
    w = r.width or d
    return {
        "norm": mk((d,), "embed", init="zeros"),
        "w_x": mk((d, w), "fsdp ff"),
        "w_y": mk((d, w), "fsdp ff"),          # gate branch
        "conv": mk((r.conv_width, w), "- ff"),
        "w_a_gate": mk((w, w), "fsdp ff"),
        "w_i_gate": mk((w, w), "fsdp ff"),
        "a_param": mk((w,), "ff", init="normal", scale=0.5),
        "w_out": mk((w, d), "ff fsdp"),
    }


def _rglru_scan(u: torch.Tensor, ag: torch.Tensor, ig: torch.Tensor,
                a_param: torch.Tensor, c: float,
                h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u/ag/ig: (B, S, W).  Returns (h_seq, h_last), f32."""
    log_a = -c * F.softplus(a_param.float()) * torch.sigmoid(ag.float())
    a = torch.exp(log_a)                                # (B, S, W)
    gated = torch.sigmoid(ig.float()) * u.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * gated
    if h0 is not None:
        # fold the initial state in as a virtual step at t=-1
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    # inclusive scan of (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), in
    # log2(S) rounds of doubling offsets
    off, n = 1, a.shape[1]
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], b_prev * a[:, off:] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a_prev * a[:, off:]], dim=1)
        off *= 2
    h = b[:, 1:] if h0 is not None else b
    return h, h[:, -1]


def apply_rglru(p: Params, x: torch.Tensor, cfg,
                cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    r = cfg.rglru
    h_in = rmsnorm(x, p["norm"], cfg.norm_eps)
    u = shard(h_in @ p["w_x"], "batch", None, "ff")
    ygate = _gelu(h_in @ p["w_y"])

    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv1d(u, p["conv"], conv_state)
    ag = u @ p["w_a_gate"]
    ig = u @ p["w_i_gate"]
    h0 = cache["h"] if cache is not None else None
    h, h_last = _rglru_scan(u, ag, ig, p["a_param"], r.c, h0)
    out = (h * ygate.to(h.dtype)).to(x.dtype) @ p["w_out"]
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)
    return x + shard(out, "batch", None, None), cache


def rglru_cache_spec(cfg, batch: int, dtype: torch.dtype) -> dict:
    """{leaf: (shape, dtype)}: the f32 state and the conv window."""
    r = cfg.rglru
    w = r.width or cfg.d_model
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, r.conv_width - 1, w), dtype)}


# --------------------------------------------------------------------------
# SSD / mamba2 block
# --------------------------------------------------------------------------


def init_ssd(cfg, mk: Maker) -> Params:
    d = cfg.d_model
    s = cfg.ssm
    di = s.d_inner or 2 * d
    H = di // s.head_dim
    N = s.state_dim
    return {
        "norm": mk((d,), "embed", init="zeros"),
        "in_proj": mk((d, 2 * di + 2 * N + H), "fsdp ff"),
        "conv": mk((s.conv_width, di + 2 * N), "- ff"),
        "A_log": mk((H,), "-", init="zeros"),
        "D": mk((H,), "-", init="ones"),
        "dt_bias": mk((H,), "-", init="zeros"),
        "out_norm": mk((di,), "ff", init="zeros"),
        "out_proj": mk((di, d), "ff fsdp"),
    }


def _split_ssd(proj: torch.Tensor, di: int, N: int, H: int):
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * N]
    dt = proj[..., -H:]
    return z, xbc, dt


def apply_ssd(p: Params, x: torch.Tensor, cfg,
              cache: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    B, S, d = x.shape
    s = cfg.ssm
    di = s.d_inner or 2 * d
    H = di // s.head_dim
    P, N = s.head_dim, s.state_dim

    h_in = rmsnorm(x, p["norm"], cfg.norm_eps)
    proj = h_in @ p["in_proj"]
    z, xbc, dt = _split_ssd(proj, di, N, H)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv1d(xbc, p["conv"], conv_state)
    xbc = F.silu(xbc)
    xs = reshape(xbc[..., :di], (B, S, H, P))
    Bmat = xbc[..., di:di + N]
    Cmat = xbc[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    h0 = cache["state"] if cache is not None else None
    if S == 1 and cache is not None:
        # single-token recurrence (decode)
        decay = torch.exp(dt[:, 0] * A[None, :])                  # (B, H)
        dBx = (dt[:, 0, :, None, None] * xs[:, 0, :, :, None]
               * Bmat[:, 0, None, None, :])                       # (B,H,P,N)
        h_new = h0 * decay[..., None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h_new, Cmat[:, 0].float()) \
            + p["D"].float()[None, :, None] * xs[:, 0]
        y = reshape(y[:, None], (B, S, di)).to(x.dtype)
        new_state = h_new
    else:
        y, new_state = _ssd_with_state(xs, dt, A, Bmat, Cmat, p["D"], h0,
                                       s.chunk)
        y = reshape(y, (B, S, di))
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["out_norm"],
                cfg.norm_eps)
    out = y @ p["out_proj"]
    if cache is not None:
        cache["state"].copy_(new_state)
        cache["conv"].copy_(new_conv)
    return x + shard(out, "batch", None, None), cache


def _ssd_with_state(xs, dt, A, Bmat, Cmat, D, h0, chunk):
    """Batched chunked SSD that threads an initial / final state.
    xs: (B,S,H,P), dt: (B,S,H), Bmat/Cmat: (B,S,N), h0: (B,H,P,N) or None.
    Returns (y in xs' dtype, the f32 final state).  Under a mesh each
    rank scans its own rows and heads (``_ssd_per_shard``)."""
    if is_dtensor(xs):
        return _ssd_per_shard(xs, dt, A, Bmat, Cmat, D, h0, chunk)
    B_, S, H, P = xs.shape
    N = Bmat.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    nc = S // chunk
    idx = torch.arange(chunk, device=xs.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,L,L,1)
    xc = xs.reshape(B_, nc, chunk, H, P).float()
    dtc = dt.reshape(B_, nc, chunk, H).float()
    Bc = Bmat.reshape(B_, nc, chunk, N).float()
    Cc = Cmat.reshape(B_, nc, chunk, N).float()

    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=xs.device)
         if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        sl = torch.cumsum(dtk * A[None, None, :], dim=1)           # (B,L,H)
        M = torch.where(causal, torch.exp(sl[:, :, None] - sl[:, None]),
                        torch.zeros((), device=xs.device))          # (B,t,u,H)
        CB = torch.einsum("btn,bun->btu", Ck, Bk)
        y_intra = torch.einsum("btuh,btu,buhp->bthp", M, CB,
                               dtk[..., None] * xk)
        y_inter = torch.exp(sl)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                          Ck, h)
        w = torch.exp(sl[:, -1][:, None] - sl) * dtk                 # (B,L,H)
        h = (torch.exp(sl[:, -1])[:, :, None, None] * h
             + torch.einsum("buhp,bun->bhpn", w[..., None] * xk, Bk))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, P)
    y = y + D[None, None, :, None] * xs.float()
    return y.to(xs.dtype), h


def _ssd_per_shard(xs, dt, A, Bmat, Cmat, D, h0, chunk):
    """``_ssd_with_state`` for DTensor ``xs``: a ``local_map`` region in
    which each rank scans its own rows (``xs``'s batch sharding) and heads
    (its head sharding), which needs no communication.  DTensor (torch
    2.11) refuses the chunk einsums' flatten of the batch and a sharded
    head dim.  An input replicated over a mesh dim the region splits
    (Bmat and Cmat over the heads', A and D over the rows') gets a
    ``Partial`` gradient over it: each rank holds its rows' or heads'
    part of the sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh

    def placed(dims):
        """Each mesh dim's placement for a tensor whose batch dim is
        ``dims[0]`` and head dim ``dims[1]`` (None: it has none)."""
        out = []
        for p in xs.placements:
            if p == Shard(0) and dims[0] is not None:
                out.append(Shard(dims[0]))
            elif p == Shard(2) and dims[1] is not None:
                out.append(Shard(dims[1]))
            else:
                out.append(Replicate())
        return out
    split = placed((0, 2))
    ins = [(xs, split), (dt, placed((0, 2))), (A, placed((None, 0))),
           (Bmat, placed((0, None))), (Cmat, placed((0, None))),
           (D, placed((None, 0)))]
    if h0 is not None:
        ins.append((h0, placed((0, 1))))
    grads = [[Partial() if p == Replicate() and s != Replicate() else p
              for p, s in zip(pl, split)] for _, pl in ins]
    rep = [Replicate()] * mesh.ndim

    def dtensor(x):
        return x if is_dtensor(x) else DTensor.from_local(
            x, mesh, rep, run_check=False)

    def local(xs, dt, A, Bmat, Cmat, D, h0=None):
        return _ssd_with_state(xs, dt, A, Bmat, Cmat, D, h0, chunk)
    return local_map(local, out_placements=(split, placed((0, 1))),
                     in_placements=tuple(pl for _, pl in ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(
        *(dtensor(x) for x, _ in ins))


def ssd_cache_spec(cfg, batch: int, dtype: torch.dtype) -> dict:
    """{leaf: (shape, dtype)}: the f32 state and the conv window."""
    s = cfg.ssm
    di = s.d_inner or 2 * cfg.d_model
    H = di // s.head_dim
    return {
        "state": ((batch, H, s.head_dim, s.state_dim), torch.float32),
        "conv": ((batch, s.conv_width - 1, di + 2 * s.state_dim), dtype),
    }
