"""Mixture-of-Experts block (deepseek-v2 / kimi-k2 style).

The PyTorch counterpart of ``repro/models/moe.py``, on one device: the
reference's sort-based dispatch through an (E*C, d) expert buffer with a
capacity of C = min(T, ceil(T*K*cf / E)) tokens per expert; tokens past
an expert's capacity drop through the residual.  The reference's
expert-parallel ``shard_map`` path needs a mesh, which the port has not
yet (ROADMAP A11).

Every step is fixed in order and reads nothing back to the host, so a
decode step runs the same bits eagerly and captured as a CUDA graph:

  * top-k is the first K of a stable descending sort of the router
    probabilities, so ties go to the lower expert index, as
    ``jax.lax.top_k`` gives them (``torch.topk`` makes no promise);
  * the slot order is a stable argsort of the expert ids;
  * counts are a ``scatter_add_`` of ones, dropped tokens go to a trash
    row through ``torch.where`` (no boolean indexing, ``nonzero``,
    ``bincount`` or ``.item()``);
  * the combine gathers each token's K contributions in expert order and
    adds them one after another, the order of the reference's
    scatter-add, instead of an atomic ``index_add_``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Maker, Params, _gelu, rmsnorm

# MoE execution strategy, the reference's knob.  "shardmap" (the
# expert-parallel path) needs a device mesh, which the port lacks.
_MOE_IMPL = "auto"


def set_moe_impl(impl: str) -> None:
    global _MOE_IMPL
    assert impl in ("auto", "gspmd", "shardmap"), impl
    if impl == "shardmap":
        raise NotImplementedError(
            "moe: the expert-parallel shard_map path needs a device mesh, "
            "which the port does not have yet (ROADMAP A11)")
    _MOE_IMPL = impl


def init_moe(cfg, mk: Maker) -> Params:
    d = cfg.d_model
    m = cfg.moe
    gated = cfg.mlp.startswith("gated")
    p = {
        "norm": mk((d,), "embed", init="zeros"),
        "router": mk((d, m.num_experts), "fsdp -"),
        "w_up": mk((m.num_experts, d, m.expert_ff), "experts fsdp ff"),
        "w_down": mk((m.num_experts, m.expert_ff, d), "experts ff fsdp"),
    }
    if gated:
        p["w_gate"] = mk((m.num_experts, d, m.expert_ff), "experts fsdp ff")
    if m.num_shared:
        sf = m.expert_ff * m.num_shared
        p["shared_up"] = mk((d, sf), "fsdp ff")
        p["shared_down"] = mk((sf, d), "ff fsdp")
        if gated:
            p["shared_gate"] = mk((d, sf), "fsdp ff")
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    m = cfg.moe
    c = max(1, int(math.ceil(tokens * m.top_k * m.capacity_factor /
                             m.num_experts)))
    return min(c, tokens)


def apply_moe(p: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss), the Switch-style load-balancing
    loss as a 0-d f32 tensor."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    cap = capacity(cfg, T)
    gated = cfg.mlp.startswith("gated")
    act = F.silu if cfg.mlp == "gated_silu" else _gelu
    dev = x.device

    h = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, d)
    logits = (h @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)                         # (T, E)

    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :K], idx[:, :K]                   # (T, K)
    gates = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)

    e_flat = top_idx.reshape(-1)                                  # (T*K,)
    ones = torch.ones(T * K, dtype=torch.float32, device=dev)
    sel_frac = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, e_flat, ones) / (T * K)
    aux = E * torch.sum(sel_frac * probs.mean(0)) * m.router_aux_weight

    # ---- sort-based slot assignment ----
    t_flat = torch.arange(T * K, device=dev) // K
    g_flat = gates.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    t_sort = t_flat[order]
    g_sort = g_flat[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, 0) - counts                  # (E,)
    rank = torch.arange(T * K, device=dev) - seg_start[e_sort]
    keep = rank < cap
    slot = torch.where(keep, e_sort * cap + rank,
                       torch.full_like(rank, E * cap))

    # scatter tokens into the expert buffer; dropped tokens land in the
    # trash row E*cap, which nothing reads
    buf = torch.zeros((E * cap + 1, d), dtype=h.dtype, device=dev)
    buf[slot] = h[t_sort]
    xin = buf[:E * cap].reshape(E, cap, d)
    if gated:
        hid = act(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    else:
        hid = act(torch.bmm(xin, p["w_up"]))
    flat = torch.bmm(hid, p["w_down"]).reshape(E * cap, d)

    contrib = torch.where(keep[:, None], flat[torch.where(keep, slot, 0)],
                          torch.zeros((), dtype=flat.dtype, device=dev))
    contrib = contrib * (g_sort * keep.float())[:, None].to(flat.dtype)
    # combine: token t's contributions sit at the sorted positions of its
    # K (token, expert) pairs; in ascending position, i.e. expert order,
    # they are added one after another
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    pos = torch.sort(pos.reshape(T, K), dim=-1).values            # (T, K)
    y = torch.zeros((T, d), dtype=flat.dtype, device=dev)
    for k in range(K):
        y = y + contrib[pos[:, k]]

    if m.num_shared:
        if gated:
            sh = act(h @ p["shared_gate"]) * (h @ p["shared_up"])
        else:
            sh = act(h @ p["shared_up"])
        y = y + sh @ p["shared_down"]
    return x + y.reshape(B, S, d), aux
