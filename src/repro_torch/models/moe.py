"""Mixture-of-Experts block (deepseek-v2 / kimi-k2 style).

The PyTorch counterpart of ``repro/models/moe.py``: the reference's
sort-based dispatch through an (E*C, d) expert buffer with a capacity of
C = min(T, ceil(T*K*cf / E)) tokens per expert; tokens past an expert's
capacity drop through the residual.

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

Under a mesh (DTensor activations and params) the sort, scatter and
gather of the dispatch have no DTensor sharding rule, so they run inside
``local_map`` regions, the counterparts of the reference's ``shard_map``:

  * ``"shardmap"`` (``_shardmap_moe``): the expert-parallel path.  Each
    rank holds its data shard's tokens (replicated over ``model``) and its
    ``model`` rank's experts, serves the tokens routed to them
    (``_local_expert_ffn``), and returns its partial sum as a
    ``Partial`` placement over ``model``: the one all-reduce over the
    model sub-group is that placement's reduction;
  * ``"gspmd"`` (``_dense_on_mesh``): the same dispatch as on one
    device, its token buffers replicated (GSPMD's fallback for a scatter /
    gather with computed indices, which the reference's docstring
    records) and its expert products on each rank's own experts, as the
    reference's ``experts`` constraints on the buffer keep them.
  * ``"auto"`` takes the expert-parallel path when ``_can_shardmap``
    allows it and at least one routed token falls to each expert.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (current_mesh, is_dtensor,
                                              mesh_shape, shard)
from repro_torch.models.layers import Maker, Params, _gelu, rmsnorm

# MoE execution strategy, the reference's knob: "auto" picks the
# expert-parallel path whenever a mesh with a dividing "model" axis is
# active; "gspmd" forces the baseline; "shardmap" takes the
# expert-parallel path wherever a mesh allows it (with no mesh: gspmd).
_MOE_IMPL = "auto"


def set_moe_impl(impl: str) -> None:
    global _MOE_IMPL
    assert impl in ("auto", "gspmd", "shardmap"), impl
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


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int, K: int
             ) -> torch.Tensor:
    """(T, d) sums of the (T*K, d) sorted contributions: token t's sit at
    the sorted positions of its K (token, expert) pairs; in ascending
    position, i.e. expert order, they are added one after another."""
    dev = contrib.device
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    pos = torch.sort(pos.reshape(T, K), dim=-1).values            # (T, K)
    y = torch.zeros((T, contrib.shape[1]), dtype=contrib.dtype, device=dev)
    for k in range(K):
        y = y + contrib[pos[:, k]]
    return y


def _slots(top_idx: torch.Tensor, n_experts: int, capacity: int):
    """The sort-based slot assignment of (T, K) expert ids over all
    ``n_experts`` experts: the stable sort ``order`` of the (T*K,)
    (token, expert) pairs by expert, each sorted pair's token, whether it
    keeps a slot, and its row of the (E*C + 1, d) expert buffer (the
    trash row E*C for a dropped pair)."""
    T, K = top_idx.shape
    E, cap, dev = n_experts, capacity, top_idx.device
    e_flat = top_idx.reshape(-1)                                  # (T*K,)
    t_flat = torch.arange(T * K, device=dev) // K
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, 0) - counts                  # (E,)
    rank = torch.arange(T * K, device=dev) - seg_start[e_sort]
    keep = rank < cap
    slot = torch.where(keep, e_sort * cap + rank,
                       torch.full_like(rank, E * cap))
    return order, t_flat[order], keep, slot


def _expert_buffer(h, t_sort, slot, n_experts: int, capacity: int
                   ) -> torch.Tensor:
    """The (E, C, d) expert buffer: each kept (token, expert) pair's token
    in its slot (``_slots``), zeros elsewhere; dropped tokens land in the
    trash row E*C, which nothing reads."""
    E, cap, d = n_experts, capacity, h.shape[1]
    buf = torch.zeros((E * cap + 1, d), dtype=h.dtype, device=h.device)
    buf[slot] = h[t_sort]
    return buf[:E * cap].reshape(E, cap, d)


def _experts(xin, w_gate, w_up, w_down, *, act, gated: bool
             ) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): each expert's FFN on its own slots, as
    batched products (``w_gate`` unread when not ``gated``)."""
    if gated:
        hid = act(torch.bmm(xin, w_gate)) * torch.bmm(xin, w_up)
    else:
        hid = act(torch.bmm(xin, w_up))
    return torch.bmm(hid, w_down)


def _combined(xout, gates, order, keep, slot) -> torch.Tensor:
    """The (T, d) gate-weighted sums of each token's kept expert outputs
    from the (E, C, d) buffer ``xout`` (``_slots``' sort, keep mask and
    rows; ``gates`` (T, K))."""
    T, K = gates.shape
    E, cap, d = xout.shape
    flat = xout.reshape(E * cap, d)
    g_sort = gates.reshape(-1)[order]
    contrib = torch.where(keep[:, None], flat[torch.where(keep, slot, 0)],
                          torch.zeros((), dtype=flat.dtype,
                                      device=flat.device))
    contrib = contrib * (g_sort * keep.float())[:, None].to(flat.dtype)
    return _combine(contrib, order, T, K)


def _dispatch(h, top_idx, gates, w_gate, w_up, w_down, *, n_experts: int,
              capacity: int, act, gated: bool) -> torch.Tensor:
    """The sort-based dispatch over all ``n_experts`` experts: (T, d)
    tokens, their (T, K) experts and gates -> the (T, d) combined expert
    output (``w_gate`` unread when not ``gated``)."""
    order, t_sort, keep, slot = _slots(top_idx, n_experts, capacity)
    xin = _expert_buffer(h, t_sort, slot, n_experts, capacity)
    xout = _experts(xin, w_gate, w_up, w_down, act=act, gated=gated)
    return _combined(xout, gates, order, keep, slot)


def _dense_on_mesh(h, top_idx, gates, w_gate, w_up, w_down, *,
                   n_experts: int, capacity: int, act, gated: bool
                   ) -> torch.Tensor:
    """``_dispatch`` on DTensors, partitioned as the reference's dense
    path is: only the token side is replicated.  The expert buffer is
    filled in a replicated region, constrained to ``experts`` (a local
    slice), and the products run on each rank's own experts in a region
    over the weights' expert placements (their ``fsdp`` pieces gathered,
    as the expert-parallel path does); a last replicated region gathers
    the (E, C, d) output buffer and combines it.  No expert weight
    crosses the ``model`` axis.  Each replicated region sorts the routed
    pairs itself (``_slots``), so only tensors cross the regions."""
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh

    def fill(hh, ti):
        _, t_sort, _, slot = _slots(ti, n_experts, capacity)
        return _expert_buffer(hh, t_sort, slot, n_experts, capacity)

    def combine(xo, ti, g):
        order, _, keep, slot = _slots(ti, n_experts, capacity)
        return _combined(xo, g, order, keep, slot)
    xin = _replicated(fill, mesh, 2)(h, top_idx)
    xin = shard(xin, "experts", None, None)
    ex = list(xin.placements)
    xout = local_map(
        lambda x, wg, wu, wd: _experts(x, wg, wu, wd, act=act, gated=gated),
        out_placements=ex, in_placements=(ex,) * 4, device_mesh=mesh,
        redistribute_inputs=True)(xin, w_gate, w_up, w_down)
    return _replicated(combine, mesh, 3)(xout, top_idx, gates)


def _local_expert_ffn(h, top_idx, gates, w_gate, w_up, w_down, *, rank: int,
                      top_k: int, capacity: int, act, gated: bool
                      ) -> torch.Tensor:
    """Per-rank body of the expert-parallel path (the reference's
    ``_local_expert_ffn``).

    ``h`` (T_loc, d) is this data shard's tokens, replicated across the
    ``model`` axis; w_* are the LOCAL expert slices (E_loc, d, f) of model
    rank ``rank``.  Each rank serves the tokens routed to its own experts
    (tokens need no exchange: they are already resident) and returns its
    partial (T_loc, d) output; the sum over the ``model`` ranks (the
    reference's ``psum``) is the caller's one all-reduce.
    """
    T, d = h.shape
    E_loc = w_up.shape[0]
    dev = h.device
    lo = rank * E_loc
    K = top_k

    e_flat = top_idx.reshape(-1).long()           # (T*K,) global expert ids
    g_flat = gates.reshape(-1)
    t_flat = torch.arange(T * K, device=dev) // K
    e_local = e_flat - lo
    mine = (e_local >= 0) & (e_local < E_loc)
    e_key = torch.where(mine, e_local, torch.full_like(e_local, E_loc))
    order = torch.argsort(e_key, stable=True)     # foreign tokens sort last
    e_sort = e_key[order]
    t_sort = t_flat[order]
    g_sort = g_flat[order]
    counts = torch.zeros(E_loc + 1, dtype=torch.int64, device=dev
                         ).scatter_add_(0, e_key, torch.ones_like(e_key))
    seg_start = torch.cumsum(counts, 0) - counts
    rank_in_e = torch.arange(T * K, device=dev) - seg_start[e_sort]
    keep = (e_sort < E_loc) & (rank_in_e < capacity)
    slot = torch.where(keep, e_sort * capacity + rank_in_e,
                       torch.full_like(rank_in_e, E_loc * capacity))

    buf = torch.zeros((E_loc * capacity + 1, d), dtype=h.dtype, device=dev)
    buf[slot] = h[t_sort]
    xin = buf[:E_loc * capacity].reshape(E_loc, capacity, d)
    xout = _experts(xin, w_gate, w_up, w_down, act=act, gated=gated
                    ).reshape(E_loc * capacity, d)
    xout = torch.cat([xout, torch.zeros((1, d), dtype=xout.dtype,
                                        device=dev)], dim=0)
    contrib = xout[slot] * (g_sort * keep.float())[:, None].to(xout.dtype)
    return _combine(contrib, order, T, K)


def _batch_axes(sizes) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _placements(mesh, shard_of):
    """Placements (a list: ``local_map`` reads a tuple as one placement
    list per output) on ``mesh`` with ``Shard(d)`` on the mesh axes that
    ``shard_of`` maps to ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(shard_of[a]) if a in shard_of else Replicate()
            for a in mesh.mesh_dim_names]


def _shardmap_moe(p, h, cfg, act, gated, top_idx, gates, mesh):
    """The expert-parallel path as a ``local_map`` region: tokens sharded
    over the batch axes and replicated over ``model``, experts sharded
    over ``model``; out: the tokens' placements with ``Partial`` over
    ``model``, as are the gradients of the tokens and gates, and the
    experts' gradients ``Partial`` over the batch axes (the psums that
    ``shard_map``'s transpose makes for an input replicated over an
    axis)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    sizes = mesh_shape(mesh)
    T = h.shape[0]
    batch = _batch_axes(sizes)
    n_batch = math.prod(sizes[a] for a in batch)
    T_loc = T // n_batch
    E_loc = m.num_experts // sizes["model"]
    cap = max(1, min(
        int(math.ceil(T_loc * m.top_k * m.capacity_factor / m.num_experts)),
        T_loc))
    rank = mesh.get_local_rank("model")
    tok = _placements(mesh, {a: 0 for a in batch})
    # the output, and the gradient of an input replicated over "model",
    # are each rank's partial sum over its own experts
    summed = [Partial() if a == "model" else pl
              for a, pl in zip(mesh.mesh_dim_names, tok)]
    w = _placements(mesh, {"model": 0})
    # an expert's gradient is each data shard's partial sum over its own
    # tokens
    w_grad = [Partial() if a in batch else pl
              for a, pl in zip(mesh.mesh_dim_names, w)]
    body = local_map(
        lambda hh, ti, gg, wg, wu, wd: _local_expert_ffn(
            hh, ti, gg, wg, wu, wd, rank=rank, top_k=m.top_k, capacity=cap,
            act=act, gated=gated),
        out_placements=summed, in_placements=(tok, tok, tok, w, w, w),
        in_grad_placements=(summed, tok, summed, w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)
    wg = p["w_gate"] if gated else p["w_up"]
    return body(h, top_idx, gates, wg, p["w_up"], p["w_down"])


def _can_shardmap(cfg, T: int) -> bool:
    mesh = current_mesh()
    if _MOE_IMPL == "gspmd" or mesh is None:
        return False
    sizes = mesh_shape(mesh)
    if "model" not in sizes:
        return False
    m = cfg.moe
    if m.num_experts % sizes["model"]:
        return False
    if T % math.prod(sizes[a] for a in _batch_axes(sizes)):
        return False
    # below ~1 routed token per expert the dispatch overhead of the
    # expert-parallel path exceeds its win: decode-sized token counts stay
    # on the dense path under "auto" (the reference's threshold)
    if _MOE_IMPL == "auto" and T * m.top_k < m.num_experts:
        return False
    return True


def _replicated(fn, mesh, n_in: int):
    """``fn`` as a ``local_map`` region on replicated inputs and output."""
    from torch.distributed.tensor.experimental import local_map
    rep = _placements(mesh, {})
    return local_map(fn, out_placements=rep, in_placements=(rep,) * n_in,
                     device_mesh=mesh, redistribute_inputs=True)


def _top_k(probs: torch.Tensor, K: int):
    """The first K of a stable descending sort of each row: (values,
    indices).  Under a mesh each rank sorts its own rows in a
    ``local_map`` region: DTensor's sort backward (torch 2.11) scatters
    the DTensor gradient into a plain tensor of zeros and fails."""
    def top(pr):
        vals, idx = torch.sort(pr, dim=-1, descending=True, stable=True)
        return vals[:, :K], idx[:, :K]
    if not is_dtensor(probs):
        return top(probs)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    rows = [p if p == Shard(0) else Replicate() for p in probs.placements]
    return local_map(top, out_placements=(rows, rows), in_placements=(rows,),
                     device_mesh=probs.device_mesh,
                     redistribute_inputs=True)(probs)


def _expert_fraction(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) share of the routed (token, expert) pairs each expert got."""
    def frac(e):
        ones = torch.ones(e.shape[0], dtype=torch.float32, device=e.device)
        return torch.zeros(E, dtype=torch.float32, device=e.device
                           ).scatter_add_(0, e, ones) / e.shape[0]
    if is_dtensor(e_flat):
        return _replicated(frac, e_flat.device_mesh, 1)(e_flat)
    return frac(e_flat)


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

    h = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, d)
    logits = (h @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)                         # (T, E)

    top_vals, top_idx = _top_k(probs, K)                          # (T, K)
    gates = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)

    e_flat = top_idx.reshape(-1)                                  # (T*K,)
    aux = E * torch.sum(_expert_fraction(e_flat, E) * probs.mean(0)) * \
        m.router_aux_weight

    wg = p["w_gate"] if gated else p["w_up"]
    if _MOE_IMPL in ("auto", "shardmap") and _can_shardmap(cfg, T):
        y = _shardmap_moe(p, h, cfg, act, gated, top_idx, gates.float(),
                          current_mesh())
    elif is_dtensor(h):
        y = _dense_on_mesh(h, top_idx, gates, wg, p["w_up"], p["w_down"],
                           n_experts=E, capacity=cap, act=act, gated=gated)
    else:
        y = _dispatch(h, top_idx, gates, wg, p["w_up"], p["w_down"],
                      n_experts=E, capacity=cap, act=act, gated=gated)

    if m.num_shared:
        if gated:
            sh = act(h @ p["shared_gate"]) * (h @ p["shared_up"])
        else:
            sh = act(h @ p["shared_up"])
        y = y + sh @ p["shared_down"]
    return x + shard(y.reshape(B, S, d), "batch", None, None), aux
