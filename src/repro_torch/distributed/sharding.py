"""Logical-axis sharding: DP/FSDP/TP/EP/SP on a device mesh.

The PyTorch counterpart of ``repro/distributed/sharding.py``.  Tensors
(params and activations) are annotated with *logical* axis names; rules
map logical names to mesh axes.  The resolver enforces divisibility: a
mesh axis that does not divide the tensor dimension is dropped (e.g. 10
attention heads on a 16-way ``model`` axis stay replicated while d_ff
still shards).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
the reference's axis names (``data``, ``model``; ``pod`` on the 2-pod
mesh).  ``_resolve_axis`` and ``pspec_for`` are pure Python over the
mesh's axis sizes (a ``DeviceMesh``, a {name: size} mapping, or any
object with such a ``.shape``) and return the reference's partition spec
as a tuple: per tensor dim ``None``, one mesh axis name, or a tuple of
names, trailing ``None`` dropped.  A ``Sharding`` (``sharding_for``) is
that spec as DTensor placements on the mesh: a tensor dim mapped to
several mesh axes is one ``Shard(d)`` on each of them, every other mesh
dim (and one of size 1) ``Replicate()``.

Logical axes used across the framework:
    batch      — global batch            -> ("pod", "data")
    kv_seq     — KV-cache sequence       -> sequence-sharding for long ctx
    heads      — attention query heads   -> "model" (Megatron TP)
    kv_heads   — KV heads                -> "model"
    ff         — MLP hidden              -> "model"
    vocab      — embedding/logits vocab  -> "model"
    experts    — MoE experts             -> "model" (expert parallelism)
    fsdp       — parameter dim for ZeRO-3-style sharding -> ("pod", "data")
    embed/None — replicated
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "kv_seq": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("pod", "data"),
    "embed": (),
    "seq": (),
}

_ctx = threading.local()


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_rules() -> Rules:
    return getattr(_ctx, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Rules] = None):
    """Activate a mesh + rule set for ``shard()`` constraints within."""
    prev = (getattr(_ctx, "mesh", None), getattr(_ctx, "rules", DEFAULT_RULES))
    _ctx.mesh = mesh
    _ctx.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or an object
    whose ``.shape`` is such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _resolve_axis(logical: Optional[str], dim: int, mesh, rules: Rules,
                  used: set) -> Optional[Union[str, Tuple[str, ...]]]:
    """Map one logical axis to mesh axes with divisibility fallback."""
    if logical is None or logical == "":
        return None
    mesh_axes = rules.get(logical)
    if mesh_axes is None:
        return None
    sizes = mesh_shape(mesh)
    mesh_axes = tuple(a for a in mesh_axes if a in sizes and a not in used)
    # greedy prefix: keep the longest prefix whose product divides dim
    while mesh_axes:
        prod = 1
        for a in mesh_axes:
            prod *= sizes[a]
        if prod and dim % prod == 0:
            break
        mesh_axes = mesh_axes[:-1]
    if not mesh_axes:
        return None
    used.update(mesh_axes)
    return mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]


def pspec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
              rules: Optional[Rules] = None) -> Spec:
    rules = dict(DEFAULT_RULES, **(rules or {}))
    used: set = set()
    parts = [_resolve_axis(a, d, mesh, rules, used)
             for a, d in zip(axes, shape)]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def parse_axes(axes: Union[str, Sequence[Optional[str]]]):
    """"fsdp ff" -> ("fsdp", "ff"); "-" entries mean replicated."""
    if isinstance(axes, str):
        return tuple(None if a in ("-", "_") else a for a in axes.split())
    return tuple(axes)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_for(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  A
    mesh dim of size 1 is ``Replicate()`` whatever the spec says: its one
    rank holds the whole tensor dim either way, and DTensor (torch 2.11)
    refuses to flatten a dim sharded over it inside einsum's views."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {a: d for d, entry in enumerate(spec) for a in spec_axes(entry)}
    return tuple(Shard(dim_of[a]) if a in dim_of and mesh.size(i) > 1
                 else Replicate()
                 for i, a in enumerate(mesh.mesh_dim_names))


class Sharding(NamedTuple):
    """The counterpart of a ``NamedSharding``: the mesh, the partition
    spec, and the spec as DTensor placements."""
    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]

    def shards(self) -> int:
        """How many pieces the tensor is cut into."""
        sizes = mesh_shape(self.mesh)
        n = 1
        for entry in self.spec:
            for a in spec_axes(entry):
                n *= sizes[a]
        return n


def sharding_for(axes: Union[str, Sequence[Optional[str]]],
                 shape: Sequence[int], mesh,
                 rules: Optional[Rules] = None) -> Sharding:
    ax = parse_axes(axes)
    if len(ax) != len(shape):
        raise ValueError(f"axes {ax} rank != shape {tuple(shape)}")
    spec = pspec_for(ax, shape, mesh, rules)
    return Sharding(mesh, spec, placements_for(spec, mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain an activation's sharding under the active mesh: the
    counterpart of ``with_sharding_constraint``.  The identity with no
    mesh active or on a plain tensor (one device, the decode fast path);
    otherwise a ``redistribute`` to the spec's placements (which also
    reduces a ``Partial`` operand)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = pspec_for(axes, x.shape, mesh, current_rules())
    want = placements_for(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def placed_grad(mesh, placements, grad: torch.Tensor) -> torch.Tensor:
    """``grad`` redistributed to ``placements`` on ``mesh``, those of the
    tensor it is the gradient of: a ``Partial`` gradient is reduced (a
    reduce-scatter where the tensor is sharded).  A plain tensor, or one
    placed so already, as it is."""
    if not is_dtensor(grad) or tuple(grad.placements) == tuple(placements):
        return grad
    return grad.redistribute(mesh, placements)


class _PlacedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return placed_grad(ctx.mesh, ctx.placements, g)


def reduced_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient placed as ``x`` is (``placed_grad``) as soon as
    the backward makes it, before it flows on: a ``Partial`` gradient,
    whole-size on every rank, is reduced then and not where its stack or
    its sum is formed.  ``x`` itself unless it is a DTensor that takes a
    gradient."""
    if not (is_dtensor(x) and x.requires_grad and torch.is_grad_enabled()):
        return x
    return _PlacedGrad.apply(x)


def _view(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``, a DTensor first redistributed where DTensor
    cannot view it: a sharded dim that the reshape splits keeps its
    shards only if the first dim it splits into divides by them (28 heads
    on a 16-way ``model`` axis do not), and a sharded dim merged into the
    one before it is replicated, as the reference's GSPMD reshards
    there."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    old, new = tuple(x.shape), tuple(shape)
    first = next((d for d, (a, b) in enumerate(zip(old, new)) if a != b),
                 None)
    if first is None:
        return x.reshape(new)
    mesh, pl = x.device_mesh, list(x.placements)
    if len(new) > len(old):                     # a split at ``first``
        n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                      if isinstance(p, Shard) and p.dim == first)
        bad = {first} if new[first] % n else set()
    else:                                       # a merge into ``first``
        size, last = old[first], first
        while size != new[first] and last + 1 < len(old):
            last += 1
            size *= old[last]
        bad = set(range(first + 1, last + 1))
    if any(isinstance(p, Shard) and p.dim in bad for p in pl):
        pl = [Replicate() if isinstance(p, Shard) and p.dim in bad else p
              for p in pl]
        x = x.redistribute(mesh, pl)
    return x.reshape(new)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _view(g, ctx.shape), None


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)`` that also works where DTensor cannot view a
    sharded dim split unevenly, in the forward or in the backward (a
    merge whose gradient comes back sharded over the merged dim): such a
    tensor is first redistributed (``_view``).  A plain reshape on plain
    tensors."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


def shard_heads(x: torch.Tensor, shape: Sequence[int],
                *axes: Optional[str]) -> torch.Tensor:
    """``shard(reshape(x, shape), *axes)`` where the reshape splits
    ``x``'s last dim into the last two of ``shape`` (H * hd -> H, hd).
    Under a mesh ``x`` is first redistributed to the layout the
    constraint asks for, its last dim carrying the outer split dim's
    sharding, so no dim is gathered only to be cut again (a third of the
    bytes of the dry run of qwen2-7b train_4k)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x.reshape(shape)
    spec = pspec_for(axes, shape, mesh, current_rules())
    spec = spec + (None,) * (len(shape) - len(spec))
    flat = placements_for(spec[:-1], mesh)
    if tuple(x.placements) != flat:
        x = x.redistribute(mesh, flat)
    return shard(reshape(x, shape), *axes)


def _is_leaf(x) -> bool:
    return isinstance(x, str)


def tree_map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over an axes tree (string leaves) and trees of
    the same structure: dicts by key, NamedTuples and tuples by
    position."""
    if _is_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple):
        kids = [tree_map_axes(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(axes_tree)]
        return (type(axes_tree)(*kids) if hasattr(axes_tree, "_fields")
                else tuple(kids))
    raise TypeError(f"axes tree node {type(axes_tree).__name__}")


def tree_shardings(axes_tree, shape_tree, mesh,
                   rules: Optional[Rules] = None):
    """Zip an axes tree (string leaves) with a tree of tensors (meta
    tensors included) into a ``Sharding`` tree (for placing a train state
    or a checkpoint's leaves)."""
    return tree_map_axes(
        lambda ax, t: sharding_for(ax, t.shape, mesh, rules),
        axes_tree, shape_tree)


def map_shardings(fn, shardings, tree):
    """``fn(sharding, leaf)`` over a ``Sharding`` tree and a tree of the
    same structure (dicts by key, NamedTuples and tuples by position); a
    leaf whose sharding is None is kept as it is."""
    if isinstance(shardings, Sharding):
        return fn(shardings, tree)
    if shardings is None:
        return tree
    if isinstance(shardings, dict):
        return {k: map_shardings(fn, v, tree[k])
                for k, v in shardings.items()}
    kids = [map_shardings(fn, s, tree[i]) for i, s in enumerate(shardings)]
    return (type(shardings)(*kids) if hasattr(shardings, "_fields")
            else tuple(kids))


def distribute(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor with
    ``sharding``'s placements: each rank keeps its own piece, with no
    communication.  A piece that is a view of a larger storage (cut along
    the leading dim only, as a vocab-sharded embedding table is) is
    copied, or it would keep the whole tensor alive on every rank."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = distribute_tensor(x, sharding.mesh, sharding.placements,
                          src_data_rank=None)
    local = t.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        with torch.no_grad():
            t = DTensor.from_local(local.clone(), sharding.mesh,
                                   sharding.placements, run_check=False,
                                   shape=t.shape, stride=t.stride())
        t.requires_grad_(x.requires_grad)
    return t


def place(tree, axes, mesh, rules: Optional[Rules] = None):
    """``tree`` (nested dicts) with each plain tensor a DTensor on ``mesh``
    placed by its logical axes, the string leaf of ``axes`` at the same
    key (``Model.param_axes``, ``Model.cache_axes``), under ``rules``:
    each rank keeps its own piece (``distribute``).  A DTensor is kept as
    it is (it must lie on ``mesh``), and so is a leaf that is not a
    tensor (a cache's host counters)."""
    if isinstance(tree, dict):
        return {k: place(v, axes[k], mesh, rules) for k, v in tree.items()}
    if is_dtensor(tree):
        if tree.device_mesh != mesh:
            raise ValueError(f"a DTensor on mesh {tree.device_mesh}, not on "
                             f"the active {mesh}")
        return tree
    if not torch.is_tensor(tree):
        return tree
    return distribute(tree, sharding_for(axes, tree.shape, mesh, rules))


def _rows_here(x: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(first, count): the span of ``x``'s dim ``dim`` that this rank
    holds of DTensor ``x`` (a dim sharded evenly over one or more mesh
    dims, as the resolver places it, or whole)."""
    from torch.distributed.tensor import Shard
    mesh, first, count = x.device_mesh, 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            if count % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split evenly over {n} ranks")
            count //= n
            first += mesh.get_local_rank(i) * count
    return first, count


def copy_row(dst: torch.Tensor, dim: int, d: int, src: torch.Tensor,
             s: int) -> None:
    """``dst.select(dim, d).copy_(src.select(dim, s))`` in place, where
    ``dst`` may be a DTensor: each rank copies only its own piece of the
    row (none where another rank holds row ``d``), from ``src`` placed as
    ``dst`` is on every other dim (``src`` is redistributed so first, its
    dim ``dim`` whole: a gather only where it was sharded).  A DTensor's
    ``select`` of a sharded dim would copy the row out of the tensor, and
    a write into it would be lost."""
    if not is_dtensor(dst):
        dst.select(dim, d).copy_(full(src).select(dim, s))
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in dst.placements]
    if not is_dtensor(src):
        src = distribute(src, Sharding(mesh, (), tuple(want)))
    elif list(src.placements) != want:
        src = src.redistribute(mesh, want)
    first, count = _rows_here(dst, dim)
    if first <= d < first + count:
        dst.to_local().select(dim, d - first).copy_(
            src.to_local().select(dim, s))


@contextlib.contextmanager
def replicate_plain(x):
    """A context in which, when ``x`` is a DTensor, plain tensors that meet
    DTensors in an op count as replicated (``implicit_replication``): the
    model's positions, masks and constants, which the reference's jit
    treats alike.  Re-entrant (``implicit_replication`` itself turns the
    mode off on every exit); a null context when ``x`` is plain."""
    depth = getattr(_ctx, "implicit", 0)
    if depth or not is_dtensor(x):
        _ctx.implicit = depth + (1 if depth else 0)
        try:
            yield
        finally:
            _ctx.implicit = depth
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _ctx.implicit = 1
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.implicit = 0


def in_context(fn):
    """``fn`` run, from whichever thread calls it, under the mesh and
    rules active where ``in_context`` is called.  This module's state is
    thread-local, and the autograd engine runs a CUDA backward on its
    device thread: there a checkpointed group's recompute (``remat``)
    would otherwise see no mesh, skip every ``shard`` constraint and
    differ from its forward.  (DTensor's implicit-replication flag, which
    ``replicate_plain`` sets, is torch's own and reaches that thread.)"""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with axis_rules(mesh, rules):
            return fn(*args, **kwargs)
    return run


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (gathered), a plain tensor as is."""
    return x.full_tensor() if is_dtensor(x) else x


def group_size() -> int:
    """The ranks of this process's group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1
