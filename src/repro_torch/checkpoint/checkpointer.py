"""Step-atomic checkpointing, numpy-backed.

The PyTorch counterpart of ``repro/checkpoint/checkpointer.py``, with the
same on-disk format, so that a checkpoint written by either package
restores in the other:

  * ``step_%08d/`` written as ``step_%08d.tmp/`` and committed with
    ``os.rename``: a crash mid-write never corrupts the latest checkpoint;
  * ``arrays.npz`` holds the leaves as ``a0``, ``a1``, ... and
    ``manifest.json`` maps each leaf's ``/``-joined key to its id, shape
    and dtype (``params/scan/pos0/attn/wq``, ``opt/m/...``, ``opt/step``,
    ``rng``): dict keys in sorted order, NamedTuple fields by name, tuple
    items by index, the order of ``jax.tree_util``'s paths;
  * bfloat16 leaves are stored as their raw 16-bit words (numpy has no
    bfloat16) under the manifest dtype ``bfloat16``;
  * GC keeps the last ``keep`` steps, the oldest removed only after the
    newest commit.

The pipeline is stateless, so the step counter in the manifest is the
only data state.

On one process, or a group of one rank, a DTensor leaf (a (1, 1) mesh)
is saved whole in that format.  On a group of more than one rank (a
train state on a mesh under ``torchrun``) each rank writes only its own
pieces, as the reference's multi-host writer does (its docstring: "each
host writes only its addressable shards"); no rank gathers a leaf:

  * every rank writes into ``step_%08d.tmp/``: for each DTensor leaf the
    piece it holds (``to_local()``), as ``<id>.<rank>.npy``, unless
    another rank holds the same piece (replicated over a mesh axis): a
    piece is written by the rank at coordinate 0 of every mesh axis it
    is replicated over; a plain leaf (``opt/step``, ``rng``) by rank 0;
  * ``manifest.json`` keeps the same ``index`` (id, logical shape,
    dtype) and adds to each leaf ``pieces``: ``{"file", "offset",
    "shape"}`` of every piece written, in the leaf's coordinates;
  * after a barrier rank 0 writes the manifest, commits with the same
    ``os.rename`` and runs GC; a crash mid-write leaves only a ``.tmp``.
    The ranks share one file system.

``restore`` reads either layout onto any mesh or none: each leaf's
region that the caller needs (a DTensor target's own piece, the piece a
``Sharding`` gives this rank, or the whole leaf) is assembled from the
saved pieces that overlap it, each read memory-mapped, only its overlap
copied.  So a rank reads about its share, and one process without a
group reads a pieces checkpoint whole; saving that again writes the
reference's one-file format (the route from a mesh's checkpoint to the
reference).  ``io`` holds the bytes, seconds and peak resident host
memory growth of this process's last ``save`` and ``restore``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (Sharding, full, group_size,
                                               is_dtensor)

SEP = "/"


def _items(tree, prefix=()):
    """(path, child) of a dict (sorted keys), NamedTuple (fields) or
    tuple / list (indices)."""
    if isinstance(tree, dict):
        return [(prefix + (str(k),), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(prefix + (f,), getattr(tree, f)) for f in tree._fields]
    return [(prefix + (str(i),), x) for i, x in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, tuple, list))


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    out = []
    for path, child in _items(tree, prefix):
        if _is_node(child):
            out += _flatten(child, path)
        elif child is not None:
            out.append((SEP.join(path), child))
    return out


def _rebuild(tree, leaf_of, prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaf_of(key,
    leaf)``."""
    if not _is_node(tree):
        return leaf_of(SEP.join(prefix), tree)
    kids = [_rebuild(child, leaf_of, path) if child is not None else None
            for path, child in _items(tree, prefix)]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), kids))
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf on the host as numpy, and its manifest dtype; a DTensor
    whole (``full``: the one-file layout only)."""
    if torch.is_tensor(leaf):
        t = full(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A saved array (bf16 as its 16-bit words) as a CPU tensor of its
    manifest dtype, sharing ``arr``'s memory where it can."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")       # a copy, 0-d kept
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


io: Dict[str, Dict[str, float]] = {}


class _Meter:
    """Records into ``io[what]`` the bytes this process moved (``add``),
    the seconds it took and the growth of its peak resident memory."""

    def __init__(self, what: str):
        self.what, self.bytes = what, 0

    def add(self, nbytes: int) -> None:
        self.bytes += int(nbytes)

    def __enter__(self):
        self.rss0, self.t0 = _peak_rss(), time.perf_counter()
        return self

    def __exit__(self, *exc):
        io[self.what] = {"bytes": self.bytes,
                         "seconds": time.perf_counter() - self.t0,
                         "peak_rss_growth": _peak_rss() - self.rss0}


def _peak_rss() -> int:
    """This process's peak resident memory so far, bytes (Linux counts
    ``ru_maxrss`` in KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Commit ``tree`` as ``step_%08d`` under ``directory``: every rank
    of a group calls it; on more than one rank each writes its own
    pieces (``_save_pieces``), else the one process writes
    ``arrays.npz``."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    with _Meter("save") as meter:
        if group_size() > 1:
            _save_pieces(directory, final, tmp, step, tree, extra, keep,
                         meter)
        else:
            _save_arrays(directory, final, tmp, step, tree, extra, keep,
                         meter)
    return final


def _save_arrays(directory, final, tmp, step, tree, extra, keep, meter):
    _fresh(directory, tmp)
    index = {}
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{len(index)}"] = arr
        index[key] = {"id": f"a{len(index)}", "shape": list(arr.shape),
                      "dtype": dtype}
        meter.add(arr.nbytes)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    _commit(directory, final, tmp, step, index, extra, keep)


def _save_pieces(directory, final, tmp, step, tree, extra, keep, meter):
    rank = dist.get_rank()
    if rank == 0:
        _fresh(directory, tmp)
    dist.barrier()
    index, mine = {}, {}
    for key, leaf in _flatten(tree):
        ident = f"a{len(index)}"
        shape = tuple(leaf.shape)
        if is_dtensor(leaf):
            local = leaf.to_local()
            offset, size = _piece_of(shape, leaf.device_mesh,
                                     leaf.placements)
            if tuple(local.shape) != size:
                raise ValueError(f"{key}: a piece of shape "
                                 f"{tuple(local.shape)} where its "
                                 f"placements {leaf.placements} give {size}")
            owner = _owner(leaf.device_mesh, leaf.placements)
        else:
            local, offset, owner = leaf, (0,) * len(shape), rank == 0
        arr, dtype = (_to_numpy(local) if owner
                      else (None, _dtype_name(local)))
        index[key] = {"id": ident, "shape": list(shape), "dtype": dtype}
        if arr is not None and arr.size:
            name = f"{ident}.{rank}.npy"
            np.save(os.path.join(tmp, name), arr)
            meter.add(arr.nbytes)
            mine[key] = {"file": name, "offset": list(offset),
                         "shape": list(arr.shape)}
        del arr
    with open(os.path.join(tmp, f"pieces.{rank}.json"), "w") as f:
        json.dump(mine, f)
    dist.barrier()
    if rank == 0:
        for meta in index.values():
            meta["pieces"] = []
        for r in range(dist.get_world_size()):
            name = os.path.join(tmp, f"pieces.{r}.json")
            with open(name) as f:
                for key, piece in json.load(f).items():
                    index[key]["pieces"].append(piece)
            os.remove(name)
        _commit(directory, final, tmp, step, index, extra, keep)
    dist.barrier()


def _fresh(directory: str, tmp: str) -> None:
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)


def _commit(directory, final, tmp, step, index, extra, keep) -> None:
    manifest = {"step": step, "index": index, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)


def _dtype_name(t) -> str:
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=t.dtype).numpy().dtype)
    return str(np.asarray(t).dtype)


def _piece_of(shape, mesh, placements) -> Tuple[Tuple[int, ...],
                                                 Tuple[int, ...]]:
    """The offset and shape of this rank's piece of a tensor of
    ``shape`` placed by ``placements`` on ``mesh``: DTensor's split of
    each ``Shard(d)`` (``torch.chunk``'s: pieces of ceil(n / k), the last
    ones short or empty), mesh dims in order, each cutting the piece the
    ones before it left.  Another placement than ``Shard`` and
    ``Replicate`` raises."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the leaf's mesh")
    offset, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if type(p) is Shard:
            d, n = p.dim % len(shape), mesh.size(i)
            chunk = -(-size[d] // n)
            lo = min(chunk * coord[i], size[d])
            offset[d] += lo
            size[d] = min(lo + chunk, size[d]) - lo
        elif not p.is_replicate():
            raise ValueError(f"cannot write a piece placed {p}")
    return tuple(offset), tuple(size)


def _owner(mesh, placements) -> bool:
    """Whether this rank writes its piece: the one at coordinate 0 of
    every mesh dim the piece is replicated over."""
    coord = mesh.get_coordinate()
    return coord is not None and all(
        c == 0 for c, p in zip(coord, placements) if p.is_replicate())


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None, target=None,
            device: Any = "cpu", shardings=None) -> Tuple[Any, Dict]:
    """Restore a checkpoint (the latest without ``step``), of either
    layout.

    ``target``: optional tree (of tensors, meta tensors and DTensors
    included) giving the structure to restore into; each leaf comes back
    in the target leaf's dtype, written into the target's own tensor (so a
    restore holds one copy of the state, as the optimizer's in-place
    update; a DTensor gets its own piece, and only that piece is read),
    or for a meta leaf made on ``device``; a missing leaf or another
    shape raises.  Without it a nested dict of tensors on ``device`` is
    rebuilt from the flattened keys.  ``shardings``: a matching tree of
    ``Sharding``s (None where a leaf stays a plain tensor) for elastic
    placement: each such leaf comes back as a new DTensor on that
    sharding's mesh, whatever mesh the checkpoint was saved from, each
    rank reading only its own piece.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = manifest["index"]
    placed = _sharding_index(shardings)
    with _Meter("restore") as meter:
        reader = _Reader(path, meter)
        if target is not None:
            def leaf_of(key, leaf):
                if key not in index:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                want = tuple(leaf.shape)
                if tuple(index[key]["shape"]) != want:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{tuple(index[key]['shape'])} vs "
                                     f"{want}")
                return _restore_leaf(reader, key, index[key], leaf, device,
                                     placed.get(key))
            tree = _rebuild(target, leaf_of)
        else:
            tree = _unflatten_keys({
                key: _restore_leaf(reader, key, meta, None, device,
                                   placed.get(key))
                for key, meta in index.items()})
    return tree, manifest["extra"] | {"step": manifest["step"]}


def _restore_leaf(reader, key, meta, like, device, sharding):
    """One leaf: with a ``sharding`` a new DTensor of this rank's piece;
    into a DTensor ``like``, its own piece; else whole (into ``like``
    unless it is a meta tensor)."""
    shape = tuple(meta["shape"])
    if sharding is not None:
        from torch.distributed.tensor import DTensor
        offset, size = _piece_of(shape, sharding.mesh, sharding.placements)
        t = reader.region(key, meta, offset, size).to(
            device=sharding.mesh.device_type,
            dtype=None if like is None else like.dtype)
        return DTensor.from_local(
            t, sharding.mesh, sharding.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    if like is not None and is_dtensor(like):
        local = like.to_local()
        offset, size = _piece_of(shape, like.device_mesh, like.placements)
        with torch.no_grad():
            local.copy_(reader.region(key, meta, offset, size))
        return like
    t = reader.region(key, meta, (0,) * len(shape), shape)
    if like is None:
        return t.to(device)
    if like.device.type == "meta":
        return t.to(device=device, dtype=like.dtype)
    with torch.no_grad():
        return like.copy_(t)


class _Reader:
    """A checkpoint's leaves by region: from ``arrays.npz`` (a leaf whole,
    then cut) or from the pieces that overlap the region (each
    memory-mapped, only its overlap read; a piece that is the region
    read whole)."""

    def __init__(self, path: str, meter: _Meter):
        self.path, self.meter = path, meter
        npz = os.path.join(path, "arrays.npz")
        self.npz = np.load(npz) if os.path.exists(npz) else None

    def region(self, key, meta, offset, size) -> torch.Tensor:
        """The leaf's block at ``offset`` of ``size``, a CPU tensor of its
        saved dtype."""
        dtype = meta["dtype"]
        whole = tuple(meta["shape"])
        block = tuple(slice(o, o + n) for o, n in zip(offset, size))
        if "pieces" not in meta:
            arr = self.npz[meta["id"]]
            self.meter.add(arr.nbytes)
            return _to_tensor(arr if tuple(size) == whole else arr[block],
                              dtype)
        for p in meta["pieces"]:
            if tuple(p["offset"]) == tuple(offset) and \
                    tuple(p["shape"]) == tuple(size):
                arr = np.load(os.path.join(self.path, p["file"]))
                self.meter.add(arr.nbytes)
                return _to_tensor(arr, dtype)
        out = np.empty(size, np.uint16 if dtype == "bfloat16" else dtype)
        covered = 0
        for p in meta["pieces"]:
            lo = [max(a, b) for a, b in zip(offset, p["offset"])]
            hi = [min(a + n, b + m) for a, n, b, m in
                  zip(offset, size, p["offset"], p["shape"])]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            src = np.load(os.path.join(self.path, p["file"]), mmap_mode="r")
            part = src[tuple(slice(l - b, h - b)
                             for l, h, b in zip(lo, hi, p["offset"]))]
            out[tuple(slice(l - a, h - a)
                      for l, h, a in zip(lo, hi, offset))] = part
            self.meter.add(part.nbytes)
            covered += part.size
            del src, part
        if covered != out.size:
            raise ValueError(f"{key}: the saved pieces cover {covered} of "
                             f"the {out.size} values of the block at "
                             f"{tuple(offset)} of {tuple(size)}")
        return _to_tensor(out, dtype)


def _sharding_index(shardings) -> Dict[str, Sharding]:
    """{key: Sharding} of a shardings tree, keyed as ``_flatten`` keys the
    state's leaves."""
    out: Dict[str, Sharding] = {}

    def walk(tree, prefix):
        if isinstance(tree, Sharding):
            out[SEP.join(prefix)] = tree
        elif tree is not None:
            for path, child in _items(tree, prefix):
                walk(child, path)
    walk(shardings, ())
    return out


def _unflatten_keys(flat: Dict[str, torch.Tensor]):
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split(SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return root
