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

A DTensor leaf (a train state on a mesh) is saved whole: every rank
gathers it and rank 0 writes, so the format is the same whatever the mesh,
and ``restore(shardings=)`` places a checkpoint onto any mesh (elastic
restore).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (Sharding, distribute, full,
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
    if torch.is_tensor(leaf):
        t = full(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, like=None,
               device: Any = "cpu", sharding=None) -> torch.Tensor:
    """The saved array as a tensor: on ``device``; in ``like``'s dtype and
    written into ``like`` (a DTensor gets its own piece) unless ``like`` is
    a meta tensor; or, with a ``sharding``, a new DTensor placed by it (in
    ``like``'s dtype where ``like`` is given)."""
    arr = np.array(arr, order="C")           # a copy, 0-d kept
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if sharding is not None:
        t = t.to(device=sharding.mesh.device_type,
                 dtype=t.dtype if like is None else like.dtype)
        return distribute(t, sharding)
    if like is None:
        return t.to(device)
    if like.device.type == "meta":
        return t.to(device=device, dtype=like.dtype)
    with torch.no_grad():
        if is_dtensor(like):
            return like.copy_(distribute(
                t.to(like.device, like.dtype),
                Sharding(like.device_mesh, (), tuple(like.placements))))
        return like.copy_(t)


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if _writer():
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    index = {}
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{len(index)}"] = arr
        index[key] = {"id": f"a{len(index)}", "shape": list(arr.shape),
                      "dtype": dtype}
    if _writer():
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "index": index, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)
    _barrier()
    return final


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only
    process.  Every rank gathers a DTensor's pieces (``full``), so every
    rank of the group calls ``save``."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """All ranks of a group past the commit before any goes on (to read
    the checkpoint back, say)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


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
    """Restore a checkpoint (the latest without ``step``).

    ``target``: optional tree (of tensors, meta tensors and DTensors
    included) giving the structure to restore into; each leaf comes back
    in the target leaf's dtype, written into the target's own tensor (so a
    restore holds one copy of the state, as the optimizer's in-place
    update; a DTensor gets its own piece), or for a meta leaf made on
    ``device``; a missing leaf or another shape raises.  Without it a
    nested dict of tensors on ``device`` is rebuilt from the flattened
    keys.  ``shardings``: a matching tree of ``Sharding``s (None where a
    leaf stays a plain tensor) for elastic placement: each such leaf
    comes back as a new DTensor on that sharding's mesh, whatever mesh
    the checkpoint was saved from.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    index = manifest["index"]
    placed = _sharding_index(shardings)

    if target is not None:
        def leaf_of(key, leaf):
            if key not in index:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[index[key]["id"]]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {want}")
            return _to_tensor(arr, index[key]["dtype"], leaf, device,
                              placed.get(key))
        tree = _rebuild(target, leaf_of)
    else:
        tree = _unflatten_keys({
            key: _to_tensor(data[meta["id"]], meta["dtype"], device=device,
                            sharding=placed.get(key))
            for key, meta in index.items()})
    return tree, manifest["extra"] | {"step": manifest["step"]}


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
