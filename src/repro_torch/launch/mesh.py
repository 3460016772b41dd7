"""Production and host meshes.

The PyTorch counterpart of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) — 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) — 512 ranks across 2 pods; the
``pod`` axis composes with ``data`` for batch/FSDP sharding so the
inter-pod boundary only ever carries data-parallel gradient traffic.

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
one device a rank.  Both are functions (never module-level
constants), so importing this module touches no device or process-group
state.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device: Any) -> str:
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device: Any = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices but only {have} ranks are "
            f"in the process group; the dry run starts a fake group of "
            f"world size {need} (repro_torch.launch.dryrun)")
    return DeviceMesh(_device_type(device),
                      torch.arange(need).reshape(shape), mesh_dim_names=axes)


def init_group(device: Any = "cuda") -> None:
    """Start a 1-rank process group if none exists: NCCL for a CUDA device
    (which must be present), gloo for the CPU, over an in-process store,
    so no address, port or environment variable is needed."""
    if dist.is_initialized():
        return
    kind = _device_type(device)
    if kind == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("make_host_mesh: a CUDA mesh needs NCCL, "
                               "which this torch build lacks")
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_host_mesh: device {device!r}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(model: Optional[int] = None,
                   device: Any = "cuda") -> DeviceMesh:
    """(world // model, model) mesh over the current process group's
    ranks (``init_group`` starts a 1-rank one when none exists)."""
    init_group(device)
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"world size {n} not divisible by model={model}")
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(kind, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))
