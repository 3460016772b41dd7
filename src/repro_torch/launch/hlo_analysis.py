"""Per-device FLOPs / bytes / collectives of a traced function, and
roofline terms.

The PyTorch counterpart of ``repro/launch/hlo_analysis.py``.  The port
has no HLO, so the reference's text parser (``analyze_hlo_module``,
``collective_bytes`` and the while-loop trip counts) is not carried
over.  ``analyze_trace(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` that sits below DTensor: it lets every DTensor op
through to DTensor's own dispatch (by returning ``NotImplemented``), so
it sees the ops DTensor runs on each rank's local pieces and the
collectives its redistributions emit, and skips DTensor's own shape
propagation (fake tensors).  On meta tensors (the dry run) nothing is
allocated.  A Python loop over layers is traced as it runs, so there is
no trip count to recover.  Per op it accounts:

  * FLOPs       — 2 x prod(result dims) x prod(contracted dims) per dot
                  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``dot``);
  * bytes       — operands + result of every op but views and the ops
                  that move nothing (the counterpart of the reference's
                  bytes-accessed semantics);
  * collectives — the ``_c10d_functional`` ops by kind and group size G,
                  on-the-wire bytes per device by the reference's
                  formulas:
        ring all-reduce       2 (G-1)/G x result_bytes
        all-gather            (G-1)/G x result_bytes   (result = gathered)
        reduce-scatter        (G-1)   x result_bytes   (result = shard)
        all-to-all            (G-1)/G x result_bytes
        collective-permute    1       x result_bytes

``roofline_terms`` prices them on a machine's peaks: the reference's TPU
v5e constants by default (parity), or ``H100`` (hopper-kernels guide §1:
989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s each way), which the
dry run prints.  Roofline terms are a model, not a timing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1,
                "f8e5m2": 1, "s64": 8, "u64": 8, "s32": 4, "u32": 4,
                "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
                "c64": 8, "c128": 16}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class ModuleStats:
    flops: float
    bytes: float
    collectives: CollectiveStats
    while_trips: Dict[str, int]


def wire_bytes(kind: str, group: int, result_bytes: float) -> float:
    """On-the-wire bytes per device of one collective over ``group``
    ranks whose result is ``result_bytes``."""
    g = group
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind == "all-gather":
        return (g - 1) / g * result_bytes
    if kind == "reduce-scatter":
        return float(g - 1) * result_bytes
    if kind == "all-to-all":
        return (g - 1) / g * result_bytes
    return float(result_bytes)                  # collective-permute


# --------------------------------------------------------------------------
# the trace counter
# --------------------------------------------------------------------------

# dot ops: the position, among its tensor arguments, of the operand whose
# last dim is the contracted one
_DOTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1, "dot": 0}

# _c10d_functional op -> the reference's collective kind
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}

# ops that move no bytes: allocation, waits, autograd wrappers, metadata
_NO_BYTES = {"empty", "empty_strided", "empty_like", "wait_tensor",
             "_wrap_tensor_autograd", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "is_same_size", "zeros", "ones", "full",
             "arange", "scalar_tensor", "new_empty", "new_empty_strided"}


def _tensors(tree, out=None):
    """The tensors of an op's (nested lists / tuples / dicts of)
    arguments or results, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    schema = func._schema
    vals = dict(zip([a.name for a in schema.arguments], args), **kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(vals["group_name"]).size()


class _Counter:
    """The TorchDispatchMode's state: FLOPs, bytes and collectives."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.counts: Dict[str, int] = {}
        self.by_kind: Dict[str, float] = {}

    def op(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            g = _group_size(func, args, kwargs)
            size = sum(_nbytes(t) for t in outs)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + wire_bytes(
                kind, g, size)
        if name in _DOTS:
            a = _tensors(args)[_DOTS[name]]
            self.flops += 2.0 * outs[0].numel() * a.shape[-1]
        if name in _NO_BYTES or func.is_view:
            return
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)

    def stats(self) -> ModuleStats:
        return ModuleStats(flops=self.flops, bytes=self.bytes,
                           collectives=CollectiveStats(dict(self.counts),
                                                       dict(self.by_kind)),
                           while_trips={})


def analyze_trace(fn, *args, **kwargs) -> ModuleStats:
    """Run ``fn(*args, **kwargs)`` and count, per device (on the local
    pieces of DTensors, whole for plain tensors), its dot FLOPs, bytes and
    collectives."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    counter = _Counter()

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # ``types``: the tensor subclasses among the arguments
            if any(issubclass(t, DTensor) for t in types):
                # DTensor's dispatch runs with this mode still active: its
                # local ops and collectives come back here
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not any(issubclass(t, FakeTensor) for t in types):
                counter.op(func, args, kwargs, out)
            return out

    with Mode():
        fn(*args, **kwargs)
    return counter.stats()


# --------------------------------------------------------------------------
# roofline terms
# --------------------------------------------------------------------------

PEAK_FLOPS = 197e12            # bf16 / chip (v5e)
HBM_BW = 819e9                 # bytes/s / chip
ICI_BW = 50e9                  # bytes/s / link (~per direction)


class Peaks(NamedTuple):
    name: str
    flops: float               # bf16 FLOP/s a device
    hbm: float                 # HBM bytes/s a device
    link: float                # interconnect bytes/s a device, each way


TPU_V5E = Peaks("TPU v5e (the reference's constants)", PEAK_FLOPS, HBM_BW,
                ICI_BW)
# one NVIDIA H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink 4
# 900 GB/s in both directions together
H100 = Peaks("NVIDIA H100 SXM", 989e12, 3.35e12, 450e9)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   model_flops_total: float = 0.0, n_devices: int = 1,
                   peaks: Peaks = TPU_V5E) -> Roofline:
    """All inputs are per-device quantities from the partitioned trace,
    except model_flops_total (whole-model analytic 6ND)."""
    c = flops / peaks.flops
    m = hbm_bytes / peaks.hbm
    k = coll_bytes / peaks.link
    terms = {"compute": c, "memory": m, "collective": k}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops_total / (flops * n_devices)
              if flops and model_flops_total else 0.0)
    return Roofline(flops_per_device=flops, hbm_bytes_per_device=hbm_bytes,
                    coll_bytes_per_device=coll_bytes, compute_s=c,
                    memory_s=m, collective_s=k, bottleneck=bottleneck,
                    model_flops=model_flops_total, useful_ratio=useful)

