"""Frontend tracer: restricted Python -> TensorIR.

Plays the SYCL/DPC++ role in the paper's Fig. 1: the user writes a kernel
in the host language (here: Python over ``stagecc`` proxy arrays) and the
frontend produces the level-1 IR automatically — no hand-written IR.

Example::

    import repro_torch.core.frontend as fe

    def f(a, b, bias):
        return fe.relu(fe.matmul(a, b) + bias)

    graph = fe.trace(f, [fe.spec((64, 32)), fe.spec((32, 16)),
                         fe.spec((16,))])
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Sequence

from .tensor_ir import Graph, TensorType, Value


@dataclasses.dataclass(frozen=True)
class spec:
    shape: tuple
    dtype: str = "float32"


class Tracer:
    """Proxy value recording ops into the active graph."""

    __slots__ = ("value", "graph")

    def __init__(self, value: Value, graph: Graph):
        self.value = value
        self.graph = graph

    def _emit(self, opname, others=(), **attrs):
        ins = [self.value] + [o.value for o in others]
        res = self.graph.emit(opname, ins, **attrs)
        return Tracer(res, self.graph)

    def __matmul__(self, other):
        return self._emit("matmul", [other])

    def __add__(self, other):
        if other.value.type.rank == 1 and self.value.type.rank > 1:
            return self._emit("bias_add", [other])
        return self._emit("add", [other])

    def __sub__(self, other):
        return self._emit("sub", [other])

    def __mul__(self, other):
        return self._emit("mul", [other])

    def __neg__(self):
        return self._emit("neg")

    @property
    def shape(self):
        return self.value.type.shape

    @property
    def dtype(self):
        return self.value.type.dtype


# free-function forms mirroring the op set
def matmul(a: Tracer, b: Tracer) -> Tracer:
    return a._emit("matmul", [b])


def relu(a: Tracer) -> Tracer:
    return a._emit("relu")


def gelu(a: Tracer) -> Tracer:
    return a._emit("gelu")


def exp(a: Tracer) -> Tracer:
    return a._emit("exp")


def maximum(a: Tracer, b: Tracer) -> Tracer:
    return a._emit("maximum", [b])


def div(a: Tracer, b: Tracer) -> Tracer:
    return a._emit("div", [b])


def reduce(a: Tracer, kind: str, axis: int, keepdims: bool = True) -> Tracer:
    """Carried reduction (``max`` or ``sum``) along ``axis``."""
    return a._emit("reduce", kind=kind, axis=axis, keepdims=keepdims)


def scan(a: Tracer, x: Tracer, axis: int = 0) -> Tracer:
    """Linear recurrence h_t = a_t * h_{t-1} + x_t along ``axis``."""
    return a._emit("scan", [x], kind="linear", axis=axis)


def cumsum(x: Tracer, axis: int = 0) -> Tracer:
    return x._emit("scan", kind="cumsum", axis=axis)


def transpose(a: Tracer, perm) -> Tracer:
    return a._emit("transpose", perm=tuple(perm))


def cast(a: Tracer, dtype: str) -> Tracer:
    return a._emit("cast", dtype=dtype)


# --------------------------------------------------------------------------
# serving-kernel graph builders — the production shapes expressed as
# TensorIR so the whole pipeline (schedules, DSE, backends) applies to
# them instead of only to hand-written pallas
# --------------------------------------------------------------------------


def flash_attention_graph(sq: int, sk: int, d: int,
                          name: str = None) -> Graph:
    """Softmax attention for one (batch*head) slice as TensorIR.

    Inputs: ``q`` (sq, d) — pre-scaled by 1/sqrt(d); ``kt`` (d, sk) —
    keys pre-transposed; ``v`` (sk, d); ``mask`` (sq, sk) — additive,
    0 where attendable and -1e30 where masked (causal/window/valid
    masking is data, so one graph covers every masking policy).

    The online-softmax statistics of the hand kernel appear here as
    carried ``reduce`` ops; tiling their reduction axis threads the
    running max/sum through the carry (see ``lowering.lower_reduce``).
    """
    def f(q, kt, v, mask):
        s = matmul(q, kt) + mask
        m = reduce(s, kind="max", axis=1)
        p = exp(s - m)
        l = reduce(p, kind="sum", axis=1)
        return div(matmul(p, v), l)
    return trace(f, [spec((sq, d)), spec((d, sk)), spec((sk, d)),
                     spec((sq, sk))],
                 name=name or f"flash_{sq}x{sk}x{d}")


def decode_attention_graph(rep: int, smax: int, hd: int,
                           name: str = None) -> Graph:
    """Decode attention for one (batch, kv-group) slice: the same
    online-softmax dataflow as flash at the (rep, smax) decode shape;
    the KV-cache validity mask arrives as the additive ``mask`` input."""
    return flash_attention_graph(rep, smax, hd,
                                 name=name or f"decode_{rep}x{smax}x{hd}")


def ssd_scan_graph(s: int, p: int, n: int, name: str = None) -> Graph:
    """Mamba-2 SSD recurrence for one head as TensorIR.

    The (P, N) state is flattened to PN columns so the recurrence
    h_t = a_t ⊙ h_{t-1} + u_t is a rank-2 associative ``scan`` over the
    sequence axis.  Inputs: ``a`` (s, p*n) per-step decay exp(dt*A);
    ``u`` (s, p*n) the dt*x*B outer-product updates; ``ct`` (s, p*n)
    C broadcast along P; ``g`` (p*n, p) the 0/1 group-sum matrix that
    contracts the state dim back to head width (an MXU op, matching the
    chunked-scan formulation's matmuls).
    """
    pn = p * n

    def f(a, u, ct, g):
        h = scan(a, u, axis=0)
        return matmul(h * ct, g)
    return trace(f, [spec((s, pn)), spec((s, pn)), spec((s, pn)),
                     spec((pn, p))],
                 name=name or f"ssd_{s}x{p}x{n}")


def trace(fn: Callable, in_specs: Sequence[spec], name: str = None) -> Graph:
    # sanitise so the graph name is legal in textual IR (`<lambda>` etc.
    # would make str(graph) unparseable by ir_text)
    g = Graph(re.sub(r"[^\w.\-]", "_", name or fn.__name__))
    tracers = []
    for i, sp in enumerate(in_specs):
        v = g.add_input(f"arg{i}", TensorType(tuple(sp.shape), sp.dtype))
        tracers.append(Tracer(v, g))
    out = fn(*tracers)
    outs = out if isinstance(out, (tuple, list)) else [out]
    g.set_outputs(*[t.value for t in outs])
    g.verify()
    return g
