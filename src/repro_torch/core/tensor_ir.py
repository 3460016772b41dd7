"""TensorIR — level-1 (algorithmic) dialect of the stagecc compiler stack.

This is the MLIR-linalg analogue in the paper's pipeline (Fig. 1):
SYCL -> [DPC++] -> MLIR -> CIRCT/Calyx -> RTL
            here:  TensorIR -> LoopIR -> {ref | jax | pallas}

TensorIR is an SSA graph of whole-tensor operations with static shapes.
It is deliberately small: the ops below cover the contraction-plus-
epilogue family the paper's GEMM case study lives in, and the op set is
extensible through ``register_op`` (the paper's "reusable & extensible"
requirement).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Types and values
# --------------------------------------------------------------------------

_DTYPES = ("float32", "bfloat16", "float16", "int32", "int8")


@dataclasses.dataclass(frozen=True)
class TensorType:
    shape: Tuple[int, ...]
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise TypeError(f"unsupported dtype {self.dtype!r}")
        if any((not isinstance(d, (int, np.integer))) or d <= 0 for d in self.shape):
            raise TypeError(f"bad shape {self.shape!r}")
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def nelems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.nelems * dtype_bytes(self.dtype)

    def __str__(self):
        dims = "x".join(str(d) for d in self.shape)
        return f"tensor<{dims}x{self.dtype}>" if self.shape else f"tensor<{self.dtype}>"


def dtype_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int8": 1}[dtype]


@dataclasses.dataclass(eq=False)
class Value:
    """SSA value. Identity-hashed; ``producer`` is set by the graph builder."""

    name: str
    type: TensorType
    producer: Optional["Op"] = dataclasses.field(default=None, repr=False)

    def __str__(self):
        return f"%{self.name}: {self.type}"


# --------------------------------------------------------------------------
# Op registry — the extensibility mechanism
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpDef:
    """Definition of a TensorIR op.

    ``infer`` maps (input types, attrs) -> result type and doubles as the
    verifier: it must raise on ill-typed operands.
    """

    name: str
    infer: Callable[[Sequence[TensorType], Dict[str, Any]], TensorType]
    # numpy semantics, used by the TensorIR-level interpreter (oracle).
    eval_np: Callable[..., np.ndarray]


OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, infer, eval_np) -> OpDef:
    if name in OP_REGISTRY:
        raise ValueError(f"op {name!r} already registered")
    opdef = OpDef(name, infer, eval_np)
    OP_REGISTRY[name] = opdef
    return opdef


# ---- standard op definitions ----------------------------------------------


def _infer_matmul(in_types, attrs):
    a, b = in_types
    if a.rank != 2 or b.rank != 2:
        raise TypeError(f"matmul needs rank-2 operands, got {a} @ {b}")
    if a.shape[1] != b.shape[0]:
        raise TypeError(f"matmul contraction mismatch: {a} @ {b}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul dtype mismatch: {a} @ {b}")
    acc = attrs.get("acc_dtype", "float32")
    return TensorType((a.shape[0], b.shape[1]), acc)


def _infer_ewise_binary(in_types, attrs):
    a, b = in_types
    if a.shape != b.shape and b.shape != ():
        # numpy-style broadcast of the SECOND operand only, restricted to
        # size-1 dims (e.g. an (M, N) map against per-row (M, 1) statistics
        # — the online-softmax normalisation shape)
        ok = (b.rank == a.rank
              and all(db == da or db == 1
                      for da, db in zip(a.shape, b.shape)))
        if not ok:
            raise TypeError(f"elementwise shape mismatch: {a} vs {b}")
    if a.dtype != b.dtype:
        raise TypeError(f"elementwise dtype mismatch: {a} vs {b}")
    return a


def _infer_ewise_unary(in_types, attrs):
    (a,) = in_types
    return a


def _infer_bias_add(in_types, attrs):
    a, b = in_types
    if b.rank != 1 or b.shape[0] != a.shape[-1]:
        raise TypeError(f"bias_add: bias {b} does not match {a}")
    return a


def _infer_reduce_sum(in_types, attrs):
    (a,) = in_types
    axis = attrs["axis"]
    shape = tuple(d for i, d in enumerate(a.shape) if i != axis)
    return TensorType(shape, a.dtype)


#: reduction kinds with their combine semantics and identity element
REDUCE_KINDS = ("max", "sum")
#: scan kinds: ``linear`` is the carried recurrence h_t = a_t*h_{t-1}+x_t
#: (the SSD/Mamba state update); ``cumsum`` is the a_t == 1 special case
SCAN_KINDS = ("linear", "cumsum")
#: identity element of a max reduction (matches the hand-written kernels'
#: _NEG so masked attention rows behave identically through both paths)
REDUCE_NEG_INF = -1e30


def reduce_identity(kind: str) -> float:
    return REDUCE_NEG_INF if kind == "max" else 0.0


def _infer_reduce(in_types, attrs):
    (a,) = in_types
    kind = attrs.get("kind")
    if kind not in REDUCE_KINDS:
        raise TypeError(f"reduce: kind must be one of {REDUCE_KINDS}, "
                        f"got {kind!r}")
    axis = attrs.get("axis")
    if not isinstance(axis, (int, np.integer)) or not 0 <= axis < a.rank:
        raise TypeError(f"reduce: axis {axis!r} out of range for {a}")
    keepdims = attrs.get("keepdims", True)
    if keepdims:
        shape = tuple(1 if i == axis else d for i, d in enumerate(a.shape))
    else:
        shape = tuple(d for i, d in enumerate(a.shape) if i != axis)
    return TensorType(shape, a.dtype)


def _eval_reduce(a, **at):
    fn = np.max if at["kind"] == "max" else np.sum
    return fn(a, axis=at["axis"], keepdims=at.get("keepdims", True))


def _infer_scan(in_types, attrs):
    kind = attrs.get("kind")
    if kind not in SCAN_KINDS:
        raise TypeError(f"scan: kind must be one of {SCAN_KINDS}, "
                        f"got {kind!r}")
    if kind == "linear":
        if len(in_types) != 2:
            raise TypeError(f"scan<linear> takes (decay, update) operands, "
                            f"got {len(in_types)}")
        a, x = in_types
        if a.shape != x.shape or a.dtype != x.dtype:
            raise TypeError(f"scan: carry-shape mismatch: decay {a} vs "
                            f"update {x}")
    else:
        if len(in_types) != 1:
            raise TypeError(f"scan<cumsum> takes one operand, "
                            f"got {len(in_types)}")
        x = in_types[0]
    axis = attrs.get("axis")
    if not isinstance(axis, (int, np.integer)) or not 0 <= axis < x.rank:
        raise TypeError(f"scan: axis {axis!r} out of range for {x}")
    return x


def _eval_scan(*arrays, **at):
    axis = at["axis"]
    if at["kind"] == "cumsum":
        return np.cumsum(arrays[0], axis=axis)
    a, x = (np.moveaxis(np.asarray(v), axis, 0) for v in arrays)
    h = np.zeros_like(x)
    carry = np.zeros_like(x[0])
    for t in range(x.shape[0]):
        carry = a[t] * carry + x[t]
        h[t] = carry
    return np.moveaxis(h, 0, axis)


def _infer_transpose(in_types, attrs):
    (a,) = in_types
    perm = attrs["perm"]
    if sorted(perm) != list(range(a.rank)):
        raise TypeError(f"bad perm {perm} for {a}")
    return TensorType(tuple(a.shape[p] for p in perm), a.dtype)


def _infer_cast(in_types, attrs):
    (a,) = in_types
    return TensorType(a.shape, attrs["dtype"])


register_op("matmul", _infer_matmul, lambda a, b, **at: (
    np.asarray(a, np.float32) @ np.asarray(b, np.float32)))
register_op("add", _infer_ewise_binary, lambda a, b, **at: a + b)
register_op("sub", _infer_ewise_binary, lambda a, b, **at: a - b)
register_op("mul", _infer_ewise_binary, lambda a, b, **at: a * b)
register_op("maximum", _infer_ewise_binary, lambda a, b, **at: np.maximum(a, b))
register_op("div", _infer_ewise_binary, lambda a, b, **at: a / b)
register_op("relu", _infer_ewise_unary, lambda a, **at: np.maximum(a, 0))
register_op("gelu", _infer_ewise_unary, lambda a, **at: (
    0.5 * a * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (a + 0.044715 * a**3)))))
register_op("exp", _infer_ewise_unary, lambda a, **at: np.exp(a))
register_op("neg", _infer_ewise_unary, lambda a, **at: -a)
register_op("tanh", _infer_ewise_unary, lambda a, **at: np.tanh(a))
register_op("sigmoid", _infer_ewise_unary,
            lambda a, **at: 1.0 / (1.0 + np.exp(-a)))
register_op("sqrt", _infer_ewise_unary, lambda a, **at: np.sqrt(a))
register_op("rsqrt", _infer_ewise_unary, lambda a, **at: 1.0 / np.sqrt(a))
register_op("log1p", _infer_ewise_unary, lambda a, **at: np.log1p(a))
register_op("abs", _infer_ewise_unary, lambda a, **at: np.abs(a))
register_op("bias_add", _infer_bias_add, lambda a, b, **at: a + b[None, :])
register_op("reduce_sum", _infer_reduce_sum,
            lambda a, **at: np.sum(a, axis=at["axis"]))
register_op("reduce", _infer_reduce, _eval_reduce)
register_op("scan", _infer_scan, _eval_scan)
register_op("transpose", _infer_transpose,
            lambda a, **at: np.transpose(a, at["perm"]))
register_op("cast", _infer_cast, lambda a, **at: a.astype(at["dtype"]
            if at["dtype"] != "bfloat16" else np.float32))


# --------------------------------------------------------------------------
# Ops and graphs
# --------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Op:
    opname: str
    inputs: List[Value]
    attrs: Dict[str, Any]
    result: Value

    def __str__(self):
        from . import ir_text
        return ir_text.print_op(self)

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List["Op"]:
        return []

    def rebuild(self, children: Sequence["Op"]) -> "Op":
        assert not children
        return Op(self.opname, list(self.inputs), dict(self.attrs),
                  self.result)

    def is_equivalent(self, other) -> bool:
        from . import ir_text
        return isinstance(other, Op) and \
            ir_text.print_op(self) == ir_text.print_op(other)


class Graph:
    """A TensorIR function: ordered SSA ops over named inputs."""

    def __init__(self, name: str):
        self.name = name
        self.inputs: List[Value] = []
        self.ops: List[Op] = []
        self.outputs: List[Value] = []
        self._counter = 0

    # ---- builder API -------------------------------------------------------

    def add_input(self, name: str, type: TensorType) -> Value:
        v = Value(name, type)
        self.inputs.append(v)
        return v

    def fresh_name(self, hint: str = "v") -> str:
        self._counter += 1
        return f"{hint}{self._counter}"

    def emit(self, opname: str, inputs: Sequence[Value], **attrs) -> Value:
        if opname not in OP_REGISTRY:
            raise KeyError(f"unknown op {opname!r}; registered: {sorted(OP_REGISTRY)}")
        opdef = OP_REGISTRY[opname]
        rtype = opdef.infer([v.type for v in inputs], attrs)
        res = Value(self.fresh_name(opname), rtype)
        op = Op(opname, list(inputs), dict(attrs), res)
        res.producer = op
        self.ops.append(op)
        return res

    def set_outputs(self, *values: Value):
        self.outputs = list(values)

    # ---- rewrite-core structural protocol (see core/rewrite.py) -----------

    def children(self) -> List[Op]:
        """The graph's mutable op list (the rewrite driver splices it)."""
        return self.ops

    def rebuild(self, children: Sequence[Op]) -> "Graph":
        g = Graph(self.name)
        g.inputs = list(self.inputs)
        g.ops = list(children)
        g.outputs = list(self.outputs)
        g._counter = self._counter
        return g

    def is_equivalent(self, other) -> bool:
        """Structural equivalence: identical canonical textual form."""
        from . import ir_text
        return isinstance(other, Graph) and \
            ir_text.print_graph(self) == ir_text.print_graph(other)

    # ---- verification ------------------------------------------------------

    def verify(self) -> None:
        """SSA well-formedness: defs precede uses, types re-infer identically."""
        defined = {id(v) for v in self.inputs}
        for op in self.ops:
            for v in op.inputs:
                if id(v) not in defined:
                    raise ValueError(
                        f"use-before-def of %{v.name} in {op.opname} ({self.name})")
            opdef = OP_REGISTRY[op.opname]
            rtype = opdef.infer([v.type for v in op.inputs], op.attrs)
            if rtype != op.result.type:
                raise ValueError(
                    f"type mismatch on %{op.result.name}: stored {op.result.type}, "
                    f"inferred {rtype}")
            defined.add(id(op.result))
        for v in self.outputs:
            if id(v) not in defined:
                raise ValueError(f"output %{v.name} is not defined")

    # ---- oracle ------------------------------------------------------------

    def eval_np(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Reference interpretation with numpy — the top-level oracle."""
        if len(arrays) != len(self.inputs):
            raise ValueError(f"{self.name} expects {len(self.inputs)} inputs")
        env: Dict[int, np.ndarray] = {}
        for v, a in zip(self.inputs, arrays):
            if tuple(a.shape) != v.type.shape:
                raise ValueError(f"input %{v.name}: got shape {a.shape}, "
                                 f"expected {v.type.shape}")
            env[id(v)] = np.asarray(a)
        for op in self.ops:
            fn = OP_REGISTRY[op.opname].eval_np
            env[id(op.result)] = fn(*[env[id(v)] for v in op.inputs], **op.attrs)
        return [env[id(v)] for v in self.outputs]

    # ---- printing ----------------------------------------------------------

    def __str__(self):
        # canonical textual form lives in ir_text (it round-trips through
        # ir_text.parse_graph); delegate so str() and the parser can't drift.
        from . import ir_text
        return ir_text.print_graph(self)
