"""Program raising: traced PyTorch -> TensorIR (the mlirSynth direction).

Every TensorIR graph of ``frontend`` is hand-written
(``frontend.flash_attention_graph`` etc.).  This module starts from the
*software* frontend instead — a real PyTorch function, traced by
``torch.fx.experimental.proxy_tensor.make_fx`` into a graph of ATen ops —
and raises it into the level-1 IR automatically, so every model config
becomes a compiler workload.

Pipeline position::

    torch fn --make_fx--> ATen fx graph --raise_fx--> TensorIR Graph
                                                        |  (PassManager)
                                                        v
                                       LoopIR -> HwIR -> {ref, torch, cuda}

Design notes
------------
* TensorIR is rank-2: every raised SSA value is a 2-D tensor.  An n-D
  shape maps to ``canon2d(shape) = (prod(shape[:-1]), shape[-1])`` —
  leading (batch) axes collapse into rows, the feature axis stays columns.
  ``view`` / ``unsqueeze`` / ``permute`` nodes that only move unit axes
  (``make_fx`` spells ``einsum`` and batched products that way) are shape
  bookkeeping; a permutation that swaps the two non-unit axes of a traced
  value emits ``transpose``.
* Weights / constants (``get_attr`` tensors the trace captured, Python
  scalars, anything foldable) are *folded* in numpy while possible and
  materialised lazily as extra graph inputs (``c0``, ``c1``, ...) the
  first time a non-foldable op consumes them, deduplicated by value;
  ``RaisedGraph.bind`` re-appends them at call time.  A raised graph of a
  closed-over-params block therefore has the user arguments first
  (``arg0``...) and the captured parameters after.
* Composite ATen ops raise to the primitive sequence of the TensorIR
  vocabulary: ``mean`` to a sum and a division by the count, ``silu`` to
  ``sigmoid; mul``, ``gelu(approximate="tanh")`` to the polynomial /
  ``tanh`` chain, ``softmax`` to max / sub / exp / sum / div.
* ``torch.ops.higher_order.scan`` bodies are raised by *linearity
  analysis*: each body value is tracked as ``alpha * carry + beta`` with
  ``alpha`` / ``beta`` expression trees over the per-step slices.  Any
  body that is affine in a single rank<=1 carry (zero-initialised) becomes
  the carried TensorIR ``scan`` op — this covers the SSD recurrence, RG-LRU
  and cumsum uniformly.  Every use of the scan op goes through
  :func:`scan_hop`.
* Anything outside the vocabulary raises :class:`RaiseError` naming the
  offending ATen op and its fx node, so ``reproc --raise`` and the
  raisability table can show *why* a block does not raise.
* ``check_hlo_trips=True`` raises :class:`RaiseError`: the reference
  cross-checks scan lengths against the ``while``-loop trip counts of
  XLA's optimized HLO, and a traced PyTorch function compiles to no HLO.

NOTE: ``raise`` is a Python keyword — import this module as::

    raising = importlib.import_module("repro_torch.core.raise")
"""

from __future__ import annotations

import dataclasses
import math
import operator
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tensor_ir import Graph, TensorType, Value


class RaiseError(ValueError):
    """A traced fragment outside the raisable vocabulary.

    Carries the unraisable ATen op's name (``primitive``, e.g.
    ``aten.slice.Tensor``) and the offending fx node's text (``node``) so
    diagnostics (CLI, docs table, negative tests) can point at the source.
    """

    def __init__(self, msg: str, primitive: Optional[str] = None,
                 node: Optional[str] = None):
        self.primitive = primitive
        self.node = node
        full = msg
        if primitive:
            full += f" [primitive: {primitive}]"
        if node:
            nd = node if len(node) <= 400 else node[:400] + "..."
            full += f"\n  in node: {nd}"
        super().__init__(full)


def canon2d(shape: Sequence[int]) -> Tuple[int, int]:
    """n-D shape -> the rank-2 TensorIR shape it raises to."""
    shape = tuple(int(d) for d in shape)
    if any(d == 0 for d in shape):
        raise RaiseError(f"zero-sized dimension in shape {shape}")
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, shape[0])
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return (rows, shape[-1])


def _nonunit(shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(d) for d in shape if d != 1)


@dataclasses.dataclass
class _RVal:
    """One fx value during raising.

    Exactly one of ``val`` (a rank-2 TensorIR SSA value) or ``const`` (a
    numpy payload of the traced shape, still foldable) is set; if neither
    is, ``note`` says why, and the error surfaces only if the value is
    actually consumed (e.g. a scan's unused final carry).
    """

    jshape: Tuple[int, ...]
    val: Optional[Value] = None
    const: Optional[np.ndarray] = None
    note: Optional[str] = None


# numpy semantics for constant folding (float32 domain, matching backends)
_NP_BIN: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "maximum": np.maximum,
}
_NP_UN: Dict[str, Callable] = {
    "neg": lambda a: -a,
    "exp": np.exp,
    "tanh": np.tanh,
    "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "sqrt": np.sqrt,
    "rsqrt": lambda a: 1.0 / np.sqrt(a),
    "log1p": np.log1p,
    "abs": np.abs,
    "relu": lambda a: np.maximum(a, 0),
}

# ATen op -> TensorIR ewise op
_BIN_OPS = {
    "aten.add.Tensor": "add", "aten.add.Scalar": "add",
    "aten.sub.Tensor": "sub", "aten.sub.Scalar": "sub",
    "aten.mul.Tensor": "mul", "aten.mul.Scalar": "mul",
    "aten.div.Tensor": "div", "aten.div.Scalar": "div",
    "aten.maximum.default": "maximum",
}
_UN_OPS = {
    "aten.exp.default": "exp", "aten.neg.default": "neg",
    "aten.tanh.default": "tanh", "aten.sigmoid.default": "sigmoid",
    "aten.rsqrt.default": "rsqrt", "aten.sqrt.default": "sqrt",
    "aten.log1p.default": "log1p", "aten.abs.default": "abs",
}

# ATen ops folded when ALL operands are constants (never emitted as ops)
_FOLD_ONLY = {
    "aten.pow.Scalar": np.power, "aten.pow.Tensor_Tensor": np.power,
    "aten.pow.Tensor_Scalar": np.power,
    "aten.cos.default": np.cos, "aten.sin.default": np.sin,
    "aten.log.default": np.log, "aten.floor.default": np.floor,
    "aten.round.default": np.round, "aten.sign.default": np.sign,
    "aten.minimum.default": np.minimum,
    "aten.lt.Tensor": lambda a, b: a < b, "aten.lt.Scalar": lambda a, b: a < b,
    "aten.le.Tensor": lambda a, b: a <= b, "aten.le.Scalar": lambda a, b: a <= b,
    "aten.gt.Tensor": lambda a, b: a > b, "aten.gt.Scalar": lambda a, b: a > b,
    "aten.ge.Tensor": lambda a, b: a >= b, "aten.ge.Scalar": lambda a, b: a >= b,
    "aten.eq.Tensor": lambda a, b: a == b, "aten.eq.Scalar": lambda a, b: a == b,
    "aten.logical_and.default": np.logical_and,
    "aten.logical_or.default": np.logical_or,
    "aten.logical_not.default": np.logical_not,
    "aten.logical_xor.default": np.logical_xor,
}
_COMPARISONS = {k for k in _FOLD_ONLY
                if k.split(".")[1] in ("lt", "le", "gt", "ge", "eq")}

# ops the LoopIR lowering implements (cast/transpose print and eval but
# have no tile lowering — a graph containing them raises fine but can't
# compile)
_LOWERABLE_OPS = {"matmul", "bias_add", "reduce_sum", "reduce", "scan",
                  "add", "sub", "mul", "maximum", "div",
                  "relu", "gelu", "exp", "neg",
                  "tanh", "sigmoid", "sqrt", "rsqrt", "log1p", "abs"}

# ops that pass their operand through (float dtype casts, copies, aliases)
_IDENTITY_OPS = {"aten.clone.default", "aten.alias.default",
                 "aten.detach.default", "aten.detach_.default",
                 "aten.lift_fresh_copy.default",
                 "aten._to_copy.default", "aten.to.dtype"}
# ops that produce nothing the graph reads
_NOOP_OPS = {"aten._assert_tensor_metadata.default"}
# views that only re-label the shape
_VIEW_OPS = {"aten.view.default", "aten._unsafe_view.default",
             "aten.reshape.default", "aten.unsqueeze.default",
             "aten.squeeze.dim", "aten.squeeze.dims",
             "aten.squeeze.default"}

_SCAN = "higher_order.scan"


def _fold(fn, *args):
    """Constant folding runs on whatever values the trace produced (incl.
    inf masks); fold-domain warnings are non-events."""
    with np.errstate(all="ignore"):
        return fn(*args)


def _npc(x) -> np.ndarray:
    """Constant payload -> float-friendly numpy (bools/ints kept for masks)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16 or x.dtype == torch.float16:
            x = x.float()
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def _opname(target) -> str:
    if target is operator.getitem:
        return "getitem"
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    return str(target)


def _jshape(node) -> Tuple[int, ...]:
    return tuple(int(d) for d in node.meta["val"].shape)


def _np_dtype(dt: torch.dtype):
    if dt.is_floating_point:
        return np.float32
    if dt == torch.bool:
        return np.bool_
    return {torch.int32: np.int32, torch.int64: np.int64,
            torch.int16: np.int16, torch.int8: np.int8,
            torch.uint8: np.uint8}.get(dt, np.int64)


# --------------------------------------------------------------------------
# the scan op: the one place that calls torch's scan HOP
# --------------------------------------------------------------------------


def scan_hop(step: Callable, init: torch.Tensor,
             xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``ys`` of ``torch.ops.higher_order.scan`` over the leading axis of
    ``xs``: ``step(h, *x_t)`` returns the new carry ``h``, and every ``h_t``
    is stacked.  Eager calls run torch's own loop (no compile step); under
    ``make_fx`` the body traces into a sub-``GraphModule``.  The only use
    of the HOP in this package, so a signature change of the (private)
    op has one place to be fixed."""
    from torch._higher_order_ops.scan import scan_op

    def body(h, *x_t):
        h = step(h, *x_t)
        return [h, h.clone()]          # the output must not alias the carry
    _, ys = scan_op(body, [init], list(xs), ())
    return ys


def _scan_linear(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + u_t`` from ``h_0 = 0``, every ``h_t``."""
    h0 = torch.zeros(a.shape[1:], dtype=torch.float32, device=a.device)
    return scan_hop(lambda h, a_t, u_t: a_t * h + u_t, h0, (a, u))


# --------------------------------------------------------------------------
# scan-body linearity analysis:  value == alpha * carry + beta
# --------------------------------------------------------------------------
# Expr nodes: ("xs", i) | ("outer", k) | ("lit", ndarray) |
#             ("un", op, e) | ("bin", op, e1, e2)

_E_ONE = ("lit", np.float32(1.0))


def _e_is_one(e) -> bool:
    return (e is not None and e[0] == "lit"
            and np.ndim(e[1]) == 0 and float(e[1]) == 1.0)


def _e_add(a, b, op="add"):
    if a is None:
        return b if op == "add" else ("un", "neg", b) if b is not None else None
    if b is None:
        return a
    return ("bin", op, a, b)


def _e_mul(a, b):
    if a is None or b is None:
        return None
    if _e_is_one(a):
        return b
    if _e_is_one(b):
        return a
    return ("bin", "mul", a, b)


@dataclasses.dataclass
class _LinVal:
    alpha: Optional[tuple]  # coefficient of the carry (None == 0)
    beta: Optional[tuple]   # carry-free part (None == 0)


_PASS_OPS = _IDENTITY_OPS - {"aten._to_copy.default", "aten.to.dtype"}


def _strip_copies(n):
    while getattr(n, "op", None) == "call_function" \
            and _opname(n.target) in _PASS_OPS:
        n = n.args[0]
    return n


def _linear_body(body, n_xs: int, n_outer: int):
    """Interpret a scan body (a ``GraphModule`` over ``carry, *xs_t,
    *outer``) as affine in its single carry.

    Returns ``(alpha, beta)`` expression trees for the new carry, or
    raises :class:`RaiseError` if the body is nonlinear / outside the
    vocabulary.
    """
    env: Dict[Any, _LinVal] = {}
    phs = [n for n in body.graph.nodes if n.op == "placeholder"]
    if len(phs) != 1 + n_xs + n_outer:
        raise RaiseError("scan body arity mismatch", primitive=_SCAN)
    env[phs[0]] = _LinVal(_E_ONE, None)                          # the carry
    for i in range(n_xs):
        env[phs[1 + i]] = _LinVal(None, ("xs", i))
    for k in range(n_outer):
        env[phs[1 + n_xs + k]] = _LinVal(None, ("outer", k))

    def read(a) -> _LinVal:
        if isinstance(a, torch.fx.Node):
            return env[a]
        return _LinVal(None, ("lit", _npc(a)))

    def fail(node, name, why):
        raise RaiseError(f"scan body not affine in the carry: {why}",
                         primitive=name, node=node.format_node())

    outs = None
    for node in body.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            env[node] = _LinVal(None, ("lit", _npc(getattr(body,
                                                           node.target))))
            continue
        if node.op == "output":
            outs = list(node.args[0])
            break
        name = _opname(node.target)
        if name in _NOOP_OPS:
            continue
        if name in _IDENTITY_OPS:
            env[node] = read(node.args[0])
            continue
        if name in ("aten.add.Tensor", "aten.add.Scalar",
                    "aten.sub.Tensor", "aten.sub.Scalar",
                    "aten.rsub.Scalar", "aten.rsub.Tensor"):
            if node.kwargs.get("alpha", 1) != 1:
                fail(node, name, "add/sub with a non-unit alpha")
            a, b = read(node.args[0]), read(node.args[1])
            op = "add" if name.startswith("aten.add") else "sub"
            if name.startswith("aten.rsub"):
                a, b = b, a
            out = _LinVal(_e_add(a.alpha, b.alpha, op),
                          _e_add(a.beta, b.beta, op))
        elif name in ("aten.mul.Tensor", "aten.mul.Scalar"):
            a, b = read(node.args[0]), read(node.args[1])
            if a.alpha is not None and b.alpha is not None:
                fail(node, name, "carry * carry")
            if a.alpha is not None:            # (alpha*c + beta) * b
                a, b = b, a
            out = _LinVal(_e_mul(a.beta, b.alpha), _e_mul(a.beta, b.beta))
        elif name in ("aten.div.Tensor", "aten.div.Scalar"):
            if node.kwargs.get("rounding_mode") is not None:
                fail(node, name, "division with a rounding mode")
            a, b = read(node.args[0]), read(node.args[1])
            if b.alpha is not None:
                fail(node, name, "division by the carry")
            out = _LinVal(_e_mul(a.alpha, ("un", "_recip", b.beta))
                          if a.alpha is not None else None,
                          _e_mul(a.beta, ("un", "_recip", b.beta))
                          if a.beta is not None else None)
        elif name == "aten.neg.default":
            a = read(node.args[0])
            out = _LinVal(("un", "neg", a.alpha) if a.alpha else None,
                          ("un", "neg", a.beta) if a.beta else None)
        elif name == "aten.maximum.default":
            a, b = read(node.args[0]), read(node.args[1])
            if a.alpha is not None or b.alpha is not None:
                fail(node, name, "max over the carry")
            out = _LinVal(None, ("bin", "maximum", a.beta, b.beta))
        elif name in _UN_OPS:
            a = read(node.args[0])
            if a.alpha is not None:
                fail(node, name, f"nonlinear {name} of the carry")
            out = _LinVal(None, ("un", _UN_OPS[name], a.beta))
        elif name in _VIEW_OPS or name == "aten.expand.default":
            # per-step shapes are tiny; only shape-preserving views keep
            # the timestep<->full-array correspondence exact
            a = read(node.args[0])
            if a.alpha is not None and not _e_is_one(a.alpha):
                fail(node, name, f"{name} of a carry-dependent value")
            out = a
        else:
            fail(node, name, f"unsupported body op {name!r}")
        env[node] = out

    if outs is None or len(outs) != 2 or \
            _strip_copies(outs[0]) is not _strip_copies(outs[1]):
        raise RaiseError(
            "scan body must yield (new_carry, new_carry) — the carried "
            "TensorIR scan materialises every h_t", primitive=_SCAN)
    new_carry = read(outs[0])
    if new_carry.alpha is None or new_carry.beta is None:
        raise RaiseError("scan body is not of the form a_t*h + u_t "
                         "(missing decay or update term)", primitive=_SCAN)
    return new_carry.alpha, new_carry.beta


# --------------------------------------------------------------------------
# the raiser
# --------------------------------------------------------------------------


class _Raiser:
    def __init__(self, name: str):
        self.graph = Graph(name)
        self.const_bindings: Dict[str, np.ndarray] = {}
        self._const_cache: Dict[tuple, Value] = {}
        self.scan_lengths: List[int] = []
        self._done: Dict[Any, Any] = {}   # nodes a peephole already raised
        self._transposed: Dict[int, tuple] = {}   # id(val) -> (operand, node)

    # ---- const materialisation -------------------------------------------

    def _const_input(self, arr2d: np.ndarray) -> Value:
        arr2d = np.ascontiguousarray(arr2d, dtype=np.float32)
        key = (arr2d.shape, arr2d.tobytes())
        v = self._const_cache.get(key)
        if v is None:
            name = f"c{len(self.const_bindings)}"
            v = self.graph.add_input(name, TensorType(arr2d.shape))
            self.const_bindings[name] = arr2d
            self._const_cache[key] = v
        return v

    @staticmethod
    def _full_const(rv: _RVal) -> np.ndarray:
        a = _npc(rv.const)
        if a.shape != tuple(rv.jshape):
            a = np.broadcast_to(a, rv.jshape)
        return a

    @staticmethod
    def _const2d(rv: _RVal, target: Optional[Tuple[int, int]]) -> np.ndarray:
        a = _npc(rv.const).astype(np.float32)
        if a.shape != tuple(rv.jshape):
            a = np.broadcast_to(a, rv.jshape)
        c = a.reshape(canon2d(rv.jshape))
        if target is not None and c.shape != tuple(target):
            if c.size == target[0] * target[1]:
                c = c.reshape(target)            # e.g. (1,N) -> (N,1)
            else:
                c = np.broadcast_to(c, target)
        return c

    def _need(self, rv: _RVal, node=None):
        if rv.val is None and rv.const is None:
            raise RaiseError(rv.note or "value is not raisable",
                             node=node.format_node() if node is not None
                             else None)

    def _mat(self, rv: _RVal, shape2d: Tuple[int, int]) -> Value:
        """The rank-2 SSA value for ``rv`` at exactly ``shape2d``."""
        self._need(rv)
        if rv.val is not None:
            if tuple(rv.val.type.shape) != tuple(shape2d):
                raise RaiseError(
                    f"cannot reconcile value of shape {rv.val.type.shape} "
                    f"with required shape {shape2d}")
            return rv.val
        return self._const_input(self._const2d(rv, shape2d))

    def _shape2(self, rv: _RVal) -> Tuple[int, int]:
        if rv.val is not None:
            return tuple(rv.val.type.shape)
        return canon2d(rv.jshape)

    def _force_full(self, rv: _RVal, jshape: Sequence[int]) -> Value:
        """``rv`` as a full ``canon2d(jshape)`` value, materialising any
        deferred broadcast (by ones-multiplication) or constant."""
        target = canon2d(jshape)
        if rv.const is not None:
            return self._const_input(self._const2d(rv, target))
        self._need(rv)
        s = tuple(rv.val.type.shape)
        if s == target:
            return rv.val
        if s == (target[1], target[0]) and 1 in s:
            # a keepdims-orientation vector, e.g. (N,1) vs (1,N): same data,
            # same linear order — a rank-2 transpose restores the layout
            return self.graph.emit("transpose", [rv.val], perm=(1, 0))
        if all(d in (1, t) for d, t in zip(s, target)):
            ones = self._const_input(np.ones(target, np.float32))
            return self.graph.emit("mul", [ones, rv.val])
        raise RaiseError(f"cannot broadcast value of shape {s} to {target}")

    # ---- elementwise ------------------------------------------------------

    def _ewise_un(self, op: str, a: _RVal, out_jshape, node=None) -> _RVal:
        self._need(a, node)
        if a.const is not None:
            return _RVal(tuple(out_jshape), const=_fold(
                _NP_UN[op], _npc(a.const).astype(np.float32)))
        return _RVal(tuple(out_jshape), val=self.graph.emit(op, [a.val]))

    def _ewise_bin(self, op: str, a: _RVal, b: _RVal, out_jshape,
                   node=None) -> _RVal:
        self._need(a, node)
        self._need(b, node)
        if a.const is not None and b.const is not None:
            return _RVal(tuple(out_jshape),
                         const=_fold(_NP_BIN[op],
                                     _npc(a.const).astype(np.float32),
                                     _npc(b.const).astype(np.float32)))
        # a rank-1 result may live in either orientation: (1,N) canonically,
        # or (N,1) when it flows out of a keepdims-free reduce
        targets = [canon2d(out_jshape)]
        if len(out_jshape) == 1 and out_jshape[0] != 1:
            targets.append((int(out_jshape[0]), 1))
        err = None
        for target in targets:
            try:
                return self._bin_at(op, a, b, target, tuple(out_jshape))
            except RaiseError as e:
                err = e
        raise RaiseError(
            f"unsupported ewise broadcast {self._shape2(a)} {op} "
            f"{self._shape2(b)} -> {targets[0]} ({err})",
            primitive=op, node=node.format_node() if node is not None
            else None)

    def _bin_at(self, op: str, a: _RVal, b: _RVal,
                target: Tuple[int, int], out_jshape) -> _RVal:
        def cshape(rv):
            """The 2-D shape this operand takes against ``target`` (None if
            irreconcilable)."""
            if rv.val is not None:
                s = tuple(rv.val.type.shape)
                return s if all(d in (1, t)
                                for d, t in zip(s, target)) else None
            c = canon2d(rv.jshape)
            if all(d in (1, t) for d, t in zip(c, target)):
                return c
            if c[0] * c[1] == target[0] * target[1]:
                return target                    # reshapeable constant
            return None

        sa, sb = cshape(a), cshape(b)
        if sa is None or sb is None:
            raise RaiseError(f"operands {self._shape2(a)} / "
                             f"{self._shape2(b)} do not fit {target}")
        full_a, full_b = sa == target, sb == target
        if not full_a and not full_b:
            # a constant can always be blown up to the full shape
            if a.const is not None:
                full_a, sa = True, target
            elif b.const is not None:
                full_b, sb = True, target
            else:
                raise RaiseError(f"no full-rank operand for {target}")
        if full_a:
            v = self.graph.emit(op, [self._mat(a, target), self._mat(b, sb)])
            return _RVal(out_jshape, val=v)
        # full_b only: TensorIR ewise broadcasts the SECOND operand
        vb = self._mat(b, target)
        va = self._mat(a, sa)
        if op in ("add", "mul", "maximum"):
            return _RVal(out_jshape, val=self.graph.emit(op, [vb, va]))
        if op == "sub":                          # a - b == -(b - a)
            return _RVal(out_jshape, val=self.graph.emit(
                "neg", [self.graph.emit("sub", [vb, va])]))
        if op == "div" and a.const is not None:
            return _RVal(out_jshape, val=self.graph.emit(
                "div", [self._mat(a, target), vb]))
        raise RaiseError(f"non-commutative {op} with broadcast first operand")

    def _eval_expr(self, e, xs_rv: List[_RVal], outer_rv: List[_RVal]) -> _RVal:
        """Evaluate a scan-body expression tree over the *full* arrays."""
        kind = e[0]
        if kind == "xs":
            return xs_rv[e[1]]
        if kind == "outer":
            return outer_rv[e[1]]
        if kind == "lit":
            a = _npc(e[1])
            return _RVal(tuple(a.shape), const=a)
        if kind == "un":
            _, op, sub = e
            a = self._eval_expr(sub, xs_rv, outer_rv)
            if op == "_recip":                   # 1 / x
                one = _RVal((), const=np.float32(1.0))
                return self._ewise_bin("div", one, a, a.jshape)
            return self._ewise_un(op, a, a.jshape)
        _, op, e1, e2 = e
        a = self._eval_expr(e1, xs_rv, outer_rv)
        b = self._eval_expr(e2, xs_rv, outer_rv)
        out_jshape = np.broadcast_shapes(tuple(a.jshape), tuple(b.jshape))
        return self._ewise_bin(op, a, b, out_jshape)

    # ---- reading fx arguments --------------------------------------------

    def _read(self, env, a) -> _RVal:
        if isinstance(a, torch.fx.Node):
            return env[a]
        c = _npc(a)
        return _RVal(tuple(c.shape), const=c)

    def _arg(self, node, i: int, name: str, default=None):
        if len(node.args) > i:
            return node.args[i]
        return node.kwargs.get(name, default)

    # ---- per-op handlers ---------------------------------------------------

    def _h_bin(self, node, env):
        name = _opname(node.target)
        op = _BIN_OPS[name]
        if node.kwargs.get("alpha", 1) != 1:
            raise RaiseError(f"{name} with a non-unit alpha",
                             primitive=name, node=node.format_node())
        if node.kwargs.get("rounding_mode") is not None:
            raise RaiseError(f"{name} with a rounding mode",
                             primitive=name, node=node.format_node())
        a, b = self._read(env, node.args[0]), self._read(env, node.args[1])
        return self._ewise_bin(op, a, b, _jshape(node), node)

    def _h_rsub(self, node, env):
        name = _opname(node.target)
        if self._arg(node, 2, "alpha", 1) != 1:
            raise RaiseError(f"{name} with a non-unit alpha",
                             primitive=name, node=node.format_node())
        a, b = self._read(env, node.args[0]), self._read(env, node.args[1])
        return self._ewise_bin("sub", b, a, _jshape(node), node)

    def _h_un(self, node, env):
        op = _UN_OPS[_opname(node.target)]
        return self._ewise_un(op, self._read(env, node.args[0]),
                              _jshape(node), node)

    def _h_relu(self, node, env):
        zero = _RVal((), const=np.asarray(0, np.int32))
        return self._ewise_bin("maximum", self._read(env, node.args[0]),
                               zero, _jshape(node), node)

    def _h_silu(self, node, env):
        # x * sigmoid(x)
        a = self._read(env, node.args[0])
        out = _jshape(node)
        return self._ewise_bin("mul", a, self._ewise_un("sigmoid", a, out,
                                                        node), out, node)

    def _h_gelu(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        out = _jshape(node)
        if node.kwargs.get("approximate", "none") != "tanh":
            raise RaiseError("gelu without the tanh approximation needs "
                             "erf, which TensorIR lacks", primitive=name,
                             node=node.format_node())

        def c(v):
            return _RVal((), const=np.float32(v))
        # 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))), times x
        x3 = self._ewise_bin("mul", self._ewise_bin("mul", a, a, out, node),
                             a, out, node)
        inner = self._ewise_bin("add", a, self._ewise_bin(
            "mul", c(0.044715), x3, out, node), out, node)
        t = self._ewise_un("tanh", self._ewise_bin(
            "mul", c(np.sqrt(2 / np.pi)), inner, out, node), out, node)
        cdf = self._ewise_bin("mul", c(0.5), self._ewise_bin(
            "add", c(1.0), t, out, node), out, node)
        return self._ewise_bin("mul", a, cdf, out, node)

    def _h_softplus(self, node, env):
        # logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x - 0|))
        name = _opname(node.target)
        if self._arg(node, 1, "beta", 1) != 1:
            raise RaiseError("softplus with beta != 1", primitive=name,
                             node=node.format_node())
        a = self._read(env, node.args[0])
        out = _jshape(node)
        if a.const is not None:
            x = _npc(a.const).astype(np.float32)
            return _RVal(out, const=_fold(np.logaddexp, x, np.float32(0)))
        zero = _RVal((), const=np.float32(0.0))
        amax = self._ewise_bin("maximum", a, zero, out, node)
        delta = self._ewise_bin("sub", a, zero, out, node)
        # the NaN branch (x + 0), computed and then not selected, as in the
        # reference's logaddexp
        self._ewise_bin("add", a, zero, out, node)
        tail = self._ewise_un("log1p", self._ewise_un("exp", self._ewise_un(
            "neg", self._ewise_un("abs", delta, out, node), out, node),
            out, node), out, node)
        return self._ewise_bin("add", amax, tail, out, node)

    def _h_reciprocal(self, node, env):
        a = self._read(env, node.args[0])
        out = _jshape(node)
        num = _RVal((), const=np.float32(1.0))
        users = list(node.users)
        if a.const is None and len(users) == 1:
            u = users[0]
            if _opname(u.target) in ("aten.mul.Tensor", "aten.mul.Scalar") \
                    and u.args[0] is node \
                    and not isinstance(u.args[1], torch.fx.Node):
                # ``s / x`` traces as reciprocal(x) * s: raise it as one div
                num = self._read(env, u.args[1])
                res = self._ewise_bin("div", num, a, out, node)
                self._done[u] = res
                return res
        return self._ewise_bin("div", num, a, out, node)

    def _h_fold_only(self, node, env):
        name = _opname(node.target)
        ins = [self._read(env, x) for x in node.args
               if isinstance(x, (torch.fx.Node, int, float, bool))]
        for rv in ins:
            if rv.const is None:
                if name in _COMPARISONS:
                    # defer: only an all-const select may consume this
                    return _RVal(_jshape(node),
                                 note=f"non-constant comparison {name!r} "
                                      f"(boolean dtype has no TensorIR "
                                      f"representation)")
                raise RaiseError(
                    f"primitive {name!r} is only supported on constants",
                    primitive=name, node=node.format_node())
        out = _fold(_FOLD_ONLY[name], *[_npc(rv.const) for rv in ins])
        out = np.asarray(out)
        if out.dtype == np.float64:
            out = out.astype(np.float32)
        return _RVal(_jshape(node), const=out)

    def _h_pow(self, node, env):
        y = node.args[1]
        a = self._read(env, node.args[0])
        out = _jshape(node)
        if isinstance(y, torch.fx.Node) or a.const is not None \
                or not float(y).is_integer():
            return self._h_fold_only(node, env)
        y = int(y)
        if y == 2:
            return self._ewise_bin("mul", a, a, out, node)
        if y == 3:
            sq = self._ewise_bin("mul", a, a, out, node)
            return self._ewise_bin("mul", sq, a, out, node)
        raise RaiseError(f"integer power with exponent {y}",
                         primitive=_opname(node.target),
                         node=node.format_node())

    def _h_identity(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        dt = node.meta["val"].dtype
        if a.const is not None:
            return dataclasses.replace(a, const=_npc(a.const).astype(
                _np_dtype(dt)), jshape=_jshape(node))
        if not dt.is_floating_point:
            raise RaiseError(
                f"{name} to non-float {dt} on a traced value",
                primitive=name, node=node.format_node())
        # the raised pipeline computes in float32 throughout
        return dataclasses.replace(a, jshape=_jshape(node))

    def _h_noop(self, node, env):
        return None

    def _reshape_like(self, node, a: _RVal, new_shape) -> _RVal:
        new_shape = tuple(int(d) for d in new_shape)
        if a.const is not None:
            arr = self._full_const(a)
            return _RVal(new_shape, const=arr.reshape(new_shape))
        self._need(a, node)
        target = canon2d(new_shape)
        s = tuple(a.val.type.shape)
        if s == target or all(d in (1, t) for d, t in zip(s, target)) \
                or _nonunit(s) == _nonunit(new_shape):
            # same data in the same linear order (unit axes only moved)
            return dataclasses.replace(a, jshape=new_shape)
        name = _opname(node.target)
        raise RaiseError(
            f"reshape {tuple(a.jshape)} -> {new_shape} does not preserve the "
            f"rank-2 canonical layout {s} -> {target}",
            primitive=name, node=node.format_node())

    def _h_view(self, node, env):
        return self._reshape_like(node, self._read(env, node.args[0]),
                                  _jshape(node))

    def _h_expand(self, node, env):
        a = self._read(env, node.args[0])
        shape = _jshape(node)
        bd = tuple(range(len(shape) - len(a.jshape), len(shape)))
        if a.const is not None:
            arr = self._full_const(a)
            vshape = [1] * len(shape)
            for i, d in enumerate(bd):
                vshape[d] = arr.shape[i]
            return _RVal(shape,
                         const=np.broadcast_to(arr.reshape(vshape), shape))
        self._need(a, node)
        vshape = [1] * len(shape)
        for i, d in enumerate(bd):
            vshape[d] = a.jshape[i]
        if tuple(vshape) == shape:               # a pure reshape
            return self._reshape_like(node, a, shape)
        # a real broadcast: keep the (smaller) value, defer materialisation
        # to the consumer — legal when the rank-2 layout still broadcasts
        # the same way (dims 1-or-full against canon2d(shape))
        target = canon2d(shape)
        s = tuple(a.val.type.shape)
        if all(d in (1, t) for d, t in zip(s, target)):
            return dataclasses.replace(a, jshape=shape)
        raise RaiseError(
            f"broadcast {tuple(a.jshape)} -> {shape} is not expressible in "
            f"the rank-2 layout (value has shape {s})",
            primitive=_opname(node.target), node=node.format_node())

    def _h_permute(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        rank = len(a.jshape)
        if name == "aten.t.default":
            perm = (1, 0) if rank == 2 else tuple(range(rank))
        elif name == "aten.transpose.int":
            d0, d1 = (int(d) % max(rank, 1) for d in node.args[1:3])
            perm = list(range(rank))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            perm = tuple(perm)
        else:
            perm = tuple(int(p) % rank for p in node.args[1])
        new_shape = tuple(a.jshape[p] for p in perm)
        if a.const is not None:
            return _RVal(new_shape,
                         const=np.transpose(self._full_const(a), perm))
        self._need(a, node)
        nonunit = [p for p in perm if a.jshape[p] != 1]
        if nonunit == sorted(nonunit):           # only unit dims moved
            return self._reshape_like(node, a, new_shape)
        s = tuple(a.val.type.shape)
        if len(nonunit) == 2 and s == (a.jshape[nonunit[1]],
                                       a.jshape[nonunit[0]]):
            # the two non-unit axes swap: a rank-2 transpose
            src = self._transposed.get(id(a.val))
            if src is not None and self.graph.ops[-1].result is a.val \
                    and len(src[1].users) == 1:
                # it undoes the transpose just emitted for this chain
                # alone (``make_fx`` spells a const-lhs ``einsum`` so):
                # drop that one and keep its operand
                self.graph.ops.pop()
                self.graph._counter -= 1
                return _RVal(new_shape, val=src[0])
            v = self.graph.emit("transpose", [a.val], perm=(1, 0))
            self._transposed[id(v)] = (a.val, node)
            return _RVal(new_shape, val=v)
        raise RaiseError(
            f"transpose {perm} of a traced {tuple(a.jshape)} value",
            primitive=name, node=node.format_node())

    def _reduce(self, node, kind: str, a: _RVal, dims, keepdim: bool,
                out_jshape=None):
        name = _opname(node.target)
        jrank = len(a.jshape)
        dims = tuple(sorted(int(d) % max(jrank, 1) for d in dims)) \
            if dims else tuple(range(jrank))
        out_jshape = out_jshape or _jshape(node)
        if a.const is not None:
            fn = np.sum if kind == "sum" else np.max
            arr = self._full_const(a).astype(np.float32)
            return _RVal(out_jshape, const=np.asarray(
                fn(arr, axis=dims, keepdims=keepdim)))
        if dims != (jrank - 1,):
            raise RaiseError(
                f"reduce over axes {dims} of a rank-{jrank} value — only a "
                f"last-axis (column) reduction maps to the carried TensorIR "
                f"reduce", primitive=name, node=node.format_node())
        va = self._force_full(a, a.jshape)
        v = self.graph.emit("reduce", [va], kind=kind, axis=1, keepdims=True)
        return _RVal(out_jshape, val=v)

    def _h_sum(self, node, env):
        a = self._read(env, node.args[0])
        if _opname(node.target) == "aten.sum.default":
            return self._reduce(node, "sum", a, None, False)
        dims = self._arg(node, 1, "dim") or None
        return self._reduce(node, "sum", a, dims,
                            bool(self._arg(node, 2, "keepdim", False)))

    def _h_amax(self, node, env):
        a = self._read(env, node.args[0])
        dims = self._arg(node, 1, "dim") or None
        return self._reduce(node, "max", a, dims,
                            bool(self._arg(node, 2, "keepdim", False)))

    def _h_max_dim(self, node, env):
        a = self._read(env, node.args[0])
        dim = self._arg(node, 1, "dim")
        keep = bool(self._arg(node, 2, "keepdim", False))
        vals = self._reduce(node, "max", a, [dim], keep, out_jshape=tuple(
            int(d) for d in node.meta["val"][0].shape))
        idx = _RVal(vals.jshape, note="the indices of a max (integer dtype "
                                      "has no TensorIR representation)")
        return [vals, idx]

    def _h_mean(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        jrank = len(a.jshape)
        dims = None if name == "aten.mean.default" else \
            (self._arg(node, 1, "dim") or None)
        keep = name != "aten.mean.default" and \
            bool(self._arg(node, 2, "keepdim", False))
        axes = tuple(int(d) % max(jrank, 1) for d in dims) if dims \
            else tuple(range(jrank))
        if a.const is not None:
            arr = self._full_const(a).astype(np.float32)
            return _RVal(_jshape(node), const=np.asarray(
                np.mean(arr, axis=axes, keepdims=keep), np.float32))
        # a sum, then a division by the materialised count
        total = self._reduce(node, "sum", a, dims, keep)
        count = _RVal((), const=np.float32(
            math.prod(a.jshape[d] for d in axes)))
        return self._ewise_bin("div", total, count, _jshape(node), node)

    def _h_softmax(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        dim = int(node.args[1]) % max(len(a.jshape), 1)
        out = _jshape(node)
        if a.const is not None:
            x = self._full_const(a).astype(np.float32)
            e = np.exp(x - x.max(axis=dim, keepdims=True))
            return _RVal(out, const=e / e.sum(axis=dim, keepdims=True))
        if dim != len(a.jshape) - 1:
            raise RaiseError(f"softmax over axis {dim} of a rank-"
                             f"{len(a.jshape)} value", primitive=name,
                             node=node.format_node())
        kshape = out[:-1] + (1,)
        va = self._force_full(a, a.jshape)
        m = _RVal(kshape, val=self.graph.emit("reduce", [va], kind="max",
                                               axis=1, keepdims=True))
        # jax.nn.softmax's max starts from -inf, as the reference raises it
        m = self._ewise_bin("maximum", m, _RVal((), const=np.float32(
            -np.inf)), kshape, node)
        e = self._ewise_un("exp", self._ewise_bin("sub", a, m, out, node),
                           out, node)
        ve = self._force_full(e, out)
        s = _RVal(kshape, val=self.graph.emit("reduce", [ve], kind="sum",
                                               axis=1, keepdims=True))
        return self._ewise_bin("div", e, s, out, node)

    def _matmul(self, node, a: _RVal, b: _RVal, out_jshape) -> _RVal:
        name = _opname(node.target)
        if a.const is not None and b.const is not None:
            out = np.matmul(self._full_const(a).astype(np.float32),
                            self._full_const(b).astype(np.float32))
            return _RVal(out_jshape, const=out)
        if len(b.jshape) != 2:
            raise RaiseError(
                f"{name} rhs must be rank-2, got {tuple(b.jshape)}",
                primitive=name, node=node.format_node())
        va = self._force_full(a, a.jshape)
        k = int(a.jshape[-1])
        vb = self._mat(b, (k, int(b.jshape[1])))
        return _RVal(out_jshape, val=self.graph.emit("matmul", [va, vb]))

    def _h_mm(self, node, env):
        return self._matmul(node, self._read(env, node.args[0]),
                            self._read(env, node.args[1]), _jshape(node))

    def _h_bmm(self, node, env):
        name = _opname(node.target)
        a, b = self._read(env, node.args[0]), self._read(env, node.args[1])
        out = _jshape(node)
        if a.const is not None and b.const is not None:
            return self._matmul(node, a, b, out)
        if a.jshape[0] != 1 or b.jshape[0] != 1:
            raise RaiseError(f"{name} with a batch of {a.jshape[0]} (only a "
                             f"batch of 1 maps to matmul)", primitive=name,
                             node=node.format_node())

        def drop(rv):                           # the unit batch axis
            if rv.const is not None:
                return _RVal(rv.jshape[1:],
                             const=self._full_const(rv).reshape(rv.jshape[1:]))
            return dataclasses.replace(rv, jshape=rv.jshape[1:])
        res = self._matmul(node, drop(a), drop(b), out[1:])
        return dataclasses.replace(res, jshape=out)

    def _h_select(self, node, env):
        name = _opname(node.target)
        pred = self._read(env, node.args[0])
        cases = [self._read(env, node.args[2]), self._read(env, node.args[1])]
        out_jshape = _jshape(node)
        if pred.note is not None and "nan_guard" in pred.note:
            # the x != x / isnan guard: the guarded branch never fires for
            # finite float32 pipelines — take the main value
            return dataclasses.replace(cases[0], jshape=out_jshape)
        if pred.const is not None:
            p = _npc(pred.const)
            if p.dtype != np.bool_:
                p = p.astype(bool)
            p = np.broadcast_to(p, pred.jshape) if p.shape != tuple(
                pred.jshape) else p
            if not p.any():
                return dataclasses.replace(cases[0], jshape=out_jshape)
            if p.all():
                return dataclasses.replace(cases[1], jshape=out_jshape)
            pf = _RVal(tuple(pred.jshape), const=p.astype(np.float32))
            pn = _RVal(tuple(pred.jshape),
                       const=(1.0 - p.astype(np.float32)))
            t0 = self._ewise_bin("mul", cases[0], pn, out_jshape, node)
            t1 = self._ewise_bin("mul", cases[1], pf, out_jshape, node)
            return self._ewise_bin("add", t0, t1, out_jshape, node)
        raise RaiseError("select with a traced (non-constant) predicate",
                         primitive=name, node=node.format_node())

    def _h_ne(self, node, env):
        a, b = node.args[0], node.args[1]
        out = _jshape(node)
        if a is b:                               # x != x: the NaN guard
            return _RVal(out, note="nan_guard comparison x != x")
        ra, rb = self._read(env, a), self._read(env, b)
        if ra.const is not None and rb.const is not None:
            return _RVal(out, const=np.asarray(_npc(ra.const)
                                               != _npc(rb.const)))
        return _RVal(out, note=f"non-constant comparison "
                               f"{_opname(node.target)!r} (boolean dtype "
                               f"has no TensorIR representation)")

    def _h_isnan(self, node, env):
        a = self._read(env, node.args[0])
        if a.const is not None:
            return _RVal(_jshape(node), const=np.isnan(_npc(a.const)))
        return _RVal(_jshape(node), note="nan_guard isnan(x)")

    def _h_create(self, node, env):
        """zeros / ones / full / arange (and their ``_like`` forms)."""
        name = _opname(node.target)
        shape = _jshape(node)
        dt = _np_dtype(node.meta["val"].dtype)
        base = name.split(".")[1]
        if base in ("zeros", "zeros_like"):
            arr = np.zeros(shape, dt)
        elif base in ("ones", "ones_like"):
            arr = np.ones(shape, dt)
        elif base in ("full", "full_like"):
            arr = np.full(shape, node.args[1], dt)
        elif base == "scalar_tensor":
            arr = np.asarray(node.args[0], dt)
        elif base == "arange":
            arr = np.arange(*node.args).astype(dt)
        else:                                    # pragma: no cover
            raise RaiseError(f"creation op {name}", primitive=name)
        return _RVal(shape, const=arr)

    def _h_cumsum(self, node, env):
        name = _opname(node.target)
        a = self._read(env, node.args[0])
        out_jshape = _jshape(node)
        axis = int(node.args[1]) % max(len(a.jshape), 1)
        if a.const is not None:
            arr = self._full_const(a).astype(np.float32)
            return _RVal(out_jshape, const=np.cumsum(arr, axis=axis))
        if len(a.jshape) != 2 or axis != 0:
            raise RaiseError(
                f"cumsum over axis {axis} of a rank-{len(a.jshape)} value — "
                f"TensorIR scan runs over axis 0 of a rank-2 value",
                primitive=name, node=node.format_node())
        va = self._force_full(a, a.jshape)
        v = self.graph.emit("scan", [va], kind="cumsum", axis=0)
        self.scan_lengths.append(int(a.jshape[0]))
        return _RVal(out_jshape, val=v)

    def _h_scan(self, node, env):
        text = node.format_node()
        body = env[node.args[0]]
        init, xs = list(node.args[1]), list(node.args[2])
        outer = list(node.args[3]) if len(node.args) > 3 else []
        if len(init) != 1:
            raise RaiseError(f"scan with {len(init)} carries (only a single "
                             f"carried state raises)", primitive=_SCAN,
                             node=text)
        outer_rv = [self._read(env, x) for x in outer]
        carry_rv = self._read(env, init[0])
        xs_rv = [self._read(env, x) for x in xs]
        if carry_rv.const is None or np.any(_npc(carry_rv.const) != 0):
            raise RaiseError(
                "scan carry must be initialised to a constant zero array "
                "(h_0 = 0 in the carried TensorIR scan)",
                primitive=_SCAN, node=text)
        if len(carry_rv.jshape) > 1:
            raise RaiseError(
                f"scan carry of rank {len(carry_rv.jshape)} (the rank-2 "
                f"TensorIR scan carries one row)", primitive=_SCAN,
                node=text)
        for rv in xs_rv:
            if len(rv.jshape) < 2 and rv.const is None:
                raise RaiseError(
                    "scan over a rank-1 traced sequence (time must be a row "
                    "axis in the rank-2 layout)", primitive=_SCAN, node=text)
        alpha, beta = _linear_body(body, len(xs_rv), len(outer_rv))
        metas = node.meta["val"]
        if len(metas) != 2:
            raise RaiseError("scan with more than one stacked output",
                             primitive=_SCAN, node=text)
        ys_jshape = tuple(int(d) for d in metas[1].shape)
        if _e_is_one(alpha):                     # h_t = h_{t-1} + u_t
            u = self._eval_expr(beta, xs_rv, outer_rv)
            vu = self._force_full(u, ys_jshape)
            v = self.graph.emit("scan", [vu], kind="cumsum", axis=0)
        else:
            a = self._eval_expr(alpha, xs_rv, outer_rv)
            u = self._eval_expr(beta, xs_rv, outer_rv)
            va = self._force_full(a, ys_jshape)
            vu = self._force_full(u, ys_jshape)
            v = self.graph.emit("scan", [va, vu], kind="linear", axis=0)
        self.scan_lengths.append(int(xs_rv[0].jshape[0]))
        ys = _RVal(ys_jshape, val=v)
        final = _RVal(tuple(int(d) for d in metas[0].shape),
                      note="the scan's final carry (only the full h_t "
                           "sequence is materialised by TensorIR scan)")
        return [final, ys]

    def _h_getitem(self, node, env):
        return env[node.args[0]][node.args[1]]

    # ---- driver -----------------------------------------------------------

    _HANDLERS: Dict[str, Callable] = {}

    def run(self, gm: torch.fx.GraphModule,
            invals: List[_RVal]) -> List[_RVal]:
        env: Dict[Any, Any] = {}
        phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(phs) != len(invals):
            raise RaiseError("graph arity mismatch")
        env.update(zip(phs, invals))
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                obj = getattr(gm, node.target)
                if isinstance(obj, torch.Tensor):
                    arr = _npc(obj)
                    env[node] = _RVal(tuple(arr.shape), const=arr)
                else:                            # a scan body
                    env[node] = obj
                continue
            if node.op == "output":
                outs = node.args[0]
                if isinstance(outs, torch.fx.Node):
                    outs = [outs]
                return [self._read(env, o) for o in outs]
            if node in self._done:
                env[node] = self._done.pop(node)
                continue
            name = _opname(node.target)
            handler = self._HANDLERS.get(name)
            if handler is None:
                raise RaiseError(
                    f"primitive {name!r} is outside the raisable vocabulary",
                    primitive=name, node=node.format_node())
            try:
                env[node] = handler(self, node, env)
            except RaiseError:
                raise
            except Exception as e:               # defensive: name the site
                raise RaiseError(f"failed to raise: {e}", primitive=name,
                                 node=node.format_node())
        raise RaiseError("graph without an output node")

    def output_value(self, rv: _RVal) -> Value:
        return self._force_full(rv, rv.jshape)


_H = _Raiser._HANDLERS
_H.update({p: _Raiser._h_bin for p in _BIN_OPS})
_H.update({p: _Raiser._h_un for p in _UN_OPS})
_H.update({p: _Raiser._h_fold_only for p in _FOLD_ONLY})
_H.update({p: _Raiser._h_identity for p in _IDENTITY_OPS})
_H.update({p: _Raiser._h_noop for p in _NOOP_OPS})
_H.update({p: _Raiser._h_view for p in _VIEW_OPS})
_H.update({p: _Raiser._h_create for p in (
    "aten.zeros.default", "aten.ones.default", "aten.full.default",
    "aten.zeros_like.default", "aten.ones_like.default",
    "aten.full_like.default", "aten.scalar_tensor.default",
    "aten.arange.default", "aten.arange.start",
    "aten.arange.start_step")})
_H.update({
    "aten.rsub.Scalar": _Raiser._h_rsub,
    "aten.rsub.Tensor": _Raiser._h_rsub,
    "aten.relu.default": _Raiser._h_relu,
    "aten.silu.default": _Raiser._h_silu,
    "aten.gelu.default": _Raiser._h_gelu,
    "aten.softplus.default": _Raiser._h_softplus,
    "aten.reciprocal.default": _Raiser._h_reciprocal,
    "aten.pow.Tensor_Scalar": _Raiser._h_pow,
    "aten.expand.default": _Raiser._h_expand,
    "aten.permute.default": _Raiser._h_permute,
    "aten.t.default": _Raiser._h_permute,
    "aten.transpose.int": _Raiser._h_permute,
    "aten.sum.dim_IntList": _Raiser._h_sum,
    "aten.sum.default": _Raiser._h_sum,
    "aten.amax.default": _Raiser._h_amax,
    "aten.max.dim": _Raiser._h_max_dim,
    "aten.mean.dim": _Raiser._h_mean,
    "aten.mean.default": _Raiser._h_mean,
    "aten._softmax.default": _Raiser._h_softmax,
    "aten.mm.default": _Raiser._h_mm,
    "aten.bmm.default": _Raiser._h_bmm,
    "aten.where.self": _Raiser._h_select,
    "aten.ne.Tensor": _Raiser._h_ne,
    "aten.ne.Scalar": _Raiser._h_ne,
    "aten.isnan.default": _Raiser._h_isnan,
    "aten.cumsum.default": _Raiser._h_cumsum,
    _SCAN: _Raiser._h_scan,
    "getitem": _Raiser._h_getitem,
})
del _H


# --------------------------------------------------------------------------
# public artifact
# --------------------------------------------------------------------------


def _to_numpy(o) -> np.ndarray:
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    return np.asarray(o)


@dataclasses.dataclass
class RaisedGraph:
    """A TensorIR graph raised from a traced PyTorch function.

    ``graph`` takes the user arguments (``arg0``...) first, then the
    lazily-materialised constants (``c0``...); :meth:`bind` rebuilds the
    full positional input list from just the user arguments.
    """

    graph: Graph
    const_bindings: Dict[str, np.ndarray]
    n_args: int
    arg_shapes: List[Tuple[int, ...]]
    out_shapes: List[Tuple[int, ...]]
    scan_lengths: List[int]

    @property
    def unlowerable_ops(self) -> List[str]:
        return sorted({op.opname for op in self.graph.ops
                       if op.opname not in _LOWERABLE_OPS})

    @property
    def lowerable(self) -> bool:
        return not self.unlowerable_ops

    def bind(self, *args) -> List[np.ndarray]:
        if len(args) != self.n_args:
            raise ValueError(f"{self.graph.name} takes {self.n_args} "
                             f"arguments, got {len(args)}")
        bound = []
        for v, a in zip(self.graph.inputs[:self.n_args], args):
            arr = np.asarray(_to_numpy(a), np.float32).reshape(v.type.shape)
            bound.append(arr)
        for v in self.graph.inputs[self.n_args:]:
            bound.append(self.const_bindings[v.name])
        return bound

    def run_ref(self, *args) -> List[np.ndarray]:
        outs = self.graph.eval_np(*self.bind(*args))
        return [o.reshape(s) for o, s in zip(outs, self.out_shapes)]

    def compile(self, **kw):
        from . import pipeline
        return pipeline.compile_traced(self.graph, **kw)

    def run_compiled(self, compiled, *args, backend: str = "torch"):
        """Run a compiled artifact of this graph on the user arguments:
        ``ref`` (the LoopIR numpy oracle), ``torch`` (eager PyTorch) or
        ``cuda`` (the emitted kernels; their plain version on the CPU)."""
        fn = {"ref": compiled.run_ref, "torch": compiled.run_torch,
              "cuda": compiled.run_cuda}[backend]
        if fn is None:
            raise ValueError(f"{self.graph.name}: no {backend} backend was "
                             f"emitted")
        outs = fn(*self.bind(*args))
        if isinstance(outs, (torch.Tensor, np.ndarray)):
            outs = [outs]                # the emitted kernels' one output
        return [_to_numpy(o).reshape(s)
                for o, s in zip(outs, self.out_shapes)]

    def explore(self, **kw):
        from . import dse
        return dse.explore(self.graph, **kw)


def _as_example(s) -> torch.Tensor:
    """A spec (a shape, an array or a tensor) -> the f32 CPU tensor the
    trace runs on (only its shape matters)."""
    shape = tuple(s.shape) if hasattr(s, "shape") else tuple(s)
    return torch.zeros(shape, dtype=torch.float32)


def _sanitize(name: str) -> str:
    return re.sub(r"[^\w.\-]", "_", name)


def raise_fx(fn: Callable, *in_specs, name: Optional[str] = None,
             check_hlo_trips: bool = False) -> RaisedGraph:
    """Trace ``fn`` at ``in_specs`` (shapes / arrays / tensors) with
    ``make_fx`` and raise the ATen graph into a TensorIR
    :class:`RaisedGraph`.

    ``check_hlo_trips=True`` raises :class:`RaiseError`: there is no
    compiled HLO whose ``while``-loop trip counts could cross-check the
    raised scan lengths, as the reference's option does.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    if check_hlo_trips:
        raise RaiseError(
            "check_hlo_trips needs the while-loop trip counts of a compiled "
            "HLO module, and a traced PyTorch function compiles to no HLO")

    examples = [_as_example(s) for s in in_specs]
    with torch.no_grad():
        # fake tracing (the scan op's outputs are fake tensors); captured
        # real tensors stay constants (``get_attr``)
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*examples)
    gname = _sanitize(name or getattr(fn, "__name__", "raised"))
    r = _Raiser(gname)
    invals = []
    for i, a in enumerate(examples):
        v = r.graph.add_input(f"arg{i}", TensorType(canon2d(a.shape)))
        invals.append(_RVal(tuple(a.shape), val=v))
    outs = r.run(gm, invals)
    out_vals = [r.output_value(rv) for rv in outs]
    r.graph.set_outputs(*out_vals)
    r.graph.verify()
    return RaisedGraph(graph=r.graph, const_bindings=r.const_bindings,
                       n_args=len(examples),
                       arg_shapes=[tuple(a.shape) for a in examples],
                       out_shapes=[tuple(rv.jshape) for rv in outs],
                       scan_lengths=list(r.scan_lengths))


# --------------------------------------------------------------------------
# hand-written kernel mirrors (equivalence targets for tests)
# --------------------------------------------------------------------------


def _flash_fn(q, kt, v, mask):
    s = q @ kt + mask
    m = torch.amax(s, dim=1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=1, keepdim=True)
    return (p @ v) / l


def reference_flash(sq: int, sk: int, d: int,
                    name: Optional[str] = None) -> RaisedGraph:
    """Raise the torch spelling of flash attention; canonical-identical to
    ``frontend.flash_attention_graph(sq, sk, d)``."""
    return raise_fx(_flash_fn, (sq, d), (d, sk), (sk, d), (sq, sk),
                    name=name or f"flash_{sq}x{sk}x{d}")


def reference_decode(rep: int, smax: int, hd: int,
                     name: Optional[str] = None) -> RaisedGraph:
    return raise_fx(_flash_fn, (rep, hd), (hd, smax), (smax, hd),
                    (rep, smax), name=name or f"decode_{rep}x{smax}x{hd}")


def reference_ssd(s: int, p: int, n: int,
                  name: Optional[str] = None) -> RaisedGraph:
    """Raise the torch spelling of the SSD recurrence; canonical-identical
    to ``frontend.ssd_scan_graph(s, p, n)``."""
    pn = p * n

    def f(a, u, ct, g):
        h = _scan_linear(a, u)
        return (h * ct) @ g
    return raise_fx(f, (s, pn), (s, pn), (s, pn), (pn, p),
                    name=name or f"ssd_{s}x{p}x{n}")


# --------------------------------------------------------------------------
# per-config model blocks
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BlockReport:
    """One per-config forward-pass region and its raising outcome.
    ``fn`` takes and returns torch tensors; ``example_inputs`` are the
    numpy arrays it is raised and checked at."""

    config: str
    block: str
    fn: Callable
    example_inputs: Tuple[np.ndarray, ...]
    raised: Optional[RaisedGraph] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.raised is not None


def model_block_suite(config_name: str, seq: int = 8, seed: int = 0
                      ) -> Dict[str, Tuple[Callable, tuple]]:
    """The fused forward-pass regions of one (reduced) config, as plain
    torch functions over example inputs — the raising corpus.

    The example inputs and captured weights are drawn from
    ``np.random.default_rng(seed)`` in a fixed order; the MLP's params come
    from the model's own initialiser (``layers.Maker`` on a seeded torch
    generator).  Deliberately includes regions known to be outside the
    vocabulary (rope's slice, the MoE router's top-k) so the raisability
    table and the diagnostics tests have real negative rows.
    """
    from ..configs.base import get_config, reduced
    from ..models import layers as L

    cfg = reduced(get_config(config_name))
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    kinds = set(cfg.layer_kinds())

    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    blocks: Dict[str, Tuple[Callable, tuple]] = {}
    x = randn(1, seq, d)
    w_norm = tensor(randn(d, scale=0.1))
    blocks["rmsnorm"] = (
        lambda x: L.rmsnorm(x, w_norm, cfg.norm_eps), (x,))

    has_dense_mlp = bool(kinds & {"attn", "rglru"}) or (
        cfg.moe is not None and cfg.moe.first_dense_layers > 0)
    if has_dense_mlp:
        mk = L.Maker("init", torch.Generator().manual_seed(seed),
                     device="cpu")
        mlp_p = L.init_mlp(cfg, mk)
        blocks["mlp"] = (lambda x: L.apply_mlp(mlp_p, x, cfg), (x,))

    vocab = min(cfg.vocab_size, 256)
    w_head_norm = tensor(randn(d, scale=0.1))
    if cfg.tie_embeddings:
        w_emb = tensor(randn(vocab, d, scale=0.05))

        def head(x):
            h = L.rmsnorm(x, w_head_norm, cfg.norm_eps)
            return torch.einsum("bsd,vd->bsv", h, w_emb)
    else:
        w_head = tensor(randn(d, vocab, scale=0.05))

        def head(x):
            h = L.rmsnorm(x, w_head_norm, cfg.norm_eps)
            return torch.einsum("bsd,dv->bsv", h, w_head)
    blocks["head"] = (head, (x,))

    if "attn" in kinds or cfg.encoder is not None or cfg.mla is not None:
        hd = cfg.resolved_head_dim
        scale = 1.0 / np.sqrt(hd)
        mask = np.where(np.arange(seq)[:, None] >= np.arange(seq)[None, :],
                        0.0, -1e30).astype(np.float32)
        blocks["attn_softmax"] = (
            _flash_fn, (randn(seq, hd, scale=scale), randn(hd, seq),
                        randn(seq, hd), mask))

        x4 = randn(1, seq, 2, hd if hd % 2 == 0 else hd + 1)
        positions = torch.arange(seq, dtype=torch.int32)[None, :]
        blocks["rope"] = (
            lambda x4: L.rope(x4, positions, cfg.rope_theta), (x4,))

    if "ssd" in kinds:
        p_dim, n_dim = 4, 4
        pn = p_dim * n_dim
        a = rng.uniform(0.2, 0.95, (seq, pn)).astype(np.float32)
        g = np.kron(np.eye(p_dim), np.ones((n_dim, 1))).astype(np.float32)

        def ssd_core(a, u, ct, g):
            h = _scan_linear(a, u)
            return (h * ct) @ g
        blocks["ssd_core"] = (ssd_core,
                              (a, randn(seq, pn), randn(seq, pn), g))

    if "rglru" in kinds:
        w = (cfg.rglru.width or d) if cfg.rglru is not None else d
        c = cfg.rglru.c if cfg.rglru is not None else 8.0
        a_param = tensor(randn(w))

        def rglru_core(x2, a_gate, i_gate):
            log_a = -c * torch.nn.functional.softplus(a_param)[None, :] \
                * torch.sigmoid(a_gate)
            a = torch.exp(log_a)
            gated = torch.sigmoid(i_gate) * x2
            mult = torch.sqrt(torch.maximum(1.0 - a * a, torch.tensor(1e-9)))
            h0 = torch.zeros((x2.shape[1],), dtype=torch.float32)
            return scan_hop(lambda h, a_t, gx_t, m_t: a_t * h + m_t * gx_t,
                            h0, (a, gated, mult))
        blocks["rglru_core"] = (
            rglru_core, (randn(seq, w), randn(seq, w), randn(seq, w)))

    if cfg.moe is not None:
        n_exp = cfg.moe.num_experts
        top_k = cfg.moe.top_k
        w_router = tensor(randn(d, n_exp, scale=0.05))

        def moe_router(x2):
            logits = x2 @ w_router
            probs = torch.softmax(logits, dim=-1)
            vals, _ = torch.topk(probs, top_k)
            return vals
        blocks["moe_router"] = (moe_router, (randn(seq, d),))

    return blocks


def raise_model_blocks(config_name: str, seq: int = 8, seed: int = 0,
                       check_hlo_trips: bool = False) -> List[BlockReport]:
    """Raise every block of one config; failures become diagnostics, not
    exceptions."""
    suite = model_block_suite(config_name, seq=seq, seed=seed)
    reports = []
    for block, (fn, inputs) in suite.items():
        rep = BlockReport(config=config_name, block=block, fn=fn,
                          example_inputs=tuple(inputs))
        try:
            rep.raised = raise_fx(
                fn, *inputs, name=f"{config_name}.{block}",
                check_hlo_trips=check_hlo_trips)
        except RaiseError as e:
            rep.error = str(e)
        reports.append(rep)
    return reports


def raising_report(config_name: str, seq: int = 8, seed: int = 0) -> str:
    """Human-readable per-block raising report (used by ``reproc --raise
    CONFIG`` and the generated docs)."""
    reports = raise_model_blocks(config_name, seq=seq, seed=seed)
    lines = [f"// raising report for config {config_name} "
             f"(seq={seq}, reduced)"]
    for rep in reports:
        if rep.ok:
            rg = rep.raised
            lines.append(f"// block {rep.block}: RAISED — "
                         f"{len(rg.graph.ops)} ops, "
                         f"{len(rg.graph.inputs) - rg.n_args} captured "
                         f"consts, lowerable={rg.lowerable}")
            lines.append(str(rg.graph))
        else:
            first = rep.error.splitlines()[0]
            lines.append(f"// block {rep.block}: NOT RAISABLE — {first}")
    return "\n".join(lines) + "\n"
