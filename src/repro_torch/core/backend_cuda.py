"""CUDA backend: emit Hopper kernels from scheduled LoopIR.

The port of ``backend_pallas.py``'s two emitters, with its dispatch:
``emit`` tries the contraction classifier ``_analyze`` first and falls
through to the general multi-nest emitter ``emit_general`` only when
``_analyze`` refuses the kernel.

**The contraction emitter** (``_analyze``, ``_emit_gemm``,
``_apply_epilogue``) accepts a single scheduled contraction nest::

    Loop(g0 @grid) { Loop(g1 @grid) { [Loop(g2 @grid)]
        [ZeroTile(acc)]
        ( Loop(k @seq|@unrolled|@grid) { MatmulTile(acc, A, B) } | MatmulTile )
        [EwiseTile epilogue ...]*
    }}}

and renders it as CUDA C++ source on the templates in ``kernels/csrc/``
(``stagecc_gemm.cuh``, and ``stagecc_gemm_ffma.cuh`` /
``stagecc_gemm_sm90.cuh`` where the plan's tiles and types allow; the
pure ``_gemm_route`` picks one per call): the tiles (tm, tn, tk) as constants,
whether the k tiles' f32 products are summed in f32 (``tpu_mxu``: K
inside the block) or rounded to the output dtype after each tile
(``tpu_mxu_kgrid``: the reference revisits its output block along a k
grid axis), the element types, and the ``EwiseTile`` epilogue chain as a
generated ``__device__`` functor.  On CPU tensors the emitted callable
runs ``gemm_plain``, the plain PyTorch version of the same arithmetic.
It takes the reference's five element types (f16, int32 and int8 on the
``simt`` template), epilogue inputs of any block spec the reference's
epilogue broadcasts, and a grid that covers only part of the arrays;
a contraction whose tiles it cannot index goes to the general emitter.

**The general emitter** (``emit_general``, after ``_emit_stage``) takes
what the classifier refuses: the ``nested`` / ``inner_flattened``
schedules and the multi-nest serving-kernel graphs.  Each top-level nest
is a stage: its leading @grid chain, the independent loops below it and,
where that leaves SMs idle, a split of row-local tiles are the CUDA
blocks; every other loop is a C loop in the block, scratch lives in
shared memory (or, where it does not fit, in a per-block workspace in
global memory), and every statement is a block-cooperative loop over
its tile (``kernels/csrc/stagecc_stage.cuh``).  One source holds every stage of a kernel.  On CPU
tensors the callable runs ``general_plain``, which executes each stage
as the Pallas body does, in PyTorch.

Sources are built by nvcc at the first launch on a CUDA tensor
(``kernels/_build.load_source``).  On a CUDA tensor the kernel launches
or the call raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
import re
import struct
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.kernels import _build

from .backend_torch import _EWISE, _TORCH_DTYPE, as_tensor
from .loop_ir import (AffineExpr, Buffer, EwiseTile, FillTile, Kernel, Loop,
                      LoopKind, MatmulTile, MemSpace, ReduceTile, ScanTile,
                      Stmt, TileRef, ZeroTile, _stmt_refs, _stmt_written_refs)
from .schedule import carry_axis_reason
from .tensor_ir import TensorType


class EmitError(NotImplementedError):
    """Raised when a kernel is outside the emitter's structured subset."""


@dataclasses.dataclass
class _Plan:
    grid_vars: List[str]                 # outer -> inner
    grid: Tuple[int, ...]
    inner_body: List[Stmt]
    k_loop: Optional[Loop]               # reduction loop inside block, if any
    k_grid_var: Optional[str]            # reduction on the grid, if any
    in_buffers: List[str]
    out_buffer: str
    block_specs: Dict[str, Tuple[Tuple[int, ...], Tuple[object, ...]]]
    acc_name: Optional[str]
    matmul: Optional[MatmulTile] = None
    dtypes: Dict[str, str] = dataclasses.field(default_factory=dict)
    shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    @property
    def tiles(self) -> Tuple[int, int, int]:
        """(tm, tn, tk) of the contraction."""
        tm, tk = self.matmul.lhs.tile[-2:]
        return tm, self.matmul.rhs.tile[-1], tk

    @property
    def epilogue(self) -> List[EwiseTile]:
        return [s for s in self.inner_body if isinstance(s, EwiseTile)]

    @property
    def epilogue_inputs(self) -> List[str]:
        """The HBM inputs other than the two operands, in call order."""
        ops = (self.matmul.lhs.buffer.name, self.matmul.rhs.buffer.name)
        return [n for n in self.in_buffers if n not in ops]


def _analyze(kernel: Kernel) -> _Plan:
    kernel.verify()
    # 1. peel GRID loops
    grid_vars: List[str] = []
    grid: List[int] = []
    stmts = kernel.body
    if len(stmts) != 1 or not isinstance(stmts[0], Loop):
        raise EmitError(f"{kernel.name}: body must be a single loop nest")
    cur: Stmt = stmts[0]
    while isinstance(cur, Loop) and cur.kind == LoopKind.GRID:
        grid_vars.append(cur.var.name)
        grid.append(cur.var.extent)
        if len(cur.body) == 1 and isinstance(cur.body[0], Loop) \
                and cur.body[0].kind == LoopKind.GRID:
            cur = cur.body[0]
        else:
            inner = cur.body
            break
    else:
        raise EmitError(f"{kernel.name}: no GRID loops — run a schedule first")

    if not grid_vars:
        raise EmitError(f"{kernel.name}: no GRID loops")

    # 2. classify the inner statements
    acc_name = None
    k_loop = None
    k_grid_var = None
    matmul: Optional[MatmulTile] = None
    for s in inner:
        if isinstance(s, ZeroTile):
            if s.dst.buffer.space == MemSpace.VREG:
                acc_name = s.dst.buffer.name
        elif isinstance(s, Loop):
            if len(s.body) != 1 or not isinstance(s.body[0], MatmulTile):
                raise EmitError(f"{kernel.name}: reduction loop body must be "
                                f"a single MatmulTile")
            if s.kind == LoopKind.GRID:
                # reduction mapped onto the grid (time-multiplexed schedule):
                # hoist it as the innermost grid dimension; the emitted
                # kernel walks it as an in-block loop, in order.
                grid_vars.append(s.var.name)
                grid.append(s.var.extent)
                k_grid_var = s.var.name
                matmul = s.body[0]
                continue
            if k_loop is not None or s.kind not in (LoopKind.SEQUENTIAL,
                                                    LoopKind.UNROLLED):
                raise EmitError(f"{kernel.name}: unsupported inner loop {s.var}")
            k_loop = s
            matmul = s.body[0]
        elif isinstance(s, MatmulTile):
            matmul = s
            kvars = [v for e in (*s.lhs.index, *s.rhs.index)
                     for v, _ in e.coeffs if v in grid_vars[2:]]
            if kvars:
                k_grid_var = kvars[0]
        elif isinstance(s, EwiseTile):
            pass
        else:
            raise EmitError(f"{kernel.name}: unsupported stmt {s}")
    if matmul is None:
        raise EmitError(f"{kernel.name}: no MatmulTile found")
    # a 3-long grid means k lives on the grid
    if len(grid_vars) == 3:
        k_grid_var = grid_vars[2]

    # HBM buffers *written* inside the block that are not the kernel
    # output are SSA temporaries left by fusion; the emitter forwards
    # their values through registers instead of materialising them.
    out_names_ = {b.name for b in kernel.outputs}
    written = set()
    for s in inner:
        if isinstance(s, (ZeroTile, MatmulTile, EwiseTile)) \
                and s.dst.buffer.space == MemSpace.HBM \
                and s.dst.buffer.name not in out_names_:
            written.add(s.dst.buffer.name)

    # 3. build block specs for every HBM buffer touched
    inner_vars = {} if k_loop is None else {k_loop.var.name: k_loop.var.extent}
    specs: Dict[str, Tuple[Tuple[int, ...], Tuple[object, ...]]] = {}

    def visit(ref: TileRef):
        if ref.buffer.space != MemSpace.HBM or ref.buffer.name in written:
            return
        block: List[int] = []
        imap: List[object] = []   # either a grid-var name or 0
        for d, e in enumerate(ref.index):
            t = ref.tile[d]
            if not e.coeffs:
                # constant index: block covers [const*t, const*t + t)
                if e.const != 0:
                    raise EmitError(f"{kernel.name}: non-zero const index")
                block.append(t)
                imap.append(0)
            elif len(e.coeffs) == 1:
                v, stride = e.coeffs[0]
                if stride != 1:
                    raise EmitError(f"{kernel.name}: strided index on {v}")
                if v in grid_vars:
                    block.append(t)
                    imap.append(v)
                elif v in inner_vars:
                    block.append(t * inner_vars[v])
                    imap.append(0)
                else:
                    raise EmitError(f"{kernel.name}: unbound index var {v}")
            else:
                raise EmitError(f"{kernel.name}: multi-var affine index "
                                f"(apply split+grid only)")
        prev = specs.get(ref.buffer.name)
        spec = (tuple(block), tuple(imap))
        if prev is not None and prev != spec:
            raise EmitError(f"{kernel.name}: inconsistent refs to "
                            f"{ref.buffer.name}: {prev} vs {spec}")
        specs[ref.buffer.name] = spec

    for s in inner:
        if isinstance(s, Loop):
            for b in s.body:
                if isinstance(b, MatmulTile):
                    visit(b.dst), visit(b.lhs), visit(b.rhs)
        elif isinstance(s, ZeroTile):
            visit(s.dst)
        elif isinstance(s, MatmulTile):
            visit(s.dst), visit(s.lhs), visit(s.rhs)
        elif isinstance(s, EwiseTile):
            visit(s.dst)
            for r in s.srcs:
                visit(r)

    out_names = [b.name for b in kernel.outputs]
    if len(out_names) != 1:
        raise EmitError(f"{kernel.name}: exactly one output supported")
    out = out_names[0]
    ins = [b.name for b in kernel.params
           if b.name in specs and b.name != out]
    return _Plan(grid_vars=grid_vars, grid=tuple(grid), inner_body=inner,
                 k_loop=k_loop, k_grid_var=k_grid_var, in_buffers=ins,
                 out_buffer=out, block_specs=specs, acc_name=acc_name,
                 matmul=matmul,
                 dtypes={b.name: b.type.dtype
                         for b in kernel.params + kernel.scratch},
                 shapes={b.name: b.shape for b in kernel.params})


def emit(kernel: Kernel, device="cuda") -> Callable[..., torch.Tensor]:
    """Emit ``f(*hbm_inputs) -> out`` for a scheduled kernel.

    Dispatch, as ``backend_pallas.emit``: the single-nest contraction
    classifier (``_analyze``) first, and the general multi-nest emitter
    (``emit_general``) only where the classifier refuses.  A contraction
    the classifier takes whose tiles the GEMM template cannot index (rank
    other than 2, or not tiled by the grid's row and column variables:
    ``_Untiled``) goes to the general emitter, which sums the same k tiles
    in the same order; any other refusal of the template stands
    (:class:`EmitError`).  numpy
    inputs go to ``device``; tensor inputs stay where they are.  All
    inputs on the CPU run the plain version; on a CUDA device the emitted
    kernel launches, or the call raises."""
    try:
        plan = _analyze(kernel)
    except EmitError:
        return emit_general(kernel, device)
    try:
        return _emit_gemm(kernel, device, plan)
    except _Untiled as why:
        try:
            return emit_general(kernel, device)
        except EmitError:
            raise why from None


# C type of each element type, the five of TensorIR
_CTYPE = {"float32": "float", "bfloat16": "__nv_bfloat16",
          "float16": "__half", "int32": "int", "int8": "int8_t"}
_INTS = ("int32", "int8")

# ops whose result is float32 on integer operands (jnp's true divide and
# transcendental functions); the others keep the operands' type
_FLOAT_OPS = ("div", "exp", "tanh", "sigmoid", "sqrt", "rsqrt", "log1p",
              "gelu")

# the integer ops as C expressions over int operands; sums and products
# wrap modulo 2^32 (in unsigned arithmetic, which C defines)
_EWISE_INT = {
    "add": "(int)((unsigned)({0}) + (unsigned)({1}))",
    "sub": "(int)((unsigned)({0}) - (unsigned)({1}))",
    "mul": "(int)((unsigned)({0}) * (unsigned)({1}))",
    "maximum": "max({0}, {1})",
    "relu": "max({0}, 0)",
    "neg": "(int)(0u - (unsigned)({0}))",
    "abs": "(({0}) < 0 ? (int)(0u - (unsigned)({0})) : ({0}))",
    "copy": "{0}",
}

# epilogue ops as C expressions over float operands ({0}, {1}); each
# mirrors the entry of backend_torch._EWISE of the same name
_EWISE_CUDA = {
    "add": "({0} + {1})",
    "sub": "({0} - {1})",
    "mul": "({0} * {1})",
    "div": "({0} / {1})",
    "maximum": "fmaxf({0}, {1})",
    "relu": "fmaxf({0}, 0.f)",
    "gelu": ("(0.5f * {0} * (1.f + tanhf(0.7978845608028654f * "
             "({0} + 0.044715f * {0} * {0} * {0}))))"),
    "exp": "expf({0})",
    "neg": "(-{0})",
    "tanh": "tanhf({0})",
    "sigmoid": "(1.f / (1.f + expf(-{0})))",
    "sqrt": "sqrtf({0})",
    "rsqrt": "rsqrtf({0})",
    "log1p": "log1pf({0})",
    "abs": "fabsf({0})",
    "copy": "{0}",
}


class _Untiled(EmitError):
    """The contraction's tiles are not the template's row-major (i, j)
    tiling of rank-2 operands; ``emit`` hands such a kernel to the general
    emitter, which computes the same sums in the same order."""


def _geometry(plan: _Plan) -> Tuple[int, int, int]:
    """(row tiles, column tiles, k tiles) of the reference's grid: its
    tiles times these cover the part of the problem it computes, which
    may fall short of the arrays (the rest of the output is never
    written)."""
    ext = dict(zip(plan.grid_vars, plan.grid))
    (_, (row, col)) = plan.block_specs[plan.out_buffer]
    nk = (plan.k_loop.var.extent if plan.k_loop is not None
          else ext.get(plan.k_grid_var, 1))
    return ext[row], ext[col], nk


def _covers(plan: _Plan) -> bool:
    """Whether the grid covers the whole problem (the tiles divide it)."""
    tm, tn, tk = plan.tiles
    gm, gn, nk = _geometry(plan)
    m, k = plan.shapes[plan.matmul.lhs.buffer.name]
    kb, n = plan.shapes[plan.matmul.rhs.buffer.name]
    return ((gm * tm, gn * tn, nk * tk, kb) == (m, n, k, k)
            and plan.shapes[plan.out_buffer] == (m, n))


def _layout(kernel: Kernel, plan: _Plan) -> Dict[str, str]:
    """Check that the plan is a row-major (M, K) @ (K, N) -> (M, N)
    contraction the template takes (``_Untiled`` if not), and return how
    each epilogue input is indexed from the output element ``(row,
    col)``: ``col`` for an (N,) bias and ``row * n + col`` for an (M, N)
    input of the output's shape, else an offset from the input's block
    spec, broadcast over the (tm, tn) tile as the reference's epilogue
    broadcasts its block."""
    tm, tn, tk = plan.tiles
    lhs, rhs = plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name
    specs = [plan.block_specs[n] for n in (lhs, rhs, plan.out_buffer)]
    if any(len(block) != 2 for block, _ in specs):
        raise _Untiled(f"{kernel.name}: a matmul tile of rank other than 2 "
                       f"{plan.block_specs}")
    (_, (row, kl)), (_, (kr, col)) = specs[:2]
    if not (isinstance(row, str) and isinstance(col, str) and row != col
            and kl == kr
            and specs[2] == ((tm, tn), (row, col))):
        raise _Untiled(f"{kernel.name}: not an (i, j)-tiled contraction "
                       f"{plan.block_specs}")
    ext = dict(zip(plan.grid_vars, plan.grid))
    out_shape = plan.shapes[plan.out_buffer]
    index = {}
    for name in plan.epilogue_inputs:
        block, imap = plan.block_specs[name]
        if (block, imap) == ((tn,), (col,)):
            index[name] = "col"
            continue
        if (block, imap) == ((tm, tn), (row, col)) and \
                plan.shapes[name] == out_shape:
            index[name] = "row * n + col"
            continue
        if len(block) > 2:
            raise EmitError(f"{kernel.name}: epilogue input {name} has a "
                            f"rank-{len(block)} block {block}, which does "
                            f"not fit the (tm, tn) output block")
        terms = []
        for d, (b, v, st) in enumerate(zip(block, imap,
                                           _strides(plan.shapes[name]))):
            axis = 2 - len(block) + d         # numpy's trailing alignment
            coord, t = ("row", tm) if axis == 0 else ("col", tn)
            if b not in (1, t):
                raise EmitError(f"{kernel.name}: epilogue input {name}'s "
                                f"block {block} does not broadcast to "
                                f"({tm}, {tn})")
            # the block's index: the program's tile along the variable
            # (the epilogue runs at the last k tile), or 0
            if v == 0:
                tile = None
            elif v == row:
                tile = f"row / {tm}"
            elif v == col:
                tile = f"col / {tn}"
            elif v == plan.k_grid_var:
                tile = str(ext[v] - 1)
            else:
                raise EmitError(f"{kernel.name}: epilogue input {name} is "
                                f"indexed by %{v}")
            if b == t and tile == f"{coord} / {t}":
                idx = coord                   # the tile's origin plus coord
            else:
                parts = ([f"({tile}) * {b}"] if tile is not None else []) + \
                    ([f"{coord} % {t}"] if b == t else [])
                idx = " + ".join(parts) or "0"
            terms.append(f"({idx})" + (f" * {st}LL" if st != 1 else ""))
        index[name] = " + ".join(terms)
    return index


def _promote(*dtypes: str) -> str:
    """Result type of an elementwise op on values of these types, by JAX's
    promotion lattice over TensorIR's five types: one type stays; float32
    wins; bf16 with f16 is float32; a floating type wins over the
    integers; int8 with int32 is int32."""
    kinds = set(dtypes)
    if len(kinds) == 1:
        return kinds.pop()
    floats = kinds & {"bfloat16", "float16"}
    if "float32" in kinds or len(floats) == 2:
        return "float32"
    return floats.pop() if floats else "int32"


def _typed_op(op: str, args: Sequence[Tuple[str, str]],
              rounding: Dict[str, str]) -> Tuple[str, str]:
    """The C expression and element type of elementwise ``op`` on typed C
    values ``args`` ((expression, dtype) pairs), as the reference computes
    it: the promoted type (float32 for ``_FLOAT_OPS`` on integers); an
    integer result in int arithmetic, wrapped to int8 where it is int8; a
    floating one in f32 and rounded to bf16 or f16 where it has that type
    (``rounding`` holds each wrapper, a format string)."""
    dtype = _promote(*(t for _, t in args))
    if dtype in _INTS and op in _FLOAT_OPS:
        dtype = "float32"
    if dtype in _INTS:
        expr = _EWISE_INT[op].format(*(c for c, _ in args))
    else:
        expr = _EWISE_CUDA[op].format(*(
            f"(float)({c})" if t in _INTS else c for c, t in args))
    if dtype in rounding:
        expr = rounding[dtype].format(expr)
    return expr, dtype


def _vtype(dtype: str) -> str:
    """The C type a value of ``dtype`` is computed in."""
    return "int" if dtype in _INTS else "float"


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` as the reference's astype converts it: a float
    into an integer type truncates toward zero, saturates and takes NaN to
    0 (XLA's convert; PyTorch's own cast leaves those undefined)."""
    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.nan_to_num(x.double(), nan=0.0).clamp(info.min,
                                                        info.max).trunc()
    return x.to(dtype)


def _unwritten(t: torch.Tensor) -> torch.Tensor:
    """``t`` filled as the reference's interpret mode leaves an output
    element nothing writes: NaN, or the integer type's least value."""
    return t.fill_(float("nan") if t.is_floating_point()
                   else torch.iinfo(t.dtype).min)


def _fast_reason(plan: _Plan) -> Optional[str]:
    """Why neither faster template (``wgmma``, ``ffma``) can run the
    plan, or None: both take f32 and bf16 operands, outputs and epilogue
    inputs only, and a grid that covers the whole problem (their blocks
    divide M, N and K); the ``simt`` template takes every type and the
    grid's part of the problem."""
    for name in (plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name,
                 plan.out_buffer, *plan.epilogue_inputs):
        if plan.dtypes[name] not in ("float32", "bfloat16"):
            return f"{name} is {plan.dtypes[name]}"
    if not _covers(plan):
        return "the grid does not cover the problem"
    return None


def _plan_route(plan: _Plan) -> Optional[str]:
    """Why the plan's source cannot hold the tensor-core (``wgmma``) kernel
    of ``stagecc_gemm_sm90.cuh``, or None when it holds it: both operands
    bf16 (the tensor cores' bf16 products are exact; f32 stays on the CUDA
    cores, since TF32 would break the f32 bounds) and tk a multiple of 16
    (one wgmma takes 16 of K, and tk fixes where the sums round), and
    what both faster templates need (``_fast_reason``)."""
    why = _fast_reason(plan)
    if why:
        return why
    for name in (plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name):
        if plan.dtypes[name] != "bfloat16":
            return f"operand {name} is {plan.dtypes[name]}, not bfloat16"
    tk = plan.tiles[2]
    if tk % 16:
        return f"tk {tk} is not a multiple of 16"
    return None


def _operand_route(what: str, strides: Sequence[int], k_axis: int,
                   ptr: int, itemsize: int = 2) -> Optional[str]:
    """Why TMA (``wgmma``) or the 16-byte loads of the ``ffma`` kernel
    cannot read an operand of ``itemsize``-byte elements with these element
    strides (``k_axis`` the index of K's), or None: one unit stride (along
    K, else along M or N), the other a multiple of 16 bytes, a
    16-byte-aligned base.  The launchers take the major from the same
    test."""
    unit = k_axis if strides[k_axis] == 1 else 1 - k_axis
    if strides[unit] != 1:
        return f"{what} has no unit stride {tuple(strides)}"
    if strides[1 - unit] <= 0 or strides[1 - unit] * itemsize % 16:
        return f"{what}'s stride {strides[1 - unit]} is not 16 bytes apart"
    if ptr % 16:
        return f"{what}'s base is not 16-byte aligned"
    return None


def _ffma_plan_route(plan: _Plan) -> Optional[str]:
    """Why the plan's source cannot hold the register-tiled CUDA-core
    (``ffma``) kernel of ``stagecc_gemm_ffma.cuh``, or None when it holds
    it: tm and tn multiples of 64 (so its 64 x 64 blocks divide M and N)
    and tk a multiple of 8 (K is staged 8 or 16 columns at a time, and tk fixes
    where the sums round), and what both faster templates need
    (``_fast_reason``)."""
    why = _fast_reason(plan)
    if why:
        return why
    tm, tn, tk = plan.tiles
    if tm % 64 or tn % 64:
        return f"tiles {tm} x {tn} are not multiples of 64"
    if tk % 8:
        return f"tk {tk} is not a multiple of 8"
    return None


def _majors(a_strides: Sequence[int], b_strides: Sequence[int]) -> str:
    return (f"A {'K' if a_strides[1] == 1 else 'M'}-major, "
            f"B {'K' if b_strides[0] == 1 else 'N'}-major")


def _gemm_route(plan: _Plan, a_strides: Sequence[int],
                b_strides: Sequence[int], a_ptr: int = 0,
                b_ptr: int = 0) -> Tuple[str, str]:
    """The emitted GEMM's kernel for operands A (M, K) and B (K, N) with
    these element strides and data pointers: ``("wgmma", reason)`` for the
    tensor-core template, else ``("ffma", reason)`` for the register-tiled
    CUDA-core one, else ``("simt", reason)`` for the plain CUDA-core one
    (odd tiles such as 96 or 1, operands neither can read).  A pure
    function of its arguments, decided before the launch; all three are
    kernels of this repository, so this is a dispatch, not a fallback."""
    why = (_plan_route(plan)
           or _operand_route("A", a_strides, 1, a_ptr)
           or _operand_route("B", b_strides, 0, b_ptr))
    if not why:
        return "wgmma", f"bf16, tk % 16 == 0, {_majors(a_strides, b_strides)}"
    size = {"float32": 4, "bfloat16": 2}
    why_ffma = (_ffma_plan_route(plan)
                or _operand_route("A", a_strides, 1, a_ptr, size[
                    plan.dtypes[plan.matmul.lhs.buffer.name]])
                or _operand_route("B", b_strides, 0, b_ptr, size[
                    plan.dtypes[plan.matmul.rhs.buffer.name]]))
    if not why_ffma:
        return "ffma", (f"not wgmma ({why}); tiles multiples of 64, "
                        f"tk % 8 == 0, {_majors(a_strides, b_strides)}")
    return "simt", why if why == why_ffma else f"{why}; {why_ffma}"


def _render(kernel: Kernel, plan: _Plan, index: Dict[str, str]) -> str:
    """The CUDA source of the plan's kernel.  It names no buffer and no
    problem size, so contractions with equal tiles, types and epilogue
    render to one text and share one build."""
    tm, tn, tk = plan.tiles
    kgrid = plan.k_grid_var is not None
    out_t = plan.dtypes[plan.out_buffer]
    extras = plan.epilogue_inputs
    # the epilogue chain, as _apply_epilogue walks it, one float per SSA
    # value, rounded where the reference's value has the output's bf16 type
    acc_t = out_t if kgrid else "float32"
    env: Dict[str, Tuple[str, str]] = {}      # buffer -> (C value, dtype)
    if plan.acc_name is not None:
        env[plan.acc_name] = ("v", acc_t)
    val = ("v", acc_t)
    lines = []
    for n, s in enumerate(plan.epilogue):
        if s.op not in _EWISE_CUDA:
            raise EmitError(f"{kernel.name}: no CUDA epilogue for {s.op!r}")
        args = []
        for r in s.srcs:
            name = r.buffer.name
            if name in env:
                args.append(env[name])
            elif name == plan.out_buffer:
                args.append(val)
            elif name in index:
                args.append((f"stagecc::to_val(in{extras.index(name)}"
                             f"[{index[name]}])", plan.dtypes[name]))
            else:
                raise EmitError(f"epilogue src {name} not mapped")
        expr, dtype = _typed_op(s.op, args, _GEMM_ROUNDING)
        lines.append(f"    const {_vtype(dtype)} t{n} = {expr};  // {s.op}")
        env[s.dst.buffer.name] = val = (f"t{n}", dtype)
    result, result_t = env.get(plan.out_buffer, val)
    fields = "".join(f"  const {_CTYPE[plan.dtypes[e]]}* in{i};\n"
                     for i, e in enumerate(extras))
    params = "".join(f"const void* in{i}, " for i in range(len(extras)))
    inits = ", ".join(f"static_cast<const {_CTYPE[plan.dtypes[e]]}*>(in{i})"
                      for i, e in enumerate(extras))
    schedule = ("k tiles on the grid, rounded to the output type after "
                "each" if kgrid else "K inside the block, summed in f32")
    ta, tb = (_CTYPE[plan.dtypes[plan.matmul.lhs.buffer.name]],
              _CTYPE[plan.dtypes[plan.matmul.rhs.buffer.name]])
    sm90 = _plan_route(plan) is None
    ffma = _ffma_plan_route(plan) is None
    signature = f"""(const void* a, const void* b, {params}void* out,
    int m, int n, int k, long long sam, long long sak, long long sbk,
    long long sbn, long long ldo, void* stream)"""
    wgmma = "" if not sm90 else f"""
// the tensor-core route (backend_cuda._gemm_route; its grid covers the
// problem, so ldo is n)
extern "C" int stagecc_gemm_wgmma_launch{signature} {{
  return stagecc::launch_wgmma<{tk}, {str(kgrid).lower()}, {_CTYPE[out_t]}>(
      a, b, out, m, n, k, sam, sak, sbk, sbn, Epilogue{{{inits}}}, stream);
}}

// the dynamic shared memory a tensor-core launch asks for, in bytes
extern "C" int stagecc_gemm_wgmma_smem() {{ return stagecc::wg::kSmem; }}
"""
    ffma_launch = "" if not ffma else f"""
// the register-tiled CUDA-core route (ffma): blocks of 64 x 64 outputs
// (its grid covers the problem, so ldo is n)
extern "C" int stagecc_gemm_ffma_launch{signature} {{
  return stagecc::launch_ffma<{tk}, {str(kgrid).lower()}, {ta}, {tb}, {_CTYPE[out_t]}>(
      a, b, out, m, n, k, sam, sak, sbk, sbn, Epilogue{{{inits}}}, stream);
}}

// the dynamic shared memory an ffma launch asks for, in bytes
extern "C" int stagecc_gemm_ffma_smem() {{
  return stagecc::ffma::smem_bytes<{tk}>();
}}
"""
    includes = "".join(f'#include "{h}"\n' for h, on in (
        ("stagecc_gemm.cuh", True), ("stagecc_gemm_ffma.cuh", ffma),
        ("stagecc_gemm_sm90.cuh", sm90)) if on)
    return f"""\
// Emitted by repro_torch.core.backend_cuda from a scheduled contraction:
// tiles {tm} x {tn} x {tk}, {schedule}.
{includes}
namespace {{

struct Epilogue {{
{fields}  __device__ __forceinline__ {_vtype(result_t)} operator()({_vtype(acc_t)} v, long long row,
                                              long long col, long long n) const {{
{chr(10).join(lines)}
    return {result};
  }}
}};

}}  // namespace

// the plain CUDA-core route (simt)
extern "C" int stagecc_gemm_launch{signature} {{
  return stagecc::launch<{tm}, {tn}, {tk}, {str(kgrid).lower()}, {ta}, {tb}, {_CTYPE[out_t]}>(
      a, b, out, m, n, k, sam, sak, sbk, sbn, ldo, Epilogue{{{inits}}}, stream);
}}
{ffma_launch}{wgmma}"""


def _emit_gemm(kernel: Kernel, device="cuda",
               plan: Optional[_Plan] = None) -> Callable[..., torch.Tensor]:
    """The single-nest contraction emitter (see module doc)."""
    plan = plan or _analyze(kernel)
    index = _layout(kernel, plan)
    source = _render(kernel, plan, index)
    shapes = plan.shapes
    lhs, rhs = plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name
    tm, tn, tk = plan.tiles
    gm, gn, nk = _geometry(plan)
    if gm * gn >= 2 ** 31:
        raise EmitError(f"{kernel.name}: {gm} x {gn} tiles")
    # the grid's part of the problem; the output's rows are ldo apart
    m, n, kdim = gm * tm, gn * tn, nk * tk
    out_shape = shapes[plan.out_buffer]
    covers = _covers(plan)
    launchers = {}          # route -> the built kernel's entry, at first use

    def _args(inputs) -> Dict[str, torch.Tensor]:
        if len(inputs) != len(plan.in_buffers):
            raise ValueError(f"{kernel.name}: expected "
                             f"{len(plan.in_buffers)} inputs, got "
                             f"{len(inputs)}")
        # inputs are cast to each buffer's dtype, as the reference does
        args = {name: as_tensor(x, _TORCH_DTYPE[plan.dtypes[name]], device)
                for name, x in zip(plan.in_buffers, inputs)}
        for name, t in args.items():
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{kernel.name}: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shapes[name]}")
        return args

    def _route(args) -> Tuple[str, str]:
        a, b = args[lhs], args[rhs]
        return _gemm_route(plan, a.stride(), b.stride(), a.data_ptr(),
                           b.data_ptr())

    def fn(*inputs):
        args = _args(inputs)
        devices = {t.device for t in args.values()}
        if len(devices) != 1:
            raise ValueError(f"{kernel.name}: inputs on several devices: "
                             f"{devices}")
        dev = devices.pop()
        epi = [args[e] for e in plan.epilogue_inputs]
        if dev.type == "cpu":
            return gemm_plain(plan, args[lhs], args[rhs], *epi)
        if dev.type != "cuda":
            raise ValueError(f"{kernel.name}: runs on cuda or cpu, not {dev}")
        a, b = args[lhs], args[rhs]
        route, why = _route(args)
        if route not in launchers:
            lib = _build.load_source(source)
            launchers[route] = f = getattr(lib, _LAUNCHER[route])
            f.argtypes = ([ctypes.c_void_p] * (3 + len(epi))
                          + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 5
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
        out = torch.empty(out_shape, dtype=_TORCH_DTYPE[plan.dtypes[
            plan.out_buffer]], device=dev)
        if not covers:
            _unwritten(out)
        # A and B are read through their strides (the backward passes
        # transposed views); the small epilogue inputs are made contiguous
        epi = [t.contiguous() for t in epi]
        with torch.cuda.device(dev):
            err = launchers[route](
                a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in epi),
                out.data_ptr(), m, n, kdim, *a.stride(), *b.stride(),
                out_shape[1], torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{kernel.name}: CUDA GEMM launch ({route}: "
                               f"{why}) failed: error {err} (a cudaError, "
                               f"or 1000 + a CUresult from the tensor maps)")
        from repro_torch.kernels import gemm
        gemm.cuda_gemm.launches += 1
        if route == "wgmma":
            gemm.cuda_gemm.wgmma_launches += 1
        elif route == "ffma":
            gemm.cuda_gemm.ffma_launches += 1
        return out

    fn.__name__ = f"stagecc_cuda_{kernel.name}"
    fn.plan = plan          # exposed for tests / resource introspection
    fn.source = source      # the CUDA text built at the first launch
    # (route, reason) a launch on these inputs would take; launches nothing
    fn.route = lambda *inputs: _route(_args(inputs))
    return fn


# the rounding of each floating type, and int8's wrap, around a C value
_GEMM_ROUNDING = {"bfloat16": "stagecc::round_to<__nv_bfloat16>({})",
                  "float16": "stagecc::round_to<__half>({})",
                  "int8": "stagecc::wrap8({})"}

# each route's entry point in an emitted source
_LAUNCHER = {"simt": "stagecc_gemm_launch",
             "ffma": "stagecc_gemm_ffma_launch",
             "wgmma": "stagecc_gemm_wgmma_launch"}


def _apply_epilogue(plan: _Plan, acc: torch.Tensor,
                    inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply the fused elementwise tail to the whole (M, N) accumulator.

    HBM temporaries introduced by fusion are forwarded through a local
    SSA environment (``local``) and never materialised.
    """
    local: Dict[str, torch.Tensor] = {}
    if plan.acc_name is not None:
        local[plan.acc_name] = acc
    val = acc
    for s in plan.epilogue:
        srcs = []
        for r in s.srcs:
            if r.buffer.name in local:
                srcs.append(local[r.buffer.name])
            elif r.buffer.name == plan.out_buffer:
                srcs.append(val)
            elif r.buffer.name in inputs:
                srcs.append(inputs[r.buffer.name])
            else:
                raise EmitError(f"epilogue src {r.buffer.name} not mapped")
        v = _EWISE[s.op](*srcs)
        local[s.dst.buffer.name] = v
        val = v
    return local.get(plan.out_buffer, val)


def gemm_plain(plan: _Plan, a: torch.Tensor, b: torch.Tensor,
               *epi: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the emitted kernel: the same k tiles,
    in the same order, with the same roundings, on whole (M, N) slabs.

    ``tpu_mxu`` sums the tiles' f32 products in f32; ``tpu_mxu_kgrid``
    rounds each tile's product to the output dtype and adds it to the
    output-typed sum.  The epilogue then runs, and the result is cast to
    the output dtype.  That is K / tk products of f32 operands, which run
    in full f32 as long as TF32 stays off (PyTorch's default).  Only the
    grid's part of the problem is computed; the rest of the output is
    left as ``_unwritten`` fills it."""
    out_dtype = _TORCH_DTYPE[plan.dtypes[plan.out_buffer]]
    kgrid = plan.k_grid_var is not None
    tm, tn, tk = plan.tiles
    gm, gn, nk = _geometry(plan)
    a, b = a[:gm * tm, :nk * tk], b[:nk * tk, :gn * tn]
    acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device,
                      dtype=out_dtype if kgrid else torch.float32)
    for k0 in range(0, a.shape[1], tk):
        p = a[:, k0:k0 + tk].float() @ b[k0:k0 + tk].float()
        acc = acc + (_cast(p, out_dtype) if kgrid else p)
    val = _cast(_apply_epilogue(plan, acc, _epilogue_inputs(plan, epi)),
                out_dtype)
    if _covers(plan):
        return val
    out = _unwritten(torch.empty(plan.shapes[plan.out_buffer],
                                 dtype=out_dtype, device=a.device))
    out[:gm * tm, :gn * tn] = val
    return out


def _epilogue_inputs(plan: _Plan, epi: Sequence[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The epilogue inputs as the whole computed (M, N) slab sees them:
    an (N,) bias or an (M, N) input of the output's shape as it is (the
    epilogue broadcasts it), any other block spec gathered element by
    element as the emitted kernel indexes it (``_layout``)."""
    tm, tn, _ = plan.tiles
    gm, gn, _ = _geometry(plan)
    (_, (row, col)) = plan.block_specs[plan.out_buffer]
    ext = dict(zip(plan.grid_vars, plan.grid))
    out = {}
    for name, t in zip(plan.epilogue_inputs, epi):
        block, imap = plan.block_specs[name]
        if (block, imap) == ((tn,), (col,)) or (
                (block, imap) == ((tm, tn), (row, col))
                and plan.shapes[name] == plan.shapes[plan.out_buffer]):
            out[name] = t[..., :gm * tm, :gn * tn] if t.ndim == 2 else \
                t[:gn * tn]
            continue
        coords = (torch.arange(gm * tm, device=t.device)[:, None],
                  torch.arange(gn * tn, device=t.device)[None, :])
        index = []
        for d, (bd, v) in enumerate(zip(block, imap)):
            axis = 2 - len(block) + d
            c, size = coords[axis], (tm, tn)[axis]
            tile = {0: 0, row: coords[0] // tm, col: coords[1] // tn}.get(
                v, ext.get(v, 1) - 1)
            index.append(tile * bd + (c % size if bd == size else 0))
        out[name] = t[tuple(index)]
    return out


# epilogue ops that are nondecreasing in every operand, through which
# ``bracket`` carries its range
_MONOTONE = ("copy", "add", "relu", "maximum")


def bracket(plan: _Plan, a: torch.Tensor, b: torch.Tensor,
            *epi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per element, the range [lo, hi] in which every run of the plan's
    arithmetic on these inputs lands, whatever order it sums each k
    tile's products in: the emitted kernel, ``gemm_plain`` and the
    reference alike.

    Tile t's f32 product differs from the exact one by at most
    e_t = tk 2^-24 (|A_t| @ |B_t|) (a dot product of tk terms in f32, in
    any order); here it is taken twice over, so the range also holds the
    difference of two such sums.  Every later step, each rounding
    included, is nondecreasing in its operands, so it maps the ends of
    the range to the ends of the next:

        lo_t = R(lo_{t-1} + R(P_t - 2 e_t)),
        hi_t = R(hi_{t-1} + R(P_t + 2 e_t)),

    R the rounding to the running sum's dtype: f32 for ``tpu_mxu``, the
    output dtype for ``tpu_mxu_kgrid``;

    then the epilogue ops (``_MONOTONE``), each rounded where its result
    is bf16, and the cast to the output dtype.  With a bf16 output the range is a single value
    wherever no rounding boundary lies near, so a run that differs
    there has rounded at another place."""
    bad = [s.op for s in plan.epilogue if s.op not in _MONOTONE]
    if bad:
        raise ValueError(f"bracket: epilogue ops {bad} are not "
                         f"nondecreasing")
    out = _TORCH_DTYPE[plan.dtypes[plan.out_buffer]]
    acc_t = out if plan.k_grid_var is not None else torch.float32
    tk = plan.tiles[2]

    def rnd(x):
        return x.to(acc_t).float()

    a32, b32 = a.float(), b.float()
    lo = hi = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
    for k0 in range(0, a.shape[1], tk):
        at, bt = a32[:, k0:k0 + tk], b32[k0:k0 + tk]
        p = at @ bt
        e = 2 * tk * 2.0 ** -24 * (at.abs() @ bt.abs())
        lo, hi = rnd(lo + rnd(p - e)), rnd(hi + rnd(p + e))
    # the epilogue in PyTorch's dtypes rounds where the reference's does
    inputs = _epilogue_inputs(plan, epi)
    return tuple(_apply_epilogue(plan, x.to(acc_t), inputs).to(out).float()
                 for x in (lo, hi))


# --------------------------------------------------------------------------
# general multi-nest emitter
# --------------------------------------------------------------------------
#
# The serving-kernel graphs lower to several top-level nests chained
# through HBM temporaries (matmul -> mask add -> carried max -> exp ->
# carried sum -> matmul -> div), which the single-nest classifier cannot
# express.  As in ``backend_pallas``, each top-level statement is a stage.
# The reference's view of a stage (its grid, its inner statements, what it
# reads and writes) is kept apart from how the stage is laid out on the
# card:
#
#   * the nest's leading @grid chain is the reference's grid, one program
#     per CUDA block;
#   * below it, the leading chain of loops whose iterations are
#     independent (``_spread_reason``) is spread over blocks too, so a
#     nest the grid pass left alone does not run on one SM;
#   * where that still gives fewer blocks than the card has SMs and every
#     statement is row-local (``_split_rows``), each tile's rows are cut
#     into parts, one block each (``_split_body``);
#   * every other loop (@seq, @unrolled) is a C loop in the block, walked
#     in the schedule's order;
#   * scratch (@vreg / @vmem) lives in the block's shared memory, zeroed
#     per block, as the reference's local values are fresh per program;
#     what does not fit beside the matmul staging lives in a per-block
#     workspace in global memory, and such a stage runs at most
#     ``_WS_BLOCKS`` blocks, each walking programs in a loop and zeroing
#     its workspace per program;
#   * values keep the reference's types: integers compute in int and
#     wrap, floats in f32 rounded to bf16 / f16 where the reference's
#     value has that type, and stores convert as its astype does;
#   * every HBM buffer the stage touches is a pointer to the whole array;
#     a tile's origin is ``index.evaluate(env) * tile`` per dimension;
#   * stages communicate through a host-level environment: each stage's
#     written HBM buffers are new arrays that feed the next stages.
#
# Interior @grid loops (the k-on-grid revisit trick) stay exclusive to
# the GEMM path, and the general emitter refuses them, as the reference's.

_MAX_STMTS = 4096                   # the reference's trace limit per stage
_SMEM_LIMIT = 232448                # shared memory one block can have
_SMEM_DEFAULT = 48 * 1024           # above it, the launch opts in
_CHUNK = 16                         # stagecc_stage::kChunk
_SMS = 132                          # the H100's SMs: a stage aims at one block each
_MIN_PART_ROWS = 8                  # the fewest rows of one block's part of a tile
_PART = "part$"                     # the launch variable of a row split
_WS_BLOCKS = 2 * _SMS               # blocks of a stage with a workspace


def _stage_io(stmts: Sequence[Stmt]) -> Tuple[List[str], List[str]]:
    """(read, written) HBM buffer names under ``stmts``, in first-use
    order.  The carry of a ScanTile counts as read *and* written."""
    read: List[str] = []
    written: List[str] = []

    def go(ss):
        for s in ss:
            if isinstance(s, Loop):
                go(s.body)
                continue
            w = {r.buffer.name for r in _stmt_written_refs(s)}
            for r in _stmt_refs(s):
                if r.buffer.space != MemSpace.HBM:
                    continue
                tgt = written if r.buffer.name in w else read
                if r.buffer.name not in tgt:
                    tgt.append(r.buffer.name)
            if isinstance(s, (MatmulTile, ReduceTile)) and s.accumulate \
                    and s.dst.buffer.space == MemSpace.HBM:
                raise EmitError(
                    f"stage accumulates into HBM buffer "
                    f"{s.dst.buffer.name} (schedule an accumulator)")
    go(stmts)
    return read, written


def _walk_stmts(stmts):
    for s in stmts:
        yield s
        if isinstance(s, Loop):
            yield from _walk_stmts(s.body)


def _leaves(stmts) -> List[Stmt]:
    return [s for s in _walk_stmts(stmts) if not isinstance(s, Loop)]


def _traced_stmts(stmts) -> int:
    """Leaf statements the reference's stage body traces (loop trips
    multiply)."""
    n = 0
    for s in stmts:
        if isinstance(s, Loop):
            n += s.var.extent * _traced_stmts(s.body)
        else:
            n += 1
    return n


# ---- the launch layout -------------------------------------------------------


def _stmt_read_refs(s: Stmt) -> List[TileRef]:
    """Tile refs a statement reads: its operands, an accumulating
    destination, a scan's carry."""
    if isinstance(s, MatmulTile):
        return [s.lhs, s.rhs] + ([s.dst] if s.accumulate else [])
    if isinstance(s, ReduceTile):
        return [s.src] + ([s.dst] if s.accumulate else [])
    if isinstance(s, ScanTile):
        return [*s.srcs, s.carry]
    if isinstance(s, EwiseTile):
        return list(s.srcs)
    return []


def _early_reads(stmts: Sequence[Stmt], names: Set[str]) -> Set[str]:
    """The buffers of ``names`` that one run of ``stmts`` may read before
    it writes the elements read.  A read counts as written only after an
    earlier write of the same tile, its index variables bound by the same
    loops; anything else is early."""
    early: Set[str] = set()
    done: Set[tuple] = set()

    def key(r: TileRef, loops: Dict[str, int]) -> tuple:
        return (r.buffer.name, r.index, r.tile,
                tuple(loops.get(v) for e in r.index for v, _ in e.coeffs))

    def go(ss, loops):
        for s in ss:
            if isinstance(s, Loop):
                go(s.body, {**loops, s.var.name: id(s)})
                continue
            for r in _stmt_read_refs(s):
                if r.buffer.name in names and key(r, loops) not in done:
                    early.add(r.buffer.name)
            done.update(key(w, loops) for w in _stmt_written_refs(s)
                        if w.buffer.name in names)
    go(stmts, {})
    return early


def _own_dim(refs: Sequence[TileRef], var: str) -> bool:
    """Whether every ref in ``refs`` (all on one buffer) has, in one
    common dimension, the index ``c * var + k`` (c != 0) and the tile of
    every other: then each iteration of ``var`` touches its own tiles."""
    for d in range(len(refs[0].index)):
        keys = {(r.index[d], r.tile[d]) for r in refs}
        if len(keys) == 1:
            e = next(iter(keys))[0]
            if len(e.coeffs) == 1 and e.coeffs[0][0] == var \
                    and e.coeffs[0][1] != 0:
                return True
    return False


def _spread_reason(loop: Loop) -> Optional[str]:
    """Why the iterations of ``loop`` may not run as separate CUDA blocks
    (in any order, each with fresh zeroed scratch); None when they may.
    The loop must carry no reduction or scan (``carry_axis_reason``); it
    must read no scratch before the same iteration writes it, which also
    keeps out a matmul accumulating into scratch initialised outside the
    loop; and each HBM buffer it writes must be written and read, in
    every iteration, only at tiles that iteration owns (``_own_dim``)."""
    reason = carry_axis_reason(loop, LoopKind.GRID)
    if reason:
        return reason
    leaves = _leaves(loop.body)
    scratch = {r.buffer.name for s in leaves for r in _stmt_refs(s)
               if r.buffer.space != MemSpace.HBM}
    early = _early_reads(loop.body, scratch)
    if early:
        return (f"loop %{loop.var.name} reads scratch {sorted(early)} before "
                f"the iteration writes it")
    refs: Dict[str, List[TileRef]] = {}
    for s in leaves:
        for r in _stmt_refs(s):
            refs.setdefault(r.buffer.name, []).append(r)
    for s in leaves:
        for w in _stmt_written_refs(s):
            if w.buffer.space == MemSpace.HBM and \
                    not _own_dim(refs[w.buffer.name], loop.var.name):
                return (f"loop %{loop.var.name}: the tiles of "
                        f"{w.buffer.name} are not each iteration's own")
    return None


def _split_refs(s: Stmt) -> List[TileRef]:
    """The refs of a statement whose rows follow the statement's rows
    (all but a matmul's right operand)."""
    return [r for r in _stmt_refs(s)
            if not (isinstance(s, MatmulTile) and r is s.rhs)]


def _split_rows(stmts: Sequence[Stmt]) -> Optional[int]:
    """R if every statement under ``stmts`` is row-local over R rows, so
    that each block can compute a part of every tile's rows alone: rank-2
    tiles of R rows (a matmul's right operand aside, which must not be
    written under ``stmts``, since every part reads all of it); no scan,
    which runs along the rows; no operand broadcast along the rows.
    Tile origins are multiples of R, so the parts never meet.  None
    otherwise."""
    leaves = _leaves(stmts)
    written = {w.buffer.name for s in leaves for w in _stmt_written_refs(s)}
    rows: Set[int] = set()
    for s in leaves:
        if isinstance(s, ScanTile):
            return None
        if isinstance(s, MatmulTile) and s.rhs.buffer.name in written:
            return None
        for r in _split_refs(s):
            if len(r.tile) != 2:
                return None
            rows.add(r.tile[0])
    return rows.pop() if len(rows) == 1 else None


def _choose_split(blocks: int, rows: Optional[int]) -> int:
    """Parts per tile: the fewest that give every SM a block, each part
    at least ``_MIN_PART_ROWS`` rows and the parts equal; 1 if the blocks
    already fill the card or the nest is not row-local."""
    if rows is None or blocks >= _SMS:
        return 1
    parts = [p for p in range(2, rows // _MIN_PART_ROWS + 1)
             if rows % p == 0]
    return next((p for p in parts if blocks * p >= _SMS),
                parts[-1] if parts else 1)


def _split_body(stmts: Sequence[Stmt], scratch: Sequence[Buffer], rows: int,
                parts: int) -> Tuple[List[Stmt], List[Buffer]]:
    """``stmts`` with every row-following tile cut to its part: ``rows /
    parts`` rows at row ``(index * parts + part$) * rows / parts``, the
    same statements in the same order.  Scratch of R rows used only at
    row 0, and never as a matmul's right operand, is the block's own and
    shrinks to the part (its index stays 0); other scratch keeps its
    shape.  Returns (statements, scratch)."""
    rp = rows // parts
    leaves = _leaves(stmts)
    refs = [r for s in leaves for r in _split_refs(s)]
    rhs = {s.rhs.buffer.name for s in leaves if isinstance(s, MatmulTile)}
    own = {b.name: Buffer(b.name, TensorType((rp,) + b.shape[1:],
                                             b.type.dtype), b.space)
           for b in scratch if b.shape[0] == rows and b.name not in rhs
           and all(r.index[0] == AffineExpr() for r in refs
                   if r.buffer.name == b.name)}

    def cut(r: TileRef) -> TileRef:
        tile = (rp,) + r.tile[1:]
        if r.buffer.name in own:
            return TileRef(own[r.buffer.name], r.index, tile)
        e = r.index[0]
        row = AffineExpr(tuple((v, c * parts) for v, c in e.coeffs)
                         + ((_PART, 1),), e.const * parts)
        return TileRef(r.buffer, (row,) + r.index[1:], tile)

    def go(ss):
        out = []
        for s in ss:
            if isinstance(s, Loop):
                out.append(Loop(s.var, s.kind, go(s.body)))
            elif isinstance(s, MatmulTile):
                out.append(MatmulTile(cut(s.dst), cut(s.lhs), s.rhs,
                                      s.accumulate))
            elif isinstance(s, ReduceTile):
                out.append(ReduceTile(s.kind, cut(s.dst), cut(s.src),
                                      s.accumulate))
            elif isinstance(s, EwiseTile):
                out.append(EwiseTile(s.op, cut(s.dst),
                                     [cut(r) for r in s.srcs]))
            else:
                out.append(dataclasses.replace(s, dst=cut(s.dst)))
        return out
    return go(stmts), [own.get(b.name, b) for b in scratch]


def _covered(top: Stmt, writes: Sequence[str],
             buffers: Dict[str, Buffer]) -> Set[str]:
    """The written buffers one statement of the stage writes whole, each
    dimension's index either 0 on a tile as wide as the dimension or one
    enclosing loop's variable (coefficient 1, no offset, a distinct
    variable per dimension) whose extent times the tile is the dimension,
    and that no block reads before writing.  Their fresh arrays need no
    fill: every element is written before anything reads it."""
    whole: Set[str] = set()

    def go(s, extents):
        if isinstance(s, Loop):
            for c in s.body:
                go(c, {**extents, s.var.name: s.var.extent})
            return
        for w in _stmt_written_refs(s):
            seen = set()
            for e, t, d in zip(w.index, w.tile, w.buffer.shape):
                if not e.coeffs and e.const == 0 and t == d:
                    continue
                if len(e.coeffs) != 1 or e.const:
                    break
                (v, c), = e.coeffs
                if c != 1 or v in seen or extents[v] * t != d:
                    break
                seen.add(v)
            else:
                whole.add(w.buffer.name)
    go(top, {})
    whole &= {n for n in writes if buffers[n].space == MemSpace.HBM}
    return whole - _early_reads([top], whole)


@dataclasses.dataclass
class _Stage:
    """One top-level nest: what it reads and writes, as the reference
    sees it, and how its blocks are laid out on the card."""
    index: int
    kernel_name: str
    grid_vars: List[str]                 # the reference's Pallas grid
    grid: Tuple[int, ...]
    inner: List[Stmt]                    # the reference's program body
    reads: List[str]                     # HBM buffers read, first-use order
    writes: List[str]                    # HBM buffers written
    scratch: List[Buffer]
    buffers: Dict[str, Buffer]
    spread_vars: List[str] = dataclasses.field(default_factory=list)
    spread: Tuple[int, ...] = ()         # loops under the grid run as blocks
    rows: int = 0                        # rows of every tile, if split
    parts: int = 1                       # blocks each tile's rows go to
    body: List[Stmt] = dataclasses.field(default_factory=list)  # per block
    block_scratch: List[Buffer] = dataclasses.field(default_factory=list)
    covered: Set[str] = dataclasses.field(default_factory=set)
    ws_bytes: int = 0                    # global workspace per block and
    ws_blocks: int = 0                   # blocks launched with it (set
                                         # when the stage is rendered)
    flops: int = 0                       # of the stage's statements
    hbm_bytes: int = 0                   # reads and writes, each once
    lib: Optional["_Library"] = None     # the kernel's built source

    @property
    def params(self) -> List[str]:
        """The launcher's pointers: a name both read and written is bound
        once, to the written copy (``dict(zip(reads + writes, refs))`` in
        the reference)."""
        return [n for n in self.reads if n not in self.writes] + self.writes

    @property
    def launch_vars(self) -> List[Tuple[str, int]]:
        """(variable, extent) of the block index, outermost first."""
        return (list(zip(self.grid_vars + self.spread_vars,
                         self.grid + self.spread))
                + ([(_PART, self.parts)] if self.parts > 1 else []))

    @property
    def programs(self) -> int:
        """Blocks of the launch: the grid's programs times the spread
        loops' iterations times the parts of a row split."""
        return math.prod(e for _, e in self.launch_vars)

    @property
    def threads(self) -> int:
        """A launch that fills the card, or a row split, gets 256-thread
        blocks; a stage of few blocks gets 1024 threads per block, so its
        SMs have loads in flight."""
        return 256 if self.parts > 1 or self.programs >= _SMS else 1024

    @property
    def layout(self) -> str:
        """The launch layout, as the stage's header and the smoke print
        it."""
        spread = " x ".join(f"%{v}:{e}" for v, e in zip(self.spread_vars,
                                                       self.spread))
        split = (f"{self.rows} rows in {self.parts} parts"
                 if self.parts > 1 else "none")
        return (f"grid [{'x'.join(map(str, self.grid)) or 'none'}], spread "
                f"[{spread or 'none'}], row split {split}: {self.programs} "
                f"blocks x {self.threads} threads")

    def __call__(self, env: Dict[str, torch.Tensor]) -> None:
        """Run the stage over ``env``: its kernel if the arrays are on a
        CUDA device (or raise), the plain version if on the CPU."""
        dev = next(iter(env.values())).device
        if dev.type == "cpu":
            stage_plain(self, env)
        elif dev.type == "cuda":
            self._launch(env, dev)
        else:
            raise ValueError(f"{self.kernel_name}: runs on cuda or cpu, "
                             f"not {dev}")

    def _launch(self, env, dev) -> None:
        outs = _fresh(self, dev, fill=False)
        ptrs = [outs[n] if n in outs else env[n] for n in self.params]
        for name, t in zip(self.params, ptrs):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{self.kernel_name}: {name} is not a "
                                 f"contiguous array on {dev}")
        if self.ws_bytes:
            # each block zeroes its own part per program
            ptrs.append(torch.empty(self.ws_blocks * self.ws_bytes,
                                    dtype=torch.uint8, device=dev))
        launcher = self.lib.stage(self.index, len(ptrs))
        with torch.cuda.device(dev):
            err = launcher(*(t.data_ptr() for t in ptrs),
                           torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{self.kernel_name}: stage {self.index} "
                               f"launch failed: cudaError {err}")
        emit_general.launches += 1
        env.update(outs)


def _fresh(stage: _Stage, dev, fill: bool = True) -> Dict[str, torch.Tensor]:
    """New arrays for the stage's writes.  They start as the reference's
    outputs do in Pallas interpret mode (``_unwritten``: NaN, or an integer
    type's least value), so a tile no program writes, or a read of a
    written buffer before its write, shows the same in both.  With
    ``fill`` False (the kernels' path) a buffer the blocks write whole
    before any read (``_Stage.covered``) is left unfilled."""
    out = {}
    for n in stage.writes:
        t = torch.empty(stage.buffers[n].shape, device=dev,
                        dtype=_TORCH_DTYPE[stage.buffers[n].type.dtype])
        out[n] = t if not fill and n in stage.covered else _unwritten(t)
    return out


class _Library:
    """The compiled kernel's source, built and loaded at the first
    launch; one ctypes entry per stage."""

    def __init__(self, source: str):
        self.source = source
        self._lib = None
        self._fns: Dict[int, object] = {}

    def stage(self, index: int, nptrs: int):
        if index not in self._fns:
            if self._lib is None:
                self._lib = _build.load_source(self.source)
            fn = getattr(self._lib, f"stagecc_stage{index}")
            fn.argtypes = [ctypes.c_void_p] * (nptrs + 1)
            fn.restype = ctypes.c_int
            self._fns[index] = fn
        return self._fns[index]


def _stage_flops(stmts) -> int:
    """f32 operations of one program: 2mnk per MatmulTile, one per
    element reduced, scanned (two for ``linear``) or computed by an
    elementwise op; copies, casts and fills count none."""
    n = 0
    for s in stmts:
        if isinstance(s, Loop):
            n += s.var.extent * _stage_flops(s.body)
        elif isinstance(s, MatmulTile):
            n += 2 * s.macs * math.prod(s.lhs.tile[:-2] + s.rhs.tile[:-2])
        elif isinstance(s, ReduceTile):
            n += s.src.tile_elems
        elif isinstance(s, ScanTile):
            n += (2 if s.kind == "linear" else 1) * s.dst.tile_elems
        elif isinstance(s, EwiseTile) and s.op not in ("ones", "copy",
                                                       "copy1", "cast"):
            n += s.dst.tile_elems
    return n


def _emit_stage(kernel: Kernel, top: Stmt, buffers: Dict[str, Buffer],
                index: int) -> _Stage:
    """The analysis of ``backend_pallas._emit_stage`` (the grid, the inner
    statements, the HBM buffers read and written and the scratch, with
    the reference's refusals), then the stage's launch layout: the loops
    spread over blocks and the row split."""
    # 1. peel the leading @grid chain
    grid_vars: List[str] = []
    grid: List[int] = []
    cur = top
    while isinstance(cur, Loop) and cur.kind == LoopKind.GRID:
        grid_vars.append(cur.var.name)
        grid.append(cur.var.extent)
        if len(cur.body) == 1 and isinstance(cur.body[0], Loop) \
                and cur.body[0].kind == LoopKind.GRID:
            cur = cur.body[0]
        else:
            break
    inner: List[Stmt] = list(cur.body) if isinstance(cur, Loop) \
        and cur.kind == LoopKind.GRID else [cur]
    for s in inner:
        for n in _walk_stmts([s]):
            if isinstance(n, Loop) and n.kind == LoopKind.GRID:
                raise EmitError(
                    f"{kernel.name}: interior @grid loop %{n.var.name} "
                    f"(k-on-grid is a single-nest schedule)")

    reads, writes = _stage_io([top])
    if not writes:
        raise EmitError(f"{kernel.name}: stage writes no HBM buffer")
    # the reference unrolls the non-grid loops at trace time and refuses
    # a stage this large; the port keeps the same limit
    traced = _traced_stmts(inner)
    if traced > _MAX_STMTS:
        raise EmitError(
            f"{kernel.name}: stage would trace {traced} statements "
            f"(grid-map or tile the schedule first)")
    used = {r.buffer.name for s in _leaves([top]) for r in _stmt_refs(s)}
    scratch = [b for b in kernel.scratch if b.name in used]
    grid_t = tuple(grid)

    # 2. the launch layout: spread the leading independent loops, then
    #    split the rows where the card would still be idle
    spread_vars: List[str] = []
    spread: List[int] = []
    body = inner
    while len(body) == 1 and isinstance(body[0], Loop) \
            and _spread_reason(body[0]) is None:
        spread_vars.append(body[0].var.name)
        spread.append(body[0].var.extent)
        body = body[0].body
    rows = _split_rows(body)
    parts = _choose_split(math.prod(grid_t) * math.prod(spread), rows)
    block_scratch = scratch
    if parts > 1:
        body, block_scratch = _split_body(body, scratch, rows, parts)
    return _Stage(index=index, kernel_name=kernel.name, grid_vars=grid_vars,
                  grid=grid_t, inner=inner, reads=reads, writes=writes,
                  scratch=scratch, buffers=buffers, spread_vars=spread_vars,
                  spread=tuple(spread), rows=rows if parts > 1 else 0,
                  parts=parts, body=list(body), block_scratch=block_scratch,
                  covered=_covered(top, writes, buffers),
                  flops=math.prod(grid_t) * _stage_flops(inner),
                  hbm_bytes=sum(buffers[n].type.nbytes
                                for n in reads + writes))


# ---- rendering ---------------------------------------------------------------


def _strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _cvar(name: str) -> str:
    return "v_" + re.sub(r"\W", "_", name)


def _flit(value: float) -> str:
    """``value`` rounded to f32, as an exact C expression."""
    bits = struct.unpack("<I", struct.pack("<f", value))[0]
    return {0: "0.f", 0x3F800000: "1.f"}.get(
        bits, f"__int_as_float((int)0x{bits:08x}u)")


# the rounding of each floating type, and int8's wrap, around a C value
_STAGE_ROUNDING = {"bfloat16": "stagecc_stage::bf16r({})",
                   "float16": "stagecc_stage::f16r({})",
                   "int8": "stagecc_stage::wrap8({})"}


def _rnd(expr: str, dtype: str) -> str:
    """``expr`` rounded to ``dtype`` (a no-op for f32 and int32)."""
    return _STAGE_ROUNDING.get(dtype, "{}").format(expr)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _mm_layout(nt: int, tm: int, tn: int) -> Tuple[int, int, int, int]:
    """(RX, MI, MJ, shared bytes) of ``matmul_tile`` for a tm x tn tile
    with nt threads: an RX-wide thread grid (RY = nt / RX rows, at most
    256; RX up to 32 where 1024 threads or few rows would leave rows of
    the grid idle, else 16), each thread an MI x MJ register tile (at most
    8 x 8, or 4 x 4 where 1024 threads leave 64 registers each), a pass at
    most 256 rows high."""
    cap = 4 if nt == 1024 else 8
    wide = nt == 1024 or 32 * tm <= nt
    rx = min(max(_pow2ceil(tn), nt // 256), 32 if wide else 16)
    ry = nt // rx
    mi = max(1, min(cap, -(-tm // ry), 256 // ry))
    mj = max(1, min(cap, -(-tn // rx)))
    return rx, mi, mj, (ry * mi + rx * mj) * _CHUNK * 4


def _same_ref(a: TileRef, b: TileRef) -> bool:
    return (a.buffer.name, a.index, a.tile) == (b.buffer.name, b.index,
                                                b.tile)


def _staged(s: Stmt) -> bool:
    """Whether a statement writes a buffer it reads in a way one pass of
    the block cannot do in place: the reference reads every operand tile
    before it writes, so such a statement computes into shared memory
    first.  An elementwise op or a scan may read and write one identical
    tile (each element is read and written by one thread); a matmul or a
    reduction reads other threads' elements."""
    written = _stmt_written_refs(s)
    if isinstance(s, MatmulTile):
        srcs = [s.lhs, s.rhs]
    elif isinstance(s, ReduceTile):
        srcs = [s.src]
    elif isinstance(s, ScanTile):
        srcs = list(s.srcs)
        if s.carry.buffer.name == s.dst.buffer.name:
            return True
    elif isinstance(s, EwiseTile):
        srcs = list(s.srcs)
    else:
        return False
    elementwise = isinstance(s, (EwiseTile, ScanTile))
    return any(r.buffer.name == w.buffer.name
               and not (elementwise and _same_ref(r, w))
               for r in srcs for w in written)


class _StageRenderer:
    """CUDA C++ of one stage: its ``__global__`` and its launcher."""

    def __init__(self, kernel: Kernel, stage: _Stage):
        self.kernel, self.stage = kernel, stage
        self.nt = stage.threads
        self.dtypes = {n: b.type.dtype for n, b in stage.buffers.items()}
        self.ptr = {n: f"g{i}" for i, n in enumerate(stage.params)}
        self.ptr.update({b.name: f"s{i}"
                         for i, b in enumerate(stage.block_scratch)})
        self.read_only = set(stage.reads) - set(stage.writes)
        mm = stg = 0
        for s in _walk_stmts(stage.body):
            if isinstance(s, MatmulTile):
                mm = max(mm, _mm_layout(self.nt, s.lhs.tile[-2],
                                        s.rhs.tile[-1])[3])
            if _staged(s):
                extra = s.carry.tile_elems if isinstance(s, ScanTile) else 0
                stg = max(stg, 4 * (s.dst.tile_elems + extra))
        # shared memory first: scratch in order while it fits beside the
        # matmul staging, then the staged results; what does not fit goes
        # to the block's workspace in global memory
        room = _SMEM_LIMIT - mm
        self.smem_off: Dict[str, int] = {}
        self.ws_off: Dict[str, int] = {}
        off = ws = 0
        for b in stage.block_scratch:
            size = _align16(b.type.nbytes)
            if off + size <= room:
                self.smem_off[b.name], off = off, off + size
            else:
                self.ws_off[b.name], ws = ws, ws + size
        self.scratch_bytes, self.ws_scratch = off, ws
        self.mm_off = off
        if off + _align16(stg) <= room:
            self.stg_at, self.stg_off = "smem", off + mm
            self.smem = off + mm + _align16(stg)
        else:
            self.stg_at, self.stg_off = "ws", ws
            self.smem, ws = off + mm, ws + _align16(stg)
        self.ws_bytes = ws
        stage.ws_bytes = ws
        stage.ws_blocks = min(stage.programs, _WS_BLOCKS) if ws else 0
        self.lines: List[str] = []
        self.depth = 1
        self.onames: Dict[int, str] = {}     # id(TileRef) -> origin name

    # -- helpers ----------------------------------------------------------

    def out(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def ctype(self, name: str) -> str:
        return _CTYPE[self.dtypes[name]]

    def load(self, var: str, r: TileRef, addr: str) -> Tuple[str, str]:
        """Declare ``var`` as the value at ``addr`` of ``r``'s buffer, in
        the C type its element type computes in; (var, dtype)."""
        dtype = self.dtypes[r.buffer.name]
        self.out(f"const {_vtype(dtype)} {var} = stagecc_stage::ld({addr});")
        return var, dtype

    @staticmethod
    def stg(dtype: str) -> str:
        """The staging array for values of ``dtype``: float or int."""
        return "stgi" if dtype in _INTS else "stg"

    def origin(self, r: TileRef) -> str:
        """The tile's first element, as a 64-bit offset into its buffer."""
        terms = []
        for e, t, st in zip(r.index, r.tile, _strides(r.buffer.shape)):
            aff = [str(e.const)] if e.const or not e.coeffs else []
            aff += [_cvar(v) if c == 1 else f"{c} * {_cvar(v)}"
                    for v, c in e.coeffs]
            if e.coeffs or e.const:
                terms.append(f"(long long)({' + '.join(aff)}) * "
                             f"{t * st}LL")
        return " + ".join(terms) or "0LL"

    def element(self, r: TileRef, idx: Sequence[str],
                shape: Sequence[int]) -> str:
        """The address of element ``idx`` (indices over ``shape``) of
        ``r``, by numpy broadcasting: ``r``'s dimensions align with the
        last of ``shape``, and a dimension of 1 is read at 0."""
        off = len(shape) - len(r.tile)
        if off < 0:
            raise EmitError(f"{self.kernel.name}: {r} has more dimensions "
                            f"than the statement's {tuple(shape)}")
        terms = []
        for d, (t, st) in enumerate(zip(r.tile, _strides(r.buffer.shape))):
            if t == 1:
                continue
            if t != shape[d + off]:
                raise EmitError(f"{self.kernel.name}: tile {r.tile} does "
                                f"not broadcast to {tuple(shape)}")
            terms.append(idx[d + off] if st == 1 else f"{idx[d + off]} * "
                         f"{st}LL")
        return (f"{self.ptr[r.buffer.name]} + {self.onames[id(r)]}"
                + "".join(f" + {t}" for t in terms))

    def bind(self, *refs: TileRef) -> None:
        """Declare each ref's origin, ``o0``, ``o1``, ... in the
        statement's scope."""
        self.onames = {}
        for r in refs:
            if id(r) not in self.onames:
                self.onames[id(r)] = name = f"o{len(self.onames)}"
                self.out(f"const long long {name} = {self.origin(r)};")

    def elems_loop(self, shape: Sequence[int], name: str = "e") -> List[str]:
        """Open a block-cooperative loop over the elements of ``shape``
        (row-major) and return the per-dimension index names."""
        self.out(f"for (int {name} = threadIdx.x; {name} < "
                 f"{math.prod(shape)}; {name} += {self.nt}) {{")
        self.depth += 1
        return self.elems_index(name, shape)

    def close(self) -> None:
        self.depth -= 1
        self.out("}")

    # -- statements ---------------------------------------------------------

    def render_fill(self, dst: TileRef, value: float) -> None:
        self.bind(dst)
        idx = self.elems_loop(dst.tile)
        self.out(f"stagecc_stage::st({self.element(dst, idx, dst.tile)}, "
                 f"{_flit(value)});")
        self.close()

    def render_ewise(self, s: EwiseTile, staged: bool) -> None:
        shape = s.dst.tile
        self.bind(s.dst, *s.srcs)
        idx = self.elems_loop(shape)
        if s.op == "ones":
            val, dtype = "1.f", "float32"
        elif s.op == "copy1":
            src = s.srcs[0]
            if src.tile_elems != s.dst.tile_elems:
                raise EmitError(f"{self.kernel.name}: copy1 of {src.tile} "
                                f"into {shape}")
            # the flat element e of the dst is the flat element e of src
            self.out("const int f = e;")
            sidx = self.elems_index("f", src.tile)
            val, dtype = self.load("x0", src,
                                   self.element(src, sidx, src.tile))
        else:
            if s.op != "cast" and s.op not in _EWISE_CUDA:
                raise EmitError(f"{self.kernel.name}: no CUDA emission for "
                                f"op {s.op!r}")
            args = [self.load(f"x{i}", r, self.element(r, idx, shape))
                    for i, r in enumerate(s.srcs)]
            val, dtype = (args[0] if s.op == "cast" else
                          _typed_op(s.op, args, _STAGE_ROUNDING))
        if staged:
            self.out(f"{self.stg(dtype)}[e] = {val};")
        else:
            self.out(f"stagecc_stage::st({self.element(s.dst, idx, shape)},"
                     f" {val});")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(shape)
            self.out(f"stagecc_stage::st({self.element(s.dst, idx, shape)},"
                     f" {self.stg(dtype)}[e]);")
            self.close()

    def elems_index(self, flat: str, shape: Sequence[int]) -> List[str]:
        """Indices over ``shape`` of the flat row-major element ``flat``."""
        names = [f"{flat}{d}" for d in range(len(shape))]
        if shape:
            self.out(f"int q_{flat} = {flat};")
        for d in range(len(shape) - 1, 0, -1):
            self.out(f"const int {names[d]} = q_{flat} % {shape[d]}; "
                     f"q_{flat} /= {shape[d]};")
        if shape:
            self.out(f"const int {names[0]} = q_{flat};")
        return names

    def view(self, r: TileRef, lead: Sequence[Tuple[int, str]] = (),
             rows: int = -2, ptr: Optional[str] = None,
             strides: Optional[Sequence[int]] = None) -> str:
        """A rank-2 view of ``r``'s tile: its dimension ``rows`` by its
        last, offset by ``lead``'s (dimension, C index) pairs; ``ptr`` and
        ``strides`` replace the buffer's (a staged result)."""
        st = strides or _strides(r.buffer.shape)
        off = "".join(f" + {v} * {st[d]}LL" for d, v in lead)
        if ptr is None:
            # only the read-only global pointers are const
            const = "const " if r.buffer.name in self.read_only else ""
            t = f"{const}{self.ctype(r.buffer.name)}"
            ptr = f"{self.ptr[r.buffer.name]} + {self.onames[id(r)]}"
        else:
            t = "float"
        return (f"stagecc_stage::View2<{t}>{{{ptr}{off}, "
                f"{st[rows]}LL, {st[-1]}LL}}")

    def render_matmul(self, s: MatmulTile, staged: bool) -> None:
        """dst (+)= lhs @ rhs with jnp.dot's shapes: a 2-D product for
        each index of the operands' leading tile dimensions, (lhs leading,
        M, rhs leading, N) in dst; leading dimensions of extent 1 add
        nothing."""
        tm, tk = s.lhs.tile[-2:]
        tn = s.rhs.tile[-1]
        ll, lr = s.lhs.tile[:-2], s.rhs.tile[:-2]
        if s.dst.tile != ll + (tm,) + lr + (tn,):
            raise EmitError(f"{self.kernel.name}: jnp.dot of {s.lhs.tile} "
                            f"and {s.rhs.tile} is not the tile {s.dst.tile}")
        rx, mi, mj, _ = _mm_layout(self.nt, tm, tn)
        self.bind(s.dst, s.lhs, s.rhs)
        loops = []           # (C index, lhs dim, dst dim) or rhs's
        for side, lead, base in (("l", ll, 0), ("r", lr, len(ll) + 1)):
            for d, e in enumerate(lead):
                if e > 1:
                    v = f"b{side}{d}"
                    self.out(f"for (int {v} = 0; {v} < {e}; ++{v}) {{")
                    self.depth += 1
                    loops.append((side, v, d, base + d))
        dst_lead = [(dd, v) for _, v, _, dd in loops]
        dst = (self.view(s.dst, dst_lead, len(ll), ptr="stg",
                         strides=_strides(s.dst.tile)) if staged
               else self.view(s.dst, dst_lead, len(ll)))
        acc = "true" if s.accumulate and not staged else "false"
        self.out(f"stagecc_stage::matmul_tile<{self.nt}, {tm}, {tn}, {tk}, "
                 f"{rx}, {mi}, {mj}, {acc}>(")
        self.out(f"    {self.view(s.lhs, [(d, v) for w, v, d, _ in loops if w == 'l'])},")
        self.out(f"    {self.view(s.rhs, [(d, v) for w, v, d, _ in loops if w == 'r'])},")
        self.out(f"    {dst}, mm);")
        for _ in loops:
            self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(s.dst.tile)
            d = self.element(s.dst, idx, s.dst.tile)
            val = (f"stagecc_stage::ld({d}) + stg[e]" if s.accumulate
                   else "stg[e]")
            self.out(f"stagecc_stage::st({d}, {val});")
            self.close()

    def render_reduce(self, s: ReduceTile, staged: bool) -> None:
        mx = s.kind == "max"
        rows_shape = s.src.tile[:-1]
        width = s.src.tile[-1]
        rows = math.prod(rows_shape)
        src_t = self.dtypes[s.src.buffer.name]
        dst_t = self.dtypes[s.dst.buffer.name]
        # jnp.sum of an integer type sums in int32; max keeps the type
        red_t = "int32" if src_t in _INTS and not mx else src_t
        vt = _vtype(red_t)
        if vt == "int":
            init = "(-2147483647 - 1)" if mx else "0"
            step = "max(v, x)" if mx else _EWISE_INT["add"].format("v", "x")
        else:
            init = "-INFINITY" if mx else "0.f"
            step = "fmaxf(v, x)" if mx else "v + x"
        comb = "maximum" if mx else "add"
        self.bind(s.dst, s.src)
        self.out(f"for (int row = threadIdx.x / 32; row < {rows}; "
                 f"row += {self.nt // 32}) {{")
        self.depth += 1
        ridx = self.elems_index("row", rows_shape)
        s_last = _strides(s.src.buffer.shape)[-1]
        src_row = self.element(s.src, ridx + ["0"], s.src.tile)
        self.out(f"{vt} v = {init};")
        self.out(f"for (int c = threadIdx.x % 32; c < {width}; c += 32) {{")
        self.out(f"  const {vt} x = stagecc_stage::ld({src_row} + c * "
                 f"{s_last}LL);")
        self.out(f"  v = {step};")
        self.out("}")
        self.out(f"v = {_rnd(f'stagecc_stage::warp_reduce<{str(mx).lower()}>(v)', red_t)};")
        dst = self.element(s.dst, ridx + ["0"], s.dst.tile)
        self.out("if (threadIdx.x % 32 == 0) {")
        if staged:
            self.out(f"  {self.stg(red_t)}[row] = v;")
        else:
            val = "v"
            if s.accumulate:
                val = _typed_op(comb, [(f"stagecc_stage::ld({dst})", dst_t),
                                       ("v", red_t)], _STAGE_ROUNDING)[0]
            self.out(f"  stagecc_stage::st({dst}, {val});")
        self.out("}")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(s.dst.tile)
            d = self.element(s.dst, idx, s.dst.tile)
            val = f"{self.stg(red_t)}[e]"
            if s.accumulate:
                val = _typed_op(comb, [(f"stagecc_stage::ld({d})", dst_t),
                                       (val, red_t)], _STAGE_ROUNDING)[0]
            self.out(f"stagecc_stage::st({d}, {val});")
            self.close()

    def render_scan(self, s: ScanTile, staged: bool) -> None:
        rows = s.dst.tile[0]
        cols_shape = s.dst.tile[1:]
        cols = math.prod(cols_shape)
        dtype = _promote(self.dtypes[s.carry.buffer.name],
                         *(self.dtypes[r.buffer.name] for r in s.srcs))
        vt, stg = _vtype(dtype), self.stg(dtype)
        self.bind(s.dst, s.carry, *s.srcs)
        self.out(f"for (int col = threadIdx.x; col < {cols}; "
                 f"col += {self.nt}) {{")
        self.depth += 1
        cidx = self.elems_index("col", cols_shape)
        carry = self.element(s.carry, ["0"] + cidx, s.carry.tile)
        self.out(f"{vt} c = stagecc_stage::ld({carry});")
        self.out("#pragma unroll 4")
        self.out(f"for (int r = 0; r < {rows}; ++r) {{")
        self.depth += 1
        srcs = [self.element(r, ["r"] + cidx, s.dst.tile) for r in s.srcs]
        if s.kind == "linear":
            self.out(f"const {vt} a = stagecc_stage::ld({srcs[0]});")
            self.out(f"const {vt} x = stagecc_stage::ld({srcs[1]});")
            step = ("__fadd_rn(__fmul_rn(a, c), x)" if vt == "float" else
                    _EWISE_INT["add"].format(
                        _EWISE_INT["mul"].format("a", "c"), "x"))
        else:
            self.out(f"const {vt} x = stagecc_stage::ld({srcs[0]});")
            step = ("__fadd_rn(c, x)" if vt == "float"
                    else _EWISE_INT["add"].format("c", "x"))
        self.out(f"c = {_rnd(step, dtype)};")
        if staged:
            self.out(f"{stg}[r * {cols} + col] = c;")
        else:
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.dst, ['r'] + cidx, s.dst.tile)}, c);")
        self.close()
        if staged:
            self.out(f"{stg}[{rows * cols} + col] = c;")
        else:
            self.out(f"stagecc_stage::st({carry}, c);")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(s.dst.tile)
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.dst, idx, s.dst.tile)}, {stg}[e]);")
            self.close()
            cidx = self.elems_loop(s.carry.tile, "k")
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.carry, cidx, s.carry.tile)}, "
                     f"{stg}[{rows * cols} + k]);")
            self.close()

    def sync(self) -> None:
        self.out("__syncthreads();")

    def statement(self, s: Stmt) -> None:
        staged = _staged(s)
        self.out(f"{{  // {_describe(s)}")
        self.depth += 1
        if isinstance(s, ZeroTile):
            self.render_fill(s.dst, 0.0)
        elif isinstance(s, FillTile):
            self.render_fill(s.dst, s.value)
        elif isinstance(s, MatmulTile):
            self.render_matmul(s, staged)
        elif isinstance(s, ReduceTile):
            self.render_reduce(s, staged)
        elif isinstance(s, ScanTile):
            self.render_scan(s, staged)
        elif isinstance(s, EwiseTile):
            self.render_ewise(s, staged)
        else:
            raise EmitError(f"{self.kernel.name}: no CUDA emission for "
                            f"{type(s).__name__}")
        self.depth -= 1
        self.out("}")
        self.sync()

    def body(self, stmts: Sequence[Stmt]) -> None:
        for s in stmts:
            if isinstance(s, Loop):
                v = _cvar(s.var.name)
                self.out(f"for (int {v} = 0; {v} < {s.var.extent}; ++{v}) "
                         f"{{  // @{s.kind.value}")
                self.depth += 1
                self.body(s.body)
                self.depth -= 1
                self.out("}")
            else:
                self.statement(s)

    # -- the stage ------------------------------------------------------------

    def render(self) -> str:
        st = self.stage
        i = st.index
        params = []
        for n in st.params:
            c = self.ctype(n)
            params.append(f"const {c}* __restrict__ {self.ptr[n]}"
                          if n in self.read_only else f"{c}* {self.ptr[n]}")
        self.out("extern __shared__ __align__(16) unsigned char smem[];")
        if self.ws_bytes:
            # a bounded number of blocks, each walking programs with its
            # own workspace, zeroed per program as the shared scratch is
            params.append("unsigned char* __restrict__ wsp")
            self.out(f"unsigned char* const ws = wsp + (long long)blockIdx.x"
                     f" * {self.ws_bytes}LL;")
            self.out(f"for (long long p0 = blockIdx.x; p0 < {st.programs}; "
                     f"p0 += gridDim.x) {{")
            self.depth += 1
        for b in st.block_scratch:
            c = self.ctype(b.name)
            base = (f"smem + {self.smem_off[b.name]}" if b.name in
                    self.smem_off else f"ws + {self.ws_off[b.name]}")
            self.out(f"{c}* const {self.ptr[b.name]} = reinterpret_cast<{c}*>"
                     f"({base});  // {b.name} {'x'.join(map(str, b.shape))}")
        self.out(f"float* const mm = reinterpret_cast<float*>(smem + "
                 f"{self.mm_off});")
        self.out(f"float* const stg = reinterpret_cast<float*>("
                 f"{self.stg_at} + {self.stg_off});")
        self.out("int* const stgi = reinterpret_cast<int*>(stg);")
        if self.scratch_bytes:
            self.out(f"stagecc_stage::zero_shared<{self.nt}>(smem, "
                     f"{self.scratch_bytes});")
        if self.ws_scratch:
            self.out(f"stagecc_stage::zero_shared<{self.nt}>(ws, "
                     f"{self.ws_scratch});")
        if self.scratch_bytes or self.ws_scratch:
            self.sync()
        if st.launch_vars:
            self.out("long long pid = p0;" if self.ws_bytes
                     else "long long pid = blockIdx.x;")
            for v, g in reversed(st.launch_vars):
                self.out(f"const int {_cvar(v)} = (int)(pid % {g}); "
                         f"pid /= {g};")
        self.body(st.body)
        if self.ws_bytes:
            self.depth -= 1
            self.out("}")
        ws = (f", a {self.ws_bytes}-byte workspace a block in global memory "
              f"({st.ws_blocks} blocks)" if self.ws_bytes else "")
        head = (f"// stage {i}: {st.layout}, {self.smem} bytes of shared "
                f"memory{ws};\n// reads {', '.join(st.reads) or '-'}; writes "
                f"{', '.join(st.writes)}\n")
        kernel = (f"__global__ void __launch_bounds__({self.nt}) "
                  f"stage{i}({', '.join(params)}) {{\n"
                  + "\n".join(self.lines) + "\n}\n")
        casts = ", ".join(
            f"static_cast<{'const ' if n in self.read_only else ''}"
            f"{self.ctype(n)}*>({self.ptr[n]})" for n in st.params)
        vparams = "".join(f"void* {self.ptr[n]}, " for n in st.params)
        if self.ws_bytes:
            vparams += "void* wsp, "
            casts += ", static_cast<unsigned char*>(wsp)"
        blocks = st.ws_blocks if self.ws_bytes else st.programs
        opt_in = ""
        if self.smem > _SMEM_DEFAULT:
            opt_in = (f"  const cudaError_t attr = cudaFuncSetAttribute("
                      f"stage{i}, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                      f" {self.smem});\n"
                      f"  if (attr != cudaSuccess) return (int)attr;\n")
        launcher = (f'extern "C" int stagecc_stage{i}({vparams}void* stream) '
                    f"{{\n{opt_in}"
                    f"  stage{i}<<<{blocks}, {self.nt}, {self.smem}, "
                    f"static_cast<cudaStream_t>(stream)>>>({casts});\n"
                    f"  return (int)cudaGetLastError();\n}}\n")
        return head + kernel + "\n" + launcher


def _describe(s: Stmt) -> str:
    from . import ir_text
    return " ".join(" ".join(ir_text.print_stmt(s)).split())[:110]


def _render_general(kernel: Kernel, stages: Sequence[_Stage]) -> str:
    parts = [_StageRenderer(kernel, st).render() for st in stages]
    return (f"// Emitted by repro_torch.core.backend_cuda.emit_general from "
            f"the scheduled LoopIR\n// of {kernel.name}: {len(stages)} "
            f"stage(s), one kernel and one launcher each.\n"
            f'#include "stagecc_stage.cuh"\n\n' + "\n".join(parts))


def emit_general(kernel: Kernel, device="cuda") -> Callable[..., torch.Tensor]:
    """Emit a multi-nest kernel as a chain of per-nest CUDA kernels.

    ``f(*inputs) -> out``: inputs fill the non-output params in order; a
    param not passed starts as zeros if a stage reads it before an earlier
    stage writes it, and so does the output if no stage writes it.  The
    stages run in order, on the current stream; each stage's writes are
    new arrays.
    numpy inputs go to ``device``; tensors stay where they are.  On CPU
    tensors every stage runs ``stage_plain``."""
    kernel.verify()
    if len(kernel.outputs) != 1:
        raise EmitError(f"{kernel.name}: exactly one output supported")
    buffers = {b.name: b for b in kernel.params + kernel.scratch}
    stages = [_emit_stage(kernel, top, buffers, i)
              for i, top in enumerate(kernel.body)]
    source = _render_general(kernel, stages)
    lib = _Library(source)
    for st in stages:
        st.lib = lib
    out_name = kernel.outputs[0].name
    in_params = [b for b in kernel.params if b.name != out_name]
    # the params whose value before the first stage some stage can see
    zeroed, written = set(), set()
    for st in stages:
        zeroed |= set(st.reads) - set(st.writes) - written
        written |= set(st.writes)
    if out_name not in written:
        zeroed.add(out_name)

    def environment(*inputs) -> Dict[str, torch.Tensor]:
        """The host-level buffer environment before the first stage."""
        if len(inputs) > len(in_params):
            raise ValueError(f"{kernel.name}: expected <= {len(in_params)} "
                             f"inputs, got {len(inputs)}")
        env = {b.name: as_tensor(x, _TORCH_DTYPE[b.type.dtype], device)
               for b, x in zip(in_params, inputs)}
        for b in in_params[:len(inputs)]:
            if tuple(env[b.name].shape) != b.shape:
                raise ValueError(f"{kernel.name}: {b.name} has shape "
                                 f"{tuple(env[b.name].shape)}, expected "
                                 f"{b.shape}")
        devices = {t.device for t in env.values()}
        if len(devices) > 1:
            raise ValueError(f"{kernel.name}: inputs on several devices: "
                             f"{devices}")
        dev = devices.pop() if devices else torch.device(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{kernel.name}: runs on cuda or cpu, not {dev}")
        env = {n: t.contiguous() for n, t in env.items()}
        for b in kernel.params:
            # (the first param, too, if nothing else tells the stages the
            # device)
            if b.name not in env and (b.name in zeroed or not env):
                env[b.name] = torch.zeros(b.shape, device=dev, dtype=
                                          _TORCH_DTYPE[b.type.dtype])
        return env

    def fn(*inputs):
        env = environment(*inputs)
        for st in stages:
            st(env)
        return env[out_name]

    fn.__name__ = f"stagecc_cuda_{kernel.name}"
    fn.plan = None                       # the general path has no _Plan
    fn.stages = stages                   # reads / writes, per-stage calls
    fn.source = source                   # the CUDA text built at first launch
    fn.environment = environment
    fn.out_name = out_name
    return fn


emit_general.launches = 0   # stage kernel launches (CUDA tensors)


# ---- the plain version --------------------------------------------------------


def stage_plain(stage: _Stage, env: Dict[str, torch.Tensor]) -> None:
    """The plain PyTorch version of one stage, as the Pallas body runs
    it: the grid's programs in order, each with fresh zeroed scratch, the
    inner loops as Python loops, every operand tile read before the
    statement writes, the same casts and broadcasting.  Its writes are new
    arrays (NaN where no program writes), rebound in ``env``."""
    dev = next(iter(env.values())).device
    outs = _fresh(stage, dev)
    hbm = {**{n: env[n] for n in stage.params if n not in outs}, **outs}
    for pid in itertools.product(*(range(g) for g in stage.grid)):
        mem = dict(hbm)
        mem.update({b.name: torch.zeros(b.shape, device=dev, dtype=
                                        _TORCH_DTYPE[b.type.dtype])
                    for b in stage.scratch})
        _run_plain(stage.inner, dict(zip(stage.grid_vars, pid)), mem, dev)
    env.update(outs)


def _run_plain(stmts, env: Dict[str, int], mem: Dict[str, torch.Tensor],
               dev) -> None:
    def read(r: TileRef):
        return mem[r.buffer.name][r.slices(env)].clone()

    def write(r: TileRef, val: torch.Tensor):
        dst = mem[r.buffer.name]
        dst[r.slices(env)] = _cast(val, dst.dtype)

    def full(r: TileRef, value: float):
        return torch.full(r.tile, value, dtype=torch.float32, device=dev)

    for s in stmts:
        if isinstance(s, Loop):
            for t in range(s.var.extent):
                env[s.var.name] = t
                _run_plain(s.body, env, mem, dev)
            del env[s.var.name]
        elif isinstance(s, ZeroTile):
            write(s.dst, full(s.dst, 0.0))
        elif isinstance(s, FillTile):
            write(s.dst, full(s.dst, s.value))
        elif isinstance(s, MatmulTile):
            # jnp.dot's contraction: (lhs leading, M, rhs leading, N)
            c = torch.tensordot(read(s.lhs).float(), read(s.rhs).float(),
                                dims=([-1], [-2]))
            if s.accumulate:
                c = read(s.dst).float() + c
            write(s.dst, c)
        elif isinstance(s, ReduceTile):
            src = read(s.src)
            r = (src.amax(dim=-1, keepdim=True) if s.kind == "max"
                 else src.sum(dim=-1, keepdim=True))
            if s.accumulate:
                d = read(s.dst)
                r = torch.maximum(d, r) if s.kind == "max" else d + r
            write(s.dst, r)
        elif isinstance(s, ScanTile):
            srcs = [read(r) for r in s.srcs]
            c = read(s.carry)[0]
            rows = []
            for t in range(srcs[0].shape[0]):
                c = srcs[0][t] * c + srcs[1][t] if s.kind == "linear" \
                    else c + srcs[0][t]
                rows.append(c)
            write(s.dst, torch.stack(rows))
            write(s.carry, c[None])
        elif isinstance(s, EwiseTile):
            if s.op == "ones":
                write(s.dst, full(s.dst, 1.0))
                continue
            srcs = [read(r) for r in s.srcs]
            if s.op == "copy1":
                write(s.dst, srcs[0].reshape(s.dst.tile))
            elif s.op == "cast":
                write(s.dst, srcs[0])
            else:
                if len(srcs) == 2 and srcs[1].ndim < srcs[0].ndim:
                    srcs[1] = srcs[1][(None,) * (srcs[0].ndim
                                                 - srcs[1].ndim)]
                write(s.dst, _EWISE[s.op](*srcs))
        else:
            raise EmitError(f"no plain version of {type(s).__name__}")


def general_plain(fn: Callable, *inputs) -> torch.Tensor:
    """The plain PyTorch version of an ``emit_general`` callable ``fn``
    on ``inputs``: every stage through ``stage_plain``, on the inputs'
    device."""
    env = fn.environment(*inputs)
    for st in fn.stages:
        stage_plain(st, env)
    return env[fn.out_name]
