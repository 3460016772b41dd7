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

and renders it as CUDA C++ source on the template
``kernels/csrc/stagecc_gemm.cuh``: the tiles (tm, tn, tk) as constants,
whether the k tiles' f32 products are summed in f32 (``tpu_mxu``: K
inside the block) or rounded to the output dtype after each tile
(``tpu_mxu_kgrid``: the reference revisits its output block along a k
grid axis), the element types, and the ``EwiseTile`` epilogue chain as a
generated ``__device__`` functor.  On CPU tensors the emitted callable
runs ``gemm_plain``, the plain PyTorch version of the same arithmetic.
Its own refusals (element types other than f32 / bf16, epilogue inputs
shaped other than (N,) or (M, N), tiles that do not divide the problem)
stay refusals: such a contraction gets no kernel.

**The general emitter** (``emit_general``, after ``_emit_stage``) takes
what the classifier refuses: the ``nested`` / ``inner_flattened``
schedules and the multi-nest serving-kernel graphs.  Each top-level nest
is a stage: its leading @grid chain is the CUDA grid, every other loop a
C loop in the block, scratch lives in shared memory, and every statement
is a block-cooperative loop over its tile (``kernels/csrc/
stagecc_stage.cuh``).  One source holds every stage of a kernel.  On CPU
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

from .backend_torch import _EWISE, _TORCH_DTYPE, as_tensor
from .loop_ir import (Buffer, EwiseTile, FillTile, Kernel, Loop, LoopKind,
                      MatmulTile, MemSpace, ReduceTile, ScanTile, Stmt,
                      TileRef, ZeroTile, _stmt_refs, _stmt_written_refs)


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
                         for b in kernel.params + kernel.scratch})


def emit(kernel: Kernel, device="cuda") -> Callable[..., torch.Tensor]:
    """Emit ``f(*hbm_inputs) -> out`` for a scheduled kernel.

    Dispatch, as ``backend_pallas.emit``: the single-nest contraction
    classifier (``_analyze``) first, and the general multi-nest emitter
    (``emit_general``) only where the classifier refuses.  A contraction
    the classifier takes but the GEMM template does not is refused here
    (:class:`EmitError`) rather than sent down the general path.  numpy
    inputs go to ``device``; tensor inputs stay where they are.  All
    inputs on the CPU run the plain version; on a CUDA device the emitted
    kernel launches, or the call raises."""
    try:
        plan = _analyze(kernel)
    except EmitError:
        return emit_general(kernel, device)
    return _emit_gemm(kernel, device, plan)


# C type of each element type the template takes
_CTYPE = {"float32": "float", "bfloat16": "__nv_bfloat16"}

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


def _layout(kernel: Kernel, plan: _Plan) -> Dict[str, str]:
    """Check that the plan is a row-major (M, K) @ (K, N) -> (M, N)
    contraction the template takes, and return how each epilogue input
    is indexed from the output element (``col`` or ``row * n + col``)."""
    tm, tn, tk = plan.tiles
    lhs, rhs = plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name
    for name in (lhs, rhs, plan.out_buffer, *plan.epilogue_inputs):
        if plan.dtypes[name] not in _CTYPE:
            raise EmitError(f"{kernel.name}: {name} is {plan.dtypes[name]}; "
                            f"the CUDA GEMM takes {sorted(_CTYPE)}")
    (_, (row, kl)), (_, (kr, col)) = (plan.block_specs[lhs],
                                      plan.block_specs[rhs])
    if not (isinstance(row, str) and isinstance(col, str) and kl == kr
            and plan.block_specs[plan.out_buffer] == ((tm, tn), (row, col))):
        raise EmitError(f"{kernel.name}: not an (i, j)-tiled contraction "
                        f"{plan.block_specs}")
    index = {}
    for name in plan.epilogue_inputs:
        spec = plan.block_specs[name]
        if spec == ((tn,), (col,)):
            index[name] = "col"
        elif spec == ((tm, tn), (row, col)):
            index[name] = "row * n + col"
        else:
            raise EmitError(f"{kernel.name}: epilogue input {name} "
                            f"{spec} is neither (N,) nor (M, N)")
    return index


def _promote(*dtypes: str) -> str:
    """Result type of an elementwise op, by the JAX/PyTorch rule for the
    two types the template takes."""
    return "float32" if "float32" in dtypes else "bfloat16"


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
                args.append((f"stagecc::to_f32(in{extras.index(name)}"
                             f"[{index[name]}])", plan.dtypes[name]))
            else:
                raise EmitError(f"epilogue src {name} not mapped")
        dtype = _promote(*(t for _, t in args))
        expr = _EWISE_CUDA[s.op].format(*(c for c, _ in args))
        if dtype == "bfloat16":
            expr = f"stagecc::round_to<__nv_bfloat16>({expr})"
        lines.append(f"    const float t{n} = {expr};  // {s.op}")
        env[s.dst.buffer.name] = val = (f"t{n}", dtype)
    result = env.get(plan.out_buffer, val)[0]
    fields = "".join(f"  const {_CTYPE[plan.dtypes[e]]}* in{i};\n"
                     for i, e in enumerate(extras))
    params = "".join(f"const void* in{i}, " for i in range(len(extras)))
    inits = ", ".join(f"static_cast<const {_CTYPE[plan.dtypes[e]]}*>(in{i})"
                      for i, e in enumerate(extras))
    schedule = ("k tiles on the grid, rounded to the output type after "
                "each" if kgrid else "K inside the block, summed in f32")
    ta, tb = (_CTYPE[plan.dtypes[plan.matmul.lhs.buffer.name]],
              _CTYPE[plan.dtypes[plan.matmul.rhs.buffer.name]])
    return f"""\
// Emitted by repro_torch.core.backend_cuda from a scheduled contraction:
// tiles {tm} x {tn} x {tk}, {schedule}.
#include "stagecc_gemm.cuh"

namespace {{

struct Epilogue {{
{fields}  __device__ __forceinline__ float operator()(float v, long long row,
                                              long long col, int n) const {{
{chr(10).join(lines)}
    return {result};
  }}
}};

}}  // namespace

extern "C" int stagecc_gemm_launch(const void* a, const void* b, {params}void* out,
                                   int m, int n, int k, long long sam,
                                   long long sak, long long sbk, long long sbn,
                                   void* stream) {{
  return stagecc::launch<{tm}, {tn}, {tk}, {str(kgrid).lower()}, {ta}, {tb}, {_CTYPE[out_t]}>(
      a, b, out, m, n, k, sam, sak, sbk, sbn, Epilogue{{{inits}}}, stream);
}}
"""


def _emit_gemm(kernel: Kernel, device="cuda",
               plan: Optional[_Plan] = None) -> Callable[..., torch.Tensor]:
    """The single-nest contraction emitter (see module doc)."""
    plan = plan or _analyze(kernel)
    index = _layout(kernel, plan)
    source = _render(kernel, plan, index)
    shapes = {b.name: b.shape for b in kernel.params}
    lhs, rhs = plan.matmul.lhs.buffer.name, plan.matmul.rhs.buffer.name
    (m, kdim), n = shapes[lhs], shapes[rhs][1]
    tm, tn, tk = plan.tiles
    if m % tm or n % tn or kdim % tk or (m // tm) * (n // tn) >= 2 ** 31:
        raise EmitError(f"{kernel.name}: tiles {plan.tiles} do not fit "
                        f"({m}, {n}, {kdim})")
    launcher = None         # the built kernel's entry, at the first launch

    def fn(*inputs):
        nonlocal launcher
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
        if launcher is None:
            launcher = _build.load_source(source).stagecc_gemm_launch
            launcher.argtypes = ([ctypes.c_void_p] * (3 + len(epi))
                                 + [ctypes.c_int] * 3
                                 + [ctypes.c_longlong] * 4
                                 + [ctypes.c_void_p])
            launcher.restype = ctypes.c_int
        a, b = args[lhs], args[rhs]
        out = torch.empty((m, n), dtype=_TORCH_DTYPE[plan.dtypes[
            plan.out_buffer]], device=dev)
        # A and B are read through their strides (the backward passes
        # transposed views); the small epilogue inputs are made contiguous
        epi = [t.contiguous() for t in epi]
        with torch.cuda.device(dev):
            err = launcher(
                a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in epi),
                out.data_ptr(), m, n, kdim, *a.stride(), *b.stride(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{kernel.name}: CUDA GEMM launch failed: "
                               f"cudaError {err}")
        from repro_torch.kernels import gemm
        gemm.cuda_gemm.launches += 1
        return out

    fn.__name__ = f"stagecc_cuda_{kernel.name}"
    fn.plan = plan          # exposed for tests / resource introspection
    fn.source = source      # the CUDA text built at the first launch
    return fn


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
    in full f32 as long as TF32 stays off (PyTorch's default)."""
    out_dtype = _TORCH_DTYPE[plan.dtypes[plan.out_buffer]]
    kgrid = plan.k_grid_var is not None
    tk = plan.tiles[2]
    acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device,
                      dtype=out_dtype if kgrid else torch.float32)
    for k0 in range(0, a.shape[1], tk):
        p = a[:, k0:k0 + tk].float() @ b[k0:k0 + tk].float()
        acc = acc + (p.to(out_dtype) if kgrid else p)
    val = _apply_epilogue(plan, acc, dict(zip(plan.epilogue_inputs, epi)))
    return val.to(out_dtype)


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
    inputs = dict(zip(plan.epilogue_inputs, epi))
    return tuple(_apply_epilogue(plan, x.to(acc_t), inputs).to(out).float()
                 for x in (lo, hi))


# --------------------------------------------------------------------------
# general multi-nest emitter
# --------------------------------------------------------------------------
#
# The serving-kernel graphs lower to several top-level nests chained
# through HBM temporaries (matmul -> mask add -> carried max -> exp ->
# carried sum -> matmul -> div), which the single-nest classifier cannot
# express.  As in ``backend_pallas``, each top-level statement is a stage:
#
#   * the nest's leading @grid chain is the grid, one program per CUDA
#     block; every other loop (@seq, @unrolled) is a C loop in the block,
#     walked in the schedule's order;
#   * scratch (@vreg / @vmem) lives in the block's shared memory, zeroed
#     per program, as the reference's local values are fresh per program;
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


@dataclasses.dataclass
class _Stage:
    """One top-level nest: what it reads and writes, and how it runs."""
    index: int
    kernel_name: str
    grid_vars: List[str]
    grid: Tuple[int, ...]
    inner: List[Stmt]
    reads: List[str]                     # HBM buffers read, first-use order
    writes: List[str]                    # HBM buffers written
    scratch: List[Buffer]
    buffers: Dict[str, Buffer]
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
    def programs(self) -> int:
        return math.prod(self.grid)

    @property
    def threads(self) -> int:
        """A grid that fills the card gets 256-thread blocks; a stage of
        few programs (one, for a nest with no grid loop) gets 1024 threads
        per block, so its one SM has loads in flight."""
        return 256 if self.programs >= 132 else 1024

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
        outs = _fresh(self, dev)
        ptrs = [outs[n] if n in outs else env[n] for n in self.params]
        for name, t in zip(self.params, ptrs):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{self.kernel_name}: {name} is not a "
                                 f"contiguous array on {dev}")
        launcher = self.lib.stage(self.index, len(ptrs))
        with torch.cuda.device(dev):
            err = launcher(*(t.data_ptr() for t in ptrs),
                           torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{self.kernel_name}: stage {self.index} "
                               f"launch failed: cudaError {err}")
        emit_general.launches += 1
        env.update(outs)


def _fresh(stage: _Stage, dev) -> Dict[str, torch.Tensor]:
    """New arrays for the stage's writes.  They start as NaN, as the
    reference's outputs do in Pallas interpret mode, so a tile no program
    writes, or a read of a written buffer before its write, shows the
    same in both."""
    return {n: torch.full(stage.buffers[n].shape, float("nan"),
                          dtype=_TORCH_DTYPE[stage.buffers[n].type.dtype],
                          device=dev)
            for n in stage.writes}


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
            n += 2 * s.macs
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
    """The analysis of ``backend_pallas._emit_stage``: the grid, the inner
    statements, the HBM buffers read and written and the scratch, with
    the reference's refusals."""
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
    used = {r.buffer.name for s in _walk_stmts([top])
            if not isinstance(s, Loop) for r in _stmt_refs(s)}
    scratch = [b for b in kernel.scratch if b.name in used]
    grid_t = tuple(grid)
    return _Stage(index=index, kernel_name=kernel.name, grid_vars=grid_vars,
                  grid=grid_t, inner=inner, reads=reads, writes=writes,
                  scratch=scratch, buffers=buffers,
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


def _rnd(expr: str, dtype: str) -> str:
    """``expr`` rounded to ``dtype`` (a no-op for f32)."""
    return f"stagecc_stage::bf16r({expr})" if dtype == "bfloat16" else expr


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _mm_layout(nt: int, tm: int, tn: int) -> Tuple[int, int, int, int]:
    """(RX, MI, MJ, shared bytes) of ``matmul_tile`` for a tm x tn tile
    with nt threads: an RX-wide thread grid (RY = nt / RX rows, at most
    256), each thread an MI x MJ register tile (at most 8 x 8, or 4 x 4
    where 1024 threads leave 64 registers each), a pass at most 256 rows
    high."""
    cap = 4 if nt == 1024 else 8
    rx = min(max(_pow2ceil(tn), nt // 256), 32 if nt == 1024 else 16)
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
        names = stage.params + [b.name for b in stage.scratch]
        for n in names:
            if self.dtypes[n] not in _CTYPE:
                raise EmitError(f"{kernel.name}: {n} is {self.dtypes[n]}; "
                                f"the CUDA stages take {sorted(_CTYPE)}")
        self.ptr = {n: f"g{i}" for i, n in enumerate(stage.params)}
        self.ptr.update({b.name: f"s{i}"
                         for i, b in enumerate(stage.scratch)})
        self.read_only = set(stage.reads) - set(stage.writes)
        # shared memory: scratch, then matmul staging, then staged results
        self.smem_off: Dict[str, int] = {}
        off = 0
        for b in stage.scratch:
            self.smem_off[b.name] = off
            off += -(-b.type.nbytes // 16) * 16
        self.scratch_bytes = off
        mm = stg = 0
        for s in _walk_stmts(stage.inner):
            if isinstance(s, MatmulTile):
                tm, tn = s.dst.tile[-2:]
                mm = max(mm, _mm_layout(self.nt, tm, tn)[3])
            if _staged(s):
                extra = s.carry.tile_elems if isinstance(s, ScanTile) else 0
                stg = max(stg, 4 * (s.dst.tile_elems + extra))
        self.mm_off, self.stg_off = off, off + mm
        self.smem = off + mm + -(-stg // 16) * 16
        if self.smem > _SMEM_LIMIT:
            raise EmitError(
                f"{kernel.name}: stage {stage.index} needs {self.smem} "
                f"bytes of shared memory (scratch {self.scratch_bytes}); a "
                f"block has {_SMEM_LIMIT}")
        self.lines: List[str] = []
        self.depth = 1
        self.onames: Dict[int, str] = {}     # id(TileRef) -> origin name

    # -- helpers ----------------------------------------------------------

    def out(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def ctype(self, name: str) -> str:
        return _CTYPE[self.dtypes[name]]

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
            val = "1.f"
        elif s.op == "copy1":
            src = s.srcs[0]
            if src.tile_elems != s.dst.tile_elems:
                raise EmitError(f"{self.kernel.name}: copy1 of {src.tile} "
                                f"into {shape}")
            # the flat element e of the dst is the flat element e of src
            self.out("const int f = e;")
            sidx = self.elems_index("f", src.tile)
            self.out(f"const float x0 = stagecc_stage::ld("
                     f"{self.element(src, sidx, src.tile)});")
            val = "x0"
        else:
            if s.op != "cast" and s.op not in _EWISE_CUDA:
                raise EmitError(f"{self.kernel.name}: no CUDA emission for "
                                f"op {s.op!r}")
            for i, r in enumerate(s.srcs):
                self.out(f"const float x{i} = stagecc_stage::ld("
                         f"{self.element(r, idx, shape)});")
            if s.op == "cast":
                val = "x0"
            else:
                args = [f"x{i}" for i in range(len(s.srcs))]
                dtype = _promote(*(self.dtypes[r.buffer.name]
                                   for r in s.srcs))
                val = _rnd(_EWISE_CUDA[s.op].format(*args), dtype)
        if staged:
            self.out(f"stg[e] = {val};")
        else:
            self.out(f"stagecc_stage::st({self.element(s.dst, idx, shape)},"
                     f" {val});")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(shape)
            self.out(f"stagecc_stage::st({self.element(s.dst, idx, shape)},"
                     f" stg[e]);")
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

    def view(self, r: TileRef) -> str:
        if len(r.tile) != 2:
            raise EmitError(f"{self.kernel.name}: rank-{len(r.tile)} matmul "
                            f"operand {r}")
        rs, cs = _strides(r.buffer.shape)
        # only the read-only global pointers are const
        const = "const " if r.buffer.name in self.read_only else ""
        return (f"stagecc_stage::View2<{const}{self.ctype(r.buffer.name)}>"
                f"{{{self.ptr[r.buffer.name]} + {self.onames[id(r)]}, "
                f"{rs}LL, {cs}LL}}")

    def render_matmul(self, s: MatmulTile, staged: bool) -> None:
        tm, tk = s.lhs.tile[-2:]
        tn = s.rhs.tile[-1]
        rx, mi, mj, _ = _mm_layout(self.nt, tm, tn)
        self.bind(s.dst, s.lhs, s.rhs)
        dst = (f"stagecc_stage::View2<float>{{stg, {tn}LL, 1LL}}" if staged
               else self.view(s.dst))
        acc = "true" if s.accumulate and not staged else "false"
        self.out(f"stagecc_stage::matmul_tile<{self.nt}, {tm}, {tn}, {tk}, "
                 f"{rx}, {mi}, {mj}, {acc}>(")
        self.out(f"    {self.view(s.lhs)},")
        self.out(f"    {self.view(s.rhs)},")
        self.out(f"    {dst}, mm);")
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
        combined = _promote(self.dtypes[s.dst.buffer.name], src_t)
        self.bind(s.dst, s.src)
        self.out(f"for (int row = threadIdx.x / 32; row < {rows}; "
                 f"row += {self.nt // 32}) {{")
        self.depth += 1
        ridx = self.elems_index("row", rows_shape)
        s_last = _strides(s.src.buffer.shape)[-1]
        src_row = self.element(s.src, ridx + ["0"], s.src.tile)
        self.out(f"float v = {'-INFINITY' if mx else '0.f'};")
        self.out(f"for (int c = threadIdx.x % 32; c < {width}; c += 32) {{")
        self.out(f"  const float x = stagecc_stage::ld({src_row} + c * "
                 f"{s_last}LL);")
        self.out(f"  v = {'fmaxf(v, x)' if mx else 'v + x'};")
        self.out("}")
        self.out(f"v = {_rnd(f'stagecc_stage::warp_reduce<{str(mx).lower()}>(v)', src_t)};")
        dst = self.element(s.dst, ridx + ["0"], s.dst.tile)
        self.out("if (threadIdx.x % 32 == 0) {")
        if staged:
            self.out("  stg[row] = v;")
        else:
            if s.accumulate:
                d = f"stagecc_stage::ld({dst})"
                comb = f"fmaxf({d}, v)" if mx else f"{d} + v"
                self.out(f"  v = {_rnd(comb, combined)};")
            self.out(f"  stagecc_stage::st({dst}, v);")
        self.out("}")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(s.dst.tile)
            d = self.element(s.dst, idx, s.dst.tile)
            val = "stg[e]"
            if s.accumulate:
                dv = f"stagecc_stage::ld({d})"
                val = _rnd(f"fmaxf({dv}, stg[e])" if mx
                           else f"{dv} + stg[e]", combined)
            self.out(f"stagecc_stage::st({d}, {val});")
            self.close()

    def render_scan(self, s: ScanTile, staged: bool) -> None:
        rows = s.dst.tile[0]
        cols_shape = s.dst.tile[1:]
        cols = math.prod(cols_shape)
        dtype = _promote(self.dtypes[s.carry.buffer.name],
                         *(self.dtypes[r.buffer.name] for r in s.srcs))
        self.bind(s.dst, s.carry, *s.srcs)
        self.out(f"for (int col = threadIdx.x; col < {cols}; "
                 f"col += {self.nt}) {{")
        self.depth += 1
        cidx = self.elems_index("col", cols_shape)
        carry = self.element(s.carry, ["0"] + cidx, s.carry.tile)
        self.out(f"float c = stagecc_stage::ld({carry});")
        self.out("#pragma unroll 4")
        self.out(f"for (int r = 0; r < {rows}; ++r) {{")
        self.depth += 1
        srcs = [self.element(r, ["r"] + cidx, s.dst.tile) for r in s.srcs]
        if s.kind == "linear":
            self.out(f"const float a = stagecc_stage::ld({srcs[0]});")
            self.out(f"const float x = stagecc_stage::ld({srcs[1]});")
            self.out(f"c = {_rnd('__fadd_rn(__fmul_rn(a, c), x)', dtype)};")
        else:
            self.out(f"const float x = stagecc_stage::ld({srcs[0]});")
            self.out(f"c = {_rnd('__fadd_rn(c, x)', dtype)};")
        if staged:
            self.out(f"stg[r * {cols} + col] = c;")
        else:
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.dst, ['r'] + cidx, s.dst.tile)}, c);")
        self.close()
        if staged:
            self.out(f"stg[{rows * cols} + col] = c;")
        else:
            self.out(f"stagecc_stage::st({carry}, c);")
        self.close()
        if staged:
            self.sync()
            idx = self.elems_loop(s.dst.tile)
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.dst, idx, s.dst.tile)}, stg[e]);")
            self.close()
            cidx = self.elems_loop(s.carry.tile, "k")
            self.out(f"stagecc_stage::st("
                     f"{self.element(s.carry, cidx, s.carry.tile)}, "
                     f"stg[{rows * cols} + k]);")
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
        for b in st.scratch:
            c = self.ctype(b.name)
            self.out(f"{c}* const {self.ptr[b.name]} = reinterpret_cast<{c}*>"
                     f"(smem + {self.smem_off[b.name]});  // {b.name} "
                     f"{'x'.join(map(str, b.shape))}")
        self.out(f"float* const mm = reinterpret_cast<float*>(smem + "
                 f"{self.mm_off});")
        self.out(f"float* const stg = reinterpret_cast<float*>(smem + "
                 f"{self.stg_off});")
        if self.scratch_bytes:
            self.out(f"stagecc_stage::zero_shared<{self.nt}>(smem, "
                     f"{self.scratch_bytes});")
            self.sync()
        if st.grid_vars:
            self.out("long long pid = blockIdx.x;")
            for v, g in reversed(list(zip(st.grid_vars, st.grid))):
                self.out(f"const int {_cvar(v)} = (int)(pid % {g}); "
                         f"pid /= {g};")
        self.body(st.inner)
        grid = "x".join(map(str, st.grid)) or "none"
        head = (f"// stage {i}: grid [{grid}] ({st.programs} blocks of "
                f"{self.nt} threads, {self.smem} bytes of shared memory);"
                f"\n// reads {', '.join(st.reads) or '-'}; writes "
                f"{', '.join(st.writes)}\n")
        kernel = (f"__global__ void __launch_bounds__({self.nt}) "
                  f"stage{i}({', '.join(params)}) {{\n"
                  + "\n".join(self.lines) + "\n}\n")
        casts = ", ".join(
            f"static_cast<{'const ' if n in self.read_only else ''}"
            f"{self.ctype(n)}*>({self.ptr[n]})" for n in st.params)
        vparams = "".join(f"void* {self.ptr[n]}, " for n in st.params)
        opt_in = ""
        if self.smem > _SMEM_DEFAULT:
            opt_in = (f"  const cudaError_t attr = cudaFuncSetAttribute("
                      f"stage{i}, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                      f" {self.smem});\n"
                      f"  if (attr != cudaSuccess) return (int)attr;\n")
        launcher = (f'extern "C" int stagecc_stage{i}({vparams}void* stream) '
                    f"{{\n{opt_in}"
                    f"  stage{i}<<<{st.programs}, {self.nt}, {self.smem}, "
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

    ``f(*inputs) -> out``: inputs fill the non-output params in order;
    params not passed, and the output, start as zeros.  The stages run in
    order, on the current stream; each stage's writes are new arrays.
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
            if b.name not in env:
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
        dst[r.slices(env)] = val.to(dst.dtype)

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
            c = read(s.lhs).float() @ read(s.rhs).float()
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
