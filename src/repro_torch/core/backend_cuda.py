"""CUDA backend: emit a GEMM kernel for Hopper from scheduled LoopIR.

The port of the contraction emitter of ``backend_pallas.py``
(``_analyze``, ``_emit_gemm``, ``_apply_epilogue``, ``emit``).  It accepts
the same structured subset, a single scheduled contraction nest::

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
generated ``__device__`` functor.  The source is built by nvcc at the first launch on a CUDA
tensor (``kernels/_build.load_source``).  On CPU tensors the emitted
callable runs ``gemm_plain``, the plain PyTorch version of the same
arithmetic.

``emit`` raises :class:`EmitError` for a kernel outside that subset (the
``nested`` / ``inner_flattened`` schedules, multi-nest graphs); there is
no general emitter in the port yet, and nothing takes over in its place.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

from .backend_torch import _EWISE, _TORCH_DTYPE, as_tensor
from .loop_ir import (EwiseTile, Kernel, Loop, LoopKind, MatmulTile,
                      MemSpace, Stmt, TileRef, ZeroTile)


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
    """Emit ``f(*hbm_inputs) -> out`` for a scheduled contraction.

    Raises :class:`EmitError` for a kernel outside the single-nest
    contraction subset.  numpy inputs go to ``device``; tensor inputs
    stay where they are.  All inputs on the CPU run ``gemm_plain``; on a
    CUDA device the emitted kernel launches, or the call raises."""
    return _emit_gemm(kernel, device)


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


def _emit_gemm(kernel: Kernel, device="cuda") -> Callable[..., torch.Tensor]:
    """The single-nest contraction emitter (see module doc)."""
    plan = _analyze(kernel)
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
