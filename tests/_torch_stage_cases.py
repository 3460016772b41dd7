"""Inputs and hand-written LoopIR kernels shared by the general emitter's
CPU parity tests (``test_torch_compiled_kernels.py``) and card tests
(``test_torch_cuda.py``).  Imports the port only, never JAX."""

import numpy as np

import repro_torch.core.frontend as fe
from repro_torch.core import ir_text
from repro_torch.core.passes import PassManager

NEG = -1e30


def attn_mask(sq, sk, causal=True, window=None, valid=None):
    """tests/test_compiled_kernels.py's additive mask: 0 where query t (at
    cache position t + sk - sq) may attend, -1e30 elsewhere."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    if valid is not None:
        keep &= kpos < valid
    return np.where(keep, 0.0, NEG).astype(np.float32)


def flash_inputs(sq, sk, d, seed=0, window=None):
    """(q, k, v) as (1, S, d) and the flash graph's inputs on them: q
    pre-scaled, k transposed, the causal (and window) mask."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    inputs = [q[0] / np.sqrt(d).astype(np.float32), k[0].T.copy(), v[0],
              attn_mask(sq, sk, causal=True, window=window)]
    return (q, k, v), inputs


def ssd_inputs(s, p, n, head, seed=0):
    """(x, dt, A, B, C) of H = head + 1 heads and the SSD graph's inputs
    for ``head``: the decays, the updates, C broadcast along P and the
    group-sum matrix."""
    H = head + 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, H, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (s, H)).astype(np.float32)
    A = rng.uniform(-1.0, -0.1, (H,)).astype(np.float32)
    B = rng.standard_normal((s, n)).astype(np.float32)
    C = rng.standard_normal((s, n)).astype(np.float32)
    a = np.repeat(np.exp(dt[:, head] * A[head])[:, None], p * n, axis=1)
    u = ((dt[:, head, None] * x[:, head, :])[:, :, None]
         * B[:, None, :]).reshape(s, p * n)
    ct = np.broadcast_to(C[:, None, :], (s, p, n)).reshape(s, p * n).copy()
    g = np.kron(np.eye(p), np.ones((n, 1))).astype(np.float32)
    inputs = [a.astype(np.float32), u.astype(np.float32), ct, g]
    return (x, dt, A, B, C), inputs


def all_ops_graph(F, n):
    """Every elementwise op of the table, both carried reductions (one
    keepdims=False, so a ``copy1``), a linear scan and a cumsum scan, a
    matmul and a bias add, in one traced graph of frontend module ``F``."""
    def f(a, b, c, x):
        s = F.maximum((a + b - c) * a, b)
        p = F.exp(-F.relu(s))                      # in (0, 1]
        s = F.div(s, p + F.exp(c))
        s = s._emit("tanh") + s._emit("sigmoid") + F.gelu(s)
        q = s._emit("abs") + F.exp(a)              # > 0
        s = s + q._emit("sqrt") + q._emit("rsqrt") + q._emit("log1p")
        s = s - F.reduce(s, kind="max", axis=1)
        rows = F.reduce(s, kind="sum", axis=1, keepdims=False)
        h = F.scan(F.exp(-F.relu(b)), s, axis=0) + F.cumsum(x, axis=0)
        return F.matmul(h, c)._emit("bias_add", [rows])
    return F.trace(f, [F.spec((n, n))] * 4, name="allops")


def bf16_graph(F, n):
    """A softmax-like chain on bf16 inputs: bf16 reductions combined into
    f32 accumulators, bf16 elementwise results, and a matmul that sums in
    a bf16 accumulator (``acc_dtype``)."""
    def f(a, b, x):
        y = F.exp(x - F.reduce(x, kind="max", axis=1)) * x
        y = F.div(y, F.reduce(y, kind="sum", axis=1))
        return a._emit("matmul", [b], acc_dtype="bfloat16") + y
    return F.trace(f, [F.spec((n, n), "bfloat16")] * 3, name="bf16chain")


def all_ops_text(n=8, t=4):
    """The all-ops graph lowered with tiles t, and a last nest that adds a
    ``vpu.ones`` scratch tile and casts the sum to a bf16 output (lowering
    makes neither), as LoopIR text that both packages parse."""
    kern = PassManager.parse(f"lower{{tile_m={t},tile_n={t},tile_k={t}}}") \
        .run(all_ops_graph(fe, n)).artifact
    text = ir_text.print_ir(kern)
    out = kern.outputs[0].name
    text = text.replace(f"-> ({out})", "-> (cast_out)")
    text = text.replace(
        f"{out}: tensor<{n}x{n}xfloat32> @hbm)",
        f"{out}: tensor<{n}x{n}xfloat32> @hbm, plus1: tensor<{n}x{n}x"
        f"float32> @hbm, cast_out: tensor<{n}x{n}xbfloat16> @hbm)")
    text = text.replace(") {\n", f") {{\n  alloc ones_s: tensor<{t}x{t}x"
                                  f"float32> @vmem\n", 1)
    tile = f"c1, c2 : {t}x{t}"
    nest = (f"  for %c1 in [0,{n // t}) @seq {{\n"
            f"    for %c2 in [0,{n // t}) @seq {{\n"
            f"      ones_s[0, 0 : {t}x{t}] = vpu.ones()\n"
            f"      plus1[{tile}] = vpu.add({out}[{tile}], "
            f"ones_s[0, 0 : {t}x{t}])\n"
            f"      cast_out[{tile}] = vpu.cast(plus1[{tile}])\n"
            f"    }}\n  }}\n}}")
    return text.rstrip()[:-1] + nest


# statements whose destination is also their operand, so the CUDA stage
# computes each into shared memory first (backend_cuda._staged)
ALIAS = """\
stagecc.kernel @alias(arg0: tensor<8x8xfloat32> @hbm, arg1: tensor<8x8xfloat32> @hbm, out: tensor<8x8xfloat32> @hbm) -> (out) {
  alloc acc: tensor<8x8xfloat32> @vreg
  for %i in [0,1) @seq {
    acc[0, 0 : 8x8] = vpu.copy(arg0[0, 0 : 8x8])
    acc[0, 0 : 8x8] += mxu.matmul(acc[0, 0 : 8x8], arg1[0, 0 : 8x8])
    acc[0, 0 : 4x8] = vpu.add(acc[1, 0 : 4x8], acc[0, 0 : 4x8])
    reduce<sum,acc> acc[0, 0 : 8x1], acc[0, 0 : 8x8]
    scan<linear> acc[0, 0 : 8x8], acc[0, 0 : 1x8], arg1[0, 0 : 8x8], acc[0, 0 : 8x8]
    acc[0, 0 : 8x8] = vpu.copy1(acc[0, 0 : 8x8])
    out[0, 0 : 8x8] = vpu.copy(acc[0, 0 : 8x8])
  }
}"""

# a stage that reads a buffer it also writes (bound to the written copy,
# which starts as NaN) and writes only half of its output
PARTIAL = """\
stagecc.kernel @partial(arg0: tensor<8x8xfloat32> @hbm, t: tensor<8x8xfloat32> @hbm, out: tensor<8x8xfloat32> @hbm) -> (out) {
  for %i in [0,2) @seq {
    t[i, 0 : 4x8] = vpu.copy(arg0[i, 0 : 4x8])
  }
  for %j in [0,1) @seq {
    out[0, 0 : 4x8] = vpu.add(t[1, 0 : 4x8], arg0[0, 0 : 4x8])
    t[0, 0 : 4x8] = vpu.neg(arg0[1, 0 : 4x8])
  }
}"""

# (kernel text, number of inputs) of the hand-written cases
TEXT_CASES = {"all_ops": (all_ops_text, 4), "alias": (lambda: ALIAS, 2),
              "partial": (lambda: PARTIAL, 1)}


# Nests the general emitter must not spread over blocks (or not cut by
# rows), each with the reason: (kernel text, number of inputs).  Their
# inputs are 16 x 8 arrays.
def _nest(name, body, scratch="", extra=""):
    return (f"stagecc.kernel @{name}(arg0: tensor<16x8xfloat32> @hbm, "
            f"arg1: tensor<8x8xfloat32> @hbm{extra}, out: tensor<16x8x"
            f"float32> @hbm) -> (out) {{\n{scratch}{body}}}")


NOT_SPREAD = {
    # a reduction into scratch that no iteration initialises: the running
    # sum crosses iterations (schedule.carry_axis_reason)
    "carried_reduce": _nest("carried_reduce", """\
  for %i in [0,2) @seq {
    reduce<sum,acc> acc[0, 0 : 8x1], arg0[i, 0 : 8x8]
    out[i, 0 : 8x8] = vpu.add(arg0[i, 0 : 8x8], acc[0, 0 : 8x1])
  }
""", "  alloc acc: tensor<8x1xfloat32> @vreg\n"),
    # a matmul accumulating across iterations (carry_axis_reason exempts
    # it; the scratch it reads was last written by the iteration before)
    "carried_matmul": _nest("carried_matmul", """\
  for %i in [0,2) @seq {
    acc[0, 0 : 8x8] += mxu.matmul(arg0[i, 0 : 8x8], arg1[0, 0 : 8x8])
    out[i, 0 : 8x8] = vpu.copy(acc[0, 0 : 8x8])
  }
""", "  alloc acc: tensor<8x8xfloat32> @vreg\n"),
    # scratch read before the iteration writes it
    "scratch_read_first": _nest("scratch_read_first", """\
  for %i in [0,2) @seq {
    out[i, 0 : 8x8] = vpu.add(arg0[i, 0 : 8x8], acc[0, 0 : 8x8])
    acc[0, 0 : 8x8] = vpu.exp(arg0[i, 0 : 8x8])
  }
""", "  alloc acc: tensor<8x8xfloat32> @vreg\n"),
    # an HBM write whose index ignores the loop variable
    "same_tile": _nest("same_tile", """\
  for %i in [0,2) @seq {
    out[0, 0 : 8x8] = vpu.exp(arg0[i, 0 : 8x8])
  }
"""),
    # a read of a tile that another iteration writes
    "other_tile": _nest("other_tile", """\
  for %i in [0,2) @seq {
    t[i, 0 : 8x8] = vpu.exp(arg0[i, 0 : 8x8])
    out[i, 0 : 8x8] = vpu.add(t[0, 0 : 8x8], arg0[i, 0 : 8x8])
  }
""", extra=", t: tensor<16x8xfloat32> @hbm"),
    # a scan along the loop
    "scan_along": _nest("scan_along", """\
  for %i in [0,2) @seq {
    scan<cumsum> out[i, 0 : 8x8], carry[0, 0 : 1x8], arg0[i, 0 : 8x8]
  }
""", "  alloc carry: tensor<1x8xfloat32> @vreg\n"),
}

# One-iteration nests of 16 rows: the first is row-local, so it is cut
# into two parts of 8 rows; the others are not (an operand broadcast
# along the rows; a scan down the rows; a matmul whose right operand the
# nest writes).
ROW_SPLIT = {
    "row_local": (_nest("row_local", """\
  for %i in [0,1) @seq {
    fill acc[0, 0 : 16x1], -1e+30
    reduce<max,acc> acc[0, 0 : 16x1], arg0[0, 0 : 16x8]
    d[0, 0 : 16x8] = vpu.sub(arg0[0, 0 : 16x8], acc[0, 0 : 16x1])
    out[0, 0 : 16x8] = mxu.matmul(d[0, 0 : 16x8], arg1[0, 0 : 8x8])
  }
""", "  alloc acc: tensor<16x1xfloat32> @vreg\n",
        ", d: tensor<16x8xfloat32> @hbm"), 2),
    "row_broadcast": (_nest("row_broadcast", """\
  for %i in [0,1) @seq {
    out[0, 0 : 16x8] = vpu.add(arg0[0, 0 : 16x8], arg1[0, 0 : 1x8])
  }
"""), 1),
    "scan_rows": (_nest("scan_rows", """\
  for %i in [0,1) @seq {
    scan<cumsum> out[0, 0 : 16x8], carry[0, 0 : 1x8], arg0[0, 0 : 16x8]
  }
""", "  alloc carry: tensor<1x8xfloat32> @vreg\n"), 1),
    "written_rhs": (_nest("written_rhs", """\
  for %i in [0,1) @seq {
    w[0, 0 : 8x8] = vpu.exp(arg0[0, 0 : 8x8])
    out[0, 0 : 16x8] = mxu.matmul(arg0[0, 0 : 16x8], w[0, 0 : 8x8])
  }
""", extra=", w: tensor<8x8xfloat32> @hbm"), 1),
}


# --------------------------------------------------------------------------
# kernels the port refused and the reference took, before the repairs
# --------------------------------------------------------------------------


def typed_chain(F, dtype, n=8):
    """An elementwise chain, both reductions and a cumsum on ``dtype``
    inputs (integer arithmetic wraps; the reductions' accumulators are
    float32 scratch), in one traced graph of frontend module ``F``."""
    def f(a, b, x):
        s = F.maximum((a + b - x) * a, b)
        r = F.reduce(s, kind="sum", axis=1)
        m = F.reduce(s, kind="max", axis=1)
        return F.cumsum(s + r, axis=0) + m
    return F.trace(f, [F.spec((n, n), dtype)] * 3, name=f"chain_{dtype}")


def gemm_graph(F, dtype, bias=True, m=32, n=48, k=16):
    """relu(A @ B + bias) on ``dtype`` operands (the product is float32),
    or A @ B alone."""
    specs = [F.spec((m, k), dtype), F.spec((k, n), dtype)]
    if not bias:
        return F.trace(lambda a, b: F.matmul(a, b), specs, name="mm")
    return F.trace(lambda a, b, c: F.relu(F.matmul(a, b) + c),
                   specs + [F.spec((n,))], name="mm_bias_relu")


def _lowered(graph, schedule=None, pipeline=None, tile=None):
    from repro_torch.core import compile_traced
    ck = compile_traced(graph, schedule=schedule or "tpu_mxu", tile=tile,
                        pipeline=pipeline, want_torch=False,
                        want_cuda=False, device="cpu")
    return ir_text.print_ir(ck.kernel)


# an integer (or f16, f32) product summed on a k grid into an output of
# another type (acc_dtype), each tile's product rounded to it
KGRID = """\
stagecc.kernel @kgrid(arg0: tensor<16x32xDT> @hbm, arg1: tensor<32x16xDT> @hbm, out: tensor<16x16xOT> @hbm) -> (out) {
  for %i in [0,2) @grid {
    for %j in [0,2) @grid {
      for %k in [0,4) @grid {
        out[i, j : 8x8] += mxu.matmul(arg0[i, k : 8x8], arg1[k, j : 8x8])
      }
    }
  }
}"""

# float -> int8 / int32 (saturating, NaN to 0), int32 -> f16 and -> int8
# (wrapping), int8 sums that wrap, an int8 division (a float32 result)
CASTS = """\
stagecc.kernel @casts(arg0: tensor<8x8xfloat32> @hbm, arg1: tensor<8x8xint32> @hbm, t8: tensor<8x8xint8> @hbm, t32: tensor<8x8xint32> @hbm, h: tensor<8x8xfloat16> @hbm, out: tensor<8x8xint8> @hbm) -> (out) {
  for %i in [0,1) @seq {
    t8[0, 0 : 8x8] = vpu.cast(arg0[0, 0 : 8x8])
    t32[0, 0 : 8x8] = vpu.cast(arg0[0, 0 : 8x8])
    h[0, 0 : 8x8] = vpu.cast(t32[0, 0 : 8x8])
    out[0, 0 : 8x8] = vpu.add(t8[0, 0 : 8x8], t8[0, 0 : 8x8])
    out[0, 4 : 8x1] = vpu.cast(arg1[0, 4 : 8x1])
    out[0, 5 : 8x1] = vpu.div(t8[0, 5 : 8x1], t8[0, 6 : 8x1])
  }
}"""

# a 256 x 256 f32 scratch (256 KB) that a scan keeps whole in one block:
# above a block's 227 KB of shared memory
BIG_SCRATCH = """\
stagecc.kernel @big(arg0: tensor<256x256xfloat32> @hbm, out: tensor<256x256xfloat32> @hbm) -> (out) {
  alloc acc: tensor<256x256xfloat32> @vmem
  alloc c: tensor<1x256xfloat32> @vreg
  for %i in [0,1) @seq {
    scan<cumsum> acc[0, 0 : 256x256], c[0, 0 : 1x256], arg0[0, 0 : 256x256]
    out[0, 0 : 256x256] = vpu.copy(acc[0, 0 : 256x256])
  }
}"""


def rank3_text(lead, kind="seq"):
    """A product with an lhs tile of leading dims ``lead`` (jnp.dot gives
    (lead, M, N)).  Under @seq: into scratch twice (the second adds),
    then copied out, which the reference's general emitter takes; under
    @grid: straight into the output, which its GEMM classifier takes."""
    f = lambda s: "x".join(map(str, s))
    t = tuple(lead) + (8, 8)
    z = ", ".join(["0"] * len(t))
    head = (f"stagecc.kernel @rank3(arg0: tensor<{f(t)}xfloat32> @hbm, "
            f"arg1: tensor<8x8xfloat32> @hbm, out: tensor<{f(t)}xfloat32> "
            f"@hbm) -> (out) {{\n")
    mm = f"mxu.matmul(arg0[{z} : {f(t)}], arg1[0, 0 : 8x8])"
    if kind == "grid":
        return (head + f"  for %i in [0,1) @grid {{\n    out[{z} : {f(t)}] "
                f"= {mm}\n  }}\n}}")
    return (head + f"  alloc s: tensor<{f(t)}xfloat32> @vreg\n"
            f"  for %i in [0,1) @seq {{\n"
            f"    s[{z} : {f(t)}] = {mm}\n"
            f"    s[{z} : {f(t)}] += {mm}\n"
            f"    out[{z} : {f(t)}] = vpu.copy(s[{z} : {f(t)}])\n  }}\n}}")


# a contraction whose grid covers 16 x 16 of 20 x 20 arrays, with an
# epilogue input EPI (type EPIT); the rest of the output is never written
EDGE = """\
stagecc.kernel @edge(arg0: tensor<20x20xfloat32> @hbm, arg1: tensor<20x20xfloat32> @hbm, arg2: EPIT @hbm, out: tensor<20x20xfloat32> @hbm) -> (out) {
  alloc acc: tensor<8x8xfloat32> @vreg
  for %i in [0,2) @grid {
    for %j in [0,2) @grid {
      zero acc[0, 0 : 8x8]
      for %k in [0,2) @seq {
        acc[0, 0 : 8x8] += mxu.matmul(arg0[i, k : 8x8], arg1[k, j : 8x8])
      }
      out[i, j : 8x8] = vpu.add(acc[0, 0 : 8x8], EPI)
    }
  }
}"""


def _edge(shape, ref):
    t = "x".join(map(str, shape))
    return EDGE.replace("EPIT", f"tensor<{t}xfloat32>").replace("EPI", ref)


def _ints(*shapes):
    return lambda rng: [rng.integers(-9, 9, s).astype(np.float32)
                        for s in shapes]


def _floats(*shapes):
    return lambda rng: [rng.standard_normal(s).astype(np.float32)
                        for s in shapes]


def _cast_inputs(rng):
    a = (rng.standard_normal((8, 8)) * 200).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = np.nan, 3e10, -3e10
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (8, 8)).astype(np.int32)
    return [a, b]


# name -> (LoopIR text, inputs from a numpy Generator): every case the
# port refused alone before (ROADMAP C's port-only refusals): element
# types f16, int32 and int8 in both emitters; scratch above 227 KB; rank-3
# matmul tiles; epilogue inputs other than (N,) or (M, N); a grid that
# covers part of the problem
REPAIRS = {
    "f16_exp": (lambda: _lowered(fe.trace(
        lambda a: fe.exp(a), [fe.spec((8, 8), "float16")], name="exp_f16"),
        pipeline="lower{tile_m=4,tile_n=4,tile_k=4}"), _floats((8, 8))),
    "f16_gemm": (lambda: _lowered(gemm_graph(fe, "float16"), tile={
        "m": 16, "n": 16, "k": 8}), _floats((32, 16), (16, 48), (48,))),
    "f16_gemm_kgrid": (lambda: _lowered(
        gemm_graph(fe, "float16"), "tpu_mxu_kgrid",
        tile={"m": 16, "n": 16, "k": 8}), _floats((32, 16), (16, 48), (48,))),
    "int8_gemm": (lambda: _lowered(gemm_graph(fe, "int8"), tile={
        "m": 16, "n": 16, "k": 8}), _ints((32, 16), (16, 48), (48,))),
    "int32_gemm_kgrid": (lambda: _lowered(
        gemm_graph(fe, "int32", bias=False), "tpu_mxu_kgrid",
        tile={"m": 16, "n": 16, "k": 8}), _ints((32, 16), (16, 48))),
    "int8_to_int32_kgrid": (lambda: KGRID.replace("DT", "int8").replace(
        "OT", "int32"), lambda rng: [rng.integers(-100, 100, s).astype(
            np.float32) for s in ((16, 32), (32, 16))]),
    "int8_to_int8_kgrid": (lambda: KGRID.replace("DT", "int8").replace(
        "OT", "int8"), lambda rng: [rng.integers(-100, 100, s).astype(
            np.float32) for s in ((16, 32), (32, 16))]),
    "f16_kgrid": (lambda: KGRID.replace("DT", "float16").replace(
        "OT", "float16"), _floats((16, 32), (32, 16))),
    "f16_chain": (lambda: _lowered(typed_chain(fe, "float16"), pipeline=
                  "lower{tile_m=4,tile_n=4,tile_k=4}"),
                  lambda rng: [x / 7 for x in _ints(*[(8, 8)] * 3)(rng)]),
    "int32_chain": (lambda: _lowered(typed_chain(fe, "int32"), pipeline=
                    "lower{tile_m=4,tile_n=4,tile_k=4}"),
                    _ints(*[(8, 8)] * 3)),
    "int8_chain": (lambda: _lowered(typed_chain(fe, "int8"), pipeline=
                   "lower{tile_m=4,tile_n=4,tile_k=4}"),
                   _ints(*[(8, 8)] * 3)),
    "casts": (lambda: CASTS, _cast_inputs),
    "big_scratch": (lambda: BIG_SCRATCH, _floats((256, 256))),
    "rank3_stage": (lambda: rank3_text((2, 3)), _floats((2, 3, 8, 8),
                                                        (8, 8))),
    "rank3_gemm": (lambda: rank3_text((1,), "grid"), _floats((1, 8, 8),
                                                            (8, 8))),
    "epilogue_rows": (lambda: _edge((16, 1), "arg2[i, 0 : 8x1]"),
                      _floats((20, 20), (20, 20), (16, 1))),
    "epilogue_one_tile": (lambda: _edge((8, 8), "arg2[0, 0 : 8x8]"),
                          _floats((20, 20), (20, 20), (8, 8))),
    "epilogue_transposed": (lambda: _edge((16, 16), "arg2[j, i : 8x8]"),
                            _floats((20, 20), (20, 20), (16, 16))),
    "edge": (lambda: _edge((20, 20), "arg2[i, j : 8x8]"),
             _floats((20, 20), (20, 20), (20, 20))),
}
