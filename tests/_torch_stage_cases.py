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
