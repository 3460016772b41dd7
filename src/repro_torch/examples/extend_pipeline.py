"""Extensibility demo — the paper's "reusable and extensible" claim.

Registers (1) a NEW TensorIR op, (2) a NEW scheduling pass, and (3) a
NEW canonicalization rewrite pattern from *outside* the core package,
then compiles a kernel using all three through the standard pipeline
string (ending in ``emit-cuda``: the emitted CUDA kernel on ``--device
cuda``, the default; its plain PyTorch version on ``--device cpu``).  No
core files are modified.

    python -m repro_torch.examples.extend_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (CANONICAL_PATTERNS, OP_REGISTRY,
                              PASS_REGISTRY, Pattern,
                              register_canonical_pattern, register_op,
                              register_pass, run_pipeline, spec, trace)
import repro_torch.core.frontend as fe
from repro_torch.core.loop_ir import LoopKind
from repro_torch.core.rewrite import replace_value_uses


# ---- 1. a third-party op: leaky_relu -------------------------------------

def _infer_leaky(in_types, attrs):
    return in_types[0]


# ---- 2. a third-party pass: unroll-all-innermost ---------------------------

def _unroll_all(kernel):
    for loop in kernel.loops():
        if not any(hasattr(s, "body") for s in loop.body):
            loop.kind = LoopKind.UNROLLED
    kernel.verify()
    return kernel


# ---- 3. a third-party canonicalization pattern ------------------------------
# fold the no-op neg(neg(x)) chain: the canonicalize pass picks the rule
# up at tensor level and reports its hits like any built-in pattern
# (dead-op-elim then collects the orphaned inner neg).


class FoldDoubleNeg(Pattern):
    """Fold ``neg(neg(x))`` to ``x`` (third-party demo pattern)."""

    name = "fold-double-neg"

    def match_and_rewrite(self, parent, siblings, i, root):
        op = siblings[i]
        if getattr(op, "opname", None) != "neg":
            return None
        prod = op.inputs[0].producer
        if prod is None or prod.opname != "neg":
            return None
        replace_value_uses(root, op.result, prod.inputs[0])
        return (1, [])


def register() -> None:
    """Register the three extensions (once a process): importing this
    module registers nothing."""
    if "leaky_relu" not in OP_REGISTRY:
        register_op("leaky_relu", _infer_leaky,
                    lambda a, **at: np.where(a > 0, a,
                                             at.get("alpha", 0.1) * a))
    if "unroll-innermost-all" not in PASS_REGISTRY:
        register_pass("unroll-innermost-all", "loop",
                      "flatten every innermost loop (third-party demo "
                      "pass)")(_unroll_all)
    if not any(p.name == "fold-double-neg"
               for p in CANONICAL_PATTERNS["tensor"]):
        register_canonical_pattern("tensor")(FoldDoubleNeg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    register()

    def f(a, b):
        return fe.matmul(a, b)

    g = trace(f, [spec((16, 16)), spec((16, 16))])
    res = run_pipeline(
        g, "lower{tile_m=4,tile_n=4,tile_k=4},unroll-innermost-all,"
           f"emit-cuda{{device={args.device}}}", dump=True)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16)).astype(np.float32)
    out = res.artifact(a, b)
    out = (out[0] if isinstance(out, (list, tuple)) else out).cpu().numpy()
    assert np.allclose(out, a @ b, atol=1e-4)
    print("third-party pass + op compiled and validated OK")

    # the new op works through the same tracer too
    g2 = trace(lambda x: x._emit("leaky_relu", alpha=0.05), [spec((8,))])
    (res2,) = g2.eval_np(np.asarray([-1.0, 2.0, -3.0, 4.0, 0.0, -0.5, 1.0,
                                     -2.0], np.float32))
    print("leaky_relu oracle:", res2)

    # the third-party canonicalization pattern fires through the standard
    # canonicalize pass, hit-counted like any built-in
    g3 = trace(lambda x: -(-x), [spec((4,))])
    res3 = run_pipeline(g3, "canonicalize")
    assert res3.records[0].pattern_stats.get("fold-double-neg") == 1
    assert not res3.artifact.ops, "neg(neg(x)) folds to the input"
    print("third-party canonicalization pattern fired:",
          res3.records[0].pattern_stats)
    return out


if __name__ == "__main__":
    main()
