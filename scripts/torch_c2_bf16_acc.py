#!/usr/bin/env python3
"""Hold the JAX package's bf16-accumulating GEMM to the port's gate.

``chip_smoke.py`` holds its ``bf16-acc`` product (qwen2-7b's up product,
512 x 18944 x 3584, schedule ``tpu_mxu_kgrid``, tiles 128, bf16 inputs
summed into a bf16 output per k tile) to ``backend_cuda.gemm_plain``: a
worst element within rtol 5e-2 / atol 5e-1 of it, every element inside
``backend_cuda.bracket``, and no element moved where a bf16 output can
round one way only.  This script runs the reference's emitted Pallas
kernel (``CompiledKernel.run_pallas``, interpret mode on the CPU) on CPU
draws of seeds 0..N-1 at the same shape and holds it to the same gates,
so a failure can be told apart: the reference's accumulation order, or
the port's kernel.  The draws are ``chip_smoke.gemm_args``'s, made with a
CPU ``torch.Generator``: a CUDA generator's stream cannot be reproduced
on the CPU, so these are other inputs than the card's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_c2_bf16_acc.py --seeds 5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

M, N, K = 512, 18944, 3584          # chip_smoke.MLP["up"]
RTOL, ATOL = 5e-2, 5e-1             # chip_smoke.GEMM_BF16


def graphs():
    """The bf16-accumulating product through both packages' compilers."""
    import repro.core.frontend as rfe
    import repro_torch.core.frontend as tfe
    from repro.core import compile_traced as ref_compile
    from repro_torch.core import compile_traced
    name = f"gemm_{M}x{N}x{K}_bf16acc"

    def f(a, b):
        return a._emit("matmul", [b], acc_dtype="bfloat16")
    ref = ref_compile(rfe.trace(f, [rfe.spec((M, K), "bfloat16"),
                                    rfe.spec((K, N), "bfloat16")], name=name),
                      schedule="tpu_mxu_kgrid", want_jax=False)
    port = compile_traced(tfe.trace(f, [tfe.spec((M, K), "bfloat16"),
                                        tfe.spec((K, N), "bfloat16")],
                                    name=name),
                          schedule="tpu_mxu_kgrid", device="cpu",
                          want_torch=False)
    return ref, port


def draw(seed: int):
    """chip_smoke.gemm_args's A and B of the up product, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((M, K), generator=gen)
    b = torch.randn((K, N), generator=gen)
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    import jax.numpy as jnp
    from repro_torch.core import backend_cuda
    ref, port = graphs()
    plan = port.run_cuda.plan
    print(f"tiles {plan.tiles}, ref schedule {ref.schedule}")
    failed = 0
    for seed in range(args.seeds):
        a, b = draw(seed)
        t0 = time.perf_counter()
        got = ref.run_pallas(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                             jnp.asarray(b.float().numpy(), jnp.bfloat16))
        got = torch.from_numpy(np.asarray(got, np.float32))
        secs = time.perf_counter() - t0
        want = backend_cuda.gemm_plain(plan, a, b).float()
        lo, hi = backend_cuda.bracket(plan, a, b)
        diff = (got - want).abs()
        share = (diff / (ATOL + RTOL * want.abs())).max().item()
        outside = ((got < lo) | (got > hi)).sum().item()
        exact = lo == hi
        moved = (got[exact] != want[exact]).sum().item()
        ok = share <= 1 and outside == 0 and moved == 0
        failed += not ok
        print(f"seed {seed}: reference run_pallas (interpret, {secs:.1f} s) "
              f"vs the port's gemm_plain: max_abs_err {diff.max().item():.4g}"
              f", worst element at {share!r} of rtol {RTOL:g} atol {ATOL:g};"
              f" {outside} outside the bracket; {moved} moved where the "
              f"output rounds one way; {'pass' if ok else 'FAIL'}",
              flush=True)
    print(f"{failed} of {args.seeds} seeds fail the gate")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
