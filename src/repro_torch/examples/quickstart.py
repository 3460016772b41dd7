"""Quickstart: the paper's Fig.-1 pipeline end to end on one GEMM.

    python -m repro_torch.examples.quickstart [--device cpu]

Traces a Python kernel (the SYCL role), lowers TensorIR -> LoopIR,
schedules it onto a block grid and emits a CUDA kernel, printing the IR
after every stage; then checks the kernel against numpy and prints the
TABLE-I-style cycle/resource reports of the paper's schedules (modelled
on the TPU v5e machine model, not times).  On ``--device cuda`` (the
default) the emitted kernel is built and launched on the GPU; on
``--device cpu`` its plain PyTorch version runs instead.
"""

from __future__ import annotations

import argparse

import numpy as np

import repro_torch.core.frontend as fe
from repro_torch.core import compile_gemm, run_pipeline, spec, trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # ---- 1. frontend: write the kernel in the host language ----
    def kernel(a, b, bias):
        return fe.relu(fe.matmul(a, b) + bias)

    graph = trace(kernel, [spec((64, 32)), spec((32, 16)), spec((16,))])
    print("== TensorIR (MLIR role) ==")
    print(graph, "\n")

    # ---- 2. run the declarative pass pipeline, dumping each stage ----
    result = run_pipeline(
        graph,
        "lower{tile_m=16,tile_n=16,tile_k=16},fuse-epilogue,grid{vars=3},"
        f"emit-cuda{{device={args.device}}}",
        dump=True)
    for stage in result.trace[1:]:
        print(stage[:800], "\n")

    # ---- 3. validate: the emitted kernel vs numpy (paper §II.B) ----
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    bias = rng.standard_normal((16,)).astype(np.float32)
    out = result.artifact(a, b, bias)
    print(f"emitted kernel ran on {out.device}")
    out = out.cpu().numpy()
    want = np.maximum(a @ b + bias, 0)
    print("cuda vs numpy max err:", np.abs(out - want).max())
    assert np.allclose(out, want, atol=1e-4)

    # ---- 4. the paper's schedule study (TABLE I / Fig. 3) ----
    print("\n== schedule study, 32x32 GEMM (modelled TPU v5e cycles) ==")
    for sched in ("nested", "inner_flattened", "tpu_mxu_kgrid"):
        ck = compile_gemm(32, 32, 32, schedule=sched,
                          want_torch=False, want_cuda=False)
        print(f"{sched:18s} {ck.cycles}  {ck.resources}")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
