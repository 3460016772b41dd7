#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. compile qwen2-7b's MLP products (repro_torch.core.compile_gemm) and
     the four serving-kernel graphs of phase 11 through the compiler stack,
     then build every CUDA kernel, one nvcc per source, all at once:
     decode_attention, flash_attention, flash_attention_sm90,
     flash_attention_ffma and ssd_scan from src/repro_torch/kernels/csrc/,
     the emitted GEMMs and the general emitter's four sources; print the
     tensor-core, register-tiled (ffma), decode attention and SSD kernels'
     registers, shared memory and spills (ptxas);
  3. decode_attention against its plain PyTorch version at the serving
     path's shapes, in float32 and bfloat16, with its launch plan (splits,
     blocks, kernels a call);
  4. serve qwen2-7b at full width (random weights from a seed) through
     repro_torch.launch.serve.main, counting the kernel's launches, then
     profile a few decode steps for the device's busy time;
  5. the full-width decode step with the kernels against the plain versions;
  6. full-width prefill + decode against one full forward (teacher forcing);
 6a. bf16 serving: qwen2-7b with RunConfig(param_dtype="bfloat16",
     cache_dtype="bfloat16"), weights from the launcher's seed, through
     Engine at B=4, 128 + 32 tokens, counting decode_attention's launches;
     tok/s, ms per step beside the bf16 weight-bytes bound, peak memory, a
     profiled step; then the decode logits with the kernels against the
     plain versions;
 6b. continuous batching: repro_torch.launch.serve --continuous (f32, 16
     requests of the load generator at rate 4, 4 slots) and the bf16 model
     through ContinuousEngine on the same stream, counting the kernel's
     launches per batched step; each with one batched step against B=1
     steps of its slots, the greedy streams against SerialSlotEngine's,
     and the metrics snapshot; the f32 batched step's time;
 6c. the repaired emitters: an f16 GEMM and a kernel whose scratch exceeds
     a block's shared memory through compile_traced, and a batched product
     with rank-3 matmul tiles through backend_cuda.emit, each launched once
     with the counts reset, held to its plain version and timed;
  7. decode_attention's time per launch beside its bound, its plain
     version's time and one PyTorch library call's time, with its launch
     plan; then, each with the counts reset, one call at a prime cache
     depth (547, block_k 1) and one on K/V that start 4 bytes past a
     16-byte boundary (the element-copy instantiation), checked and timed
     likewise;
  8. the compiled-GEMM path: the MLP products through the emitted kernels
     and a gemm_op forward and backward, counting the launches and those on
     the tensor-core route (every bf16 product) and the register-tiled
     CUDA-core route (every f32 product and gemm_op's three); then, with
     the counts reset, one f32 product on operands that start 4 bytes past
     a 16-byte boundary, which only the plain CUDA-core route (simt,
     stagecc_gemm.cuh) reads; each against its plain version and the
     bracket of its roundings, then timed like phase 7;
  9. blocked attention through repro_torch.kernels.ops.attention (backend
     "cuda": flash_attention_sm90 for bf16, flash_attention_ffma for f32) at
     qwen2-7b's widths (causal) and gemma3-4b's (causal, local window
     1024), f32 and bf16, counting the launches per kernel; then, with the
     counts reset, qwen2-7b's f32 call on inputs 4 bytes past a 16-byte
     boundary, which only flash_attention.cu (simt) reads; each against its
     plain version and SDPA, then timed;
 10. the Mamba-2 SSD scan through ops.ssd (backend "cuda", the ssd_scan
     kernels' three passes) at mamba2-130m's widths, f32 and bf16,
     likewise, and against ops.ssd's "torch" backend; each pass's device
     time from torch.profiler; then, with the count reset, one f32 call at
     chunk 256, P 128 and N 256 (past 64, 64 and 128), held to the plain
     version and timed;
 11. the compiled serving kernels: the flash graph at qwen2-7b's (causal)
     and gemma3-4b's (window 1024) widths, the decode graph at the serving
     shapes and the SSD graph at mamba2-130m's, compiled through
     repro_torch.core.compile_traced and run through run_cuda (the general
     emitter's per-nest kernels), counting the stage launches; each held to
     its plain version, a float64 oracle and the hand kernel on the same
     slice, then timed per call and per stage, beside each stage's launch
     layout (grid, spread loops, row split, blocks x threads);
 12. a JSON line with the rows of phases 6c-11 (phase 7 adds
     decode_attention's rows on the paths of 6a-6b).
The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, it exits nonzero and prints no result.

    python3 chip_smoke.py --gemm-seeds N

instead runs only the bf16 products of phase 8 on the inputs of seeds
0..N-1 (seed 0 is phase 8's draw) and prints each variant's worst share of
its gates over the seeds: how much room the gates leave.  It exits
nonzero if any gate fails, and prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
ARCH = "qwen2-7b"
BATCH, PROMPT, GEN = 4, 128, 32

# Kernel vs plain version: tests/test_kernels.py's bounds for decode
# attention (f32) and for bf16.
TOL_F32, TOL_BF16 = 2e-5, 5e-2
# The bf16 kernel keeps its statistics in f32 and rounds once, at the
# output, so against the plain version in f32 on the same bf16 inputs it
# may differ by half a bf16 ulp (at most 2^-8 of the value) plus the f32
# limit.  5e-2 is half a typical output here; this bound is ~100x tighter.
BF16_ROUND = 2.0 ** -8
# Full-width logits are O(1) (unit-rms final norm times a fan-in-scaled
# head); f32 attention sums taken in another order in each of 28 layers
# move them by ~1e-5.  1e-3 leaves room and still catches a wrong
# position, mask or group (those move logits by O(0.1)).
TOL_BACKENDS = 1e-3
TOL_TEACHER = 1e-3
TOL_LIBRARY = 1e-4   # a library's f32 attention, another sum order

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# the peak of the inputs' type: a bound holds bf16 work to the bf16 rate,
# whether the kernel runs it on the tensor cores (the bf16 GEMM and
# attention) or in f32 (the SSD scan)
PEAK = {torch.float32: F32_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S}

# qwen2-7b's MLP products for the serving phase's 4 x 128 prefill tokens:
# (M, N, K).  The tiles are the compiler's default 128, which divides all.
MLP = {"up": (BATCH * PROMPT, 18944, 3584), "down": (BATCH * PROMPT, 3584,
                                                      18944)}
# (product, schedule, input dtype, epilogue); "bf16-acc" is a matmul that
# accumulates in bf16, so its k-grid schedule rounds to bf16 per k tile
GEMMS = ([(p, s, d, "none") for p in MLP for s in ("tpu_mxu",
                                                   "tpu_mxu_kgrid")
          for d in ("float32", "bfloat16")]
         + [("up", "tpu_mxu", "float32", "bias_relu"),
            ("up", "tpu_mxu_kgrid", "bf16-acc", "none")])
GEMM_OP = (512, 1024, 768)      # gemm_op forward + backward, (M, N, K)
SIMT_GEMM = ("up", "tpu_mxu", "float32", "none")   # run again unaligned
GEMM_SOURCE = {"wgmma": "stagecc_gemm_sm90.cuh",
               "ffma": "stagecc_gemm_ffma.cuh", "simt": "stagecc_gemm.cuh"}
# Emitted GEMM vs gemm_plain: tests/test_kernels.py's bounds, f32 (rtol,
# atol) and bf16.  compile_gemm's bf16 products have an f32 output
# (TensorIR's matmul accumulates in f32), so after the bf16 inputs nothing
# rounds coarser than f32 and they are held to the f32 bound as well.
GEMM_F32, GEMM_BF16 = (1e-4, 1e-3), (5e-2, 5e-1)
# Blocked attention: batch 4 at each model's widths, K/V drawn per KV head
# and repeated to the query heads (ops.attention has no GQA).
ATTN = (("qwen2_7b", 2048), ("gemma3_4b", 4096))      # (config, Sq = Sk)
# SSD: batch 4 of 4096 steps at mamba2-130m's widths; tests/test_kernels.py
# bound (rtol, atol) in f32.  In bf16 the kernel's result must lie in
# ssd_scan.bracket: one f32 bound on y, then the plain version's roundings.
SSD_BATCH, SSD_SEQ = 4, 4096
SSD_F32 = (1e-3, 1e-4)
# ssd_scan's three kernels: (pass, kernel name in a profile)
SSD_PASSES = (("chunk states", "ssd_states_kernel"),
              ("state passing", "ssd_passing_kernel"),
              ("chunk outputs", "ssd_outputs_kernel"))
# one call at a chunk, P and N past 64, 64 and 128: (batch, S, H, P, N,
# chunk)
SSD_WIDE = (1, 1024, 2, 128, 256, 256)
# decode_attention at a prime cache depth (no tile divides it but 1)
PRIME_DEPTH, PRIME_VALID = 547, [0, 1, 273, 547]
HAND_KERNELS = ("decode_attention", "flash_attention",
                "flash_attention_sm90", "flash_attention_ffma", "ssd_scan")
# The compiled serving kernels (phase 11), one (batch, head) slice each,
# at the schedules whose every stage traces at most 4096 statements:
# (label, graph kind, dims, window / valid, pipeline).  grid{vars=N} maps
# only the first nest to the grid; the emitter spreads the later nests'
# independent loops over blocks and cuts row-local tiles by rows.
GRID2 = "lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue,grid{vars=2}"
GRID1 = "lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue,grid{vars=1}"
COMPILED = (("flash qwen2-7b causal", "flash", (2048, 2048, 128), None, GRID2),
            ("flash gemma3-4b window 1024", "flash", (4096, 4096, 256), 1024,
             GRID2),
            ("decode qwen2-7b rep 7 Smax 161 valid 129", "decode",
             (7, 161, 128), 129, GRID2),
            ("ssd mamba2-130m one head", "ssd", (4096, 64, 128), None, GRID1))
# tests/test_compiled_kernels.py's bound for a compiled graph against its
# oracle and the hand kernels; against ssd_scan, tests/test_kernels.py's
# SSD bound (a 4096-step sequential scan against the chunked kernel)
TOL_COMPILED = (1e-4, 1e-4)
NEG = -1e30
# bf16 serving (phase 6a): params and caches in bf16.  The kernels and
# the plain versions round every product and activation to bf16 at other
# places (the decode kernel once, at its output; the plain attention
# after each f32 step), a bf16 step (2^-8 relative) apart, and 28 layers
# carry it on: the cuda and torch decode logits are held to the
# reference's bf16 bound, 5e-2, taken relative to the logits' largest
# magnitude.
BF16_RUN = dict(param_dtype="bfloat16", cache_dtype="bfloat16")
TOL_BF16_LOGITS = 5e-2
# the continuous stream (phase 6b), the launcher's --continuous defaults
# at the smoke's prompt and generation lengths; the per-row lengths of the
# decode kernel's timed continuous row (four slots at different depths)
CONT_REQUESTS, CONT_RATE = 16, 4.0
CONT_VALID = [129, 98, 65, 34]
# the repaired emitters (phase 6c): a product whose 256 x 256 f32
# accumulator (256 KB) exceeds a block's 227 KB, on 256 programs, so no
# row split frees it; and a batched product with rank-3 tiles
WS_GEMM = (4096, 512, 4096)                       # (M, K, N)
WS_PIPE = "lower{tile_m=256,tile_n=256,tile_k=128},grid{vars=2}"
RANK3 = (4, 512, 512)                             # (batch, M, K = N)
RANK3_TEXT = """\
stagecc.kernel @batched(arg0: tensor<4x512x512xfloat32> @hbm, arg1: tensor<512x512xfloat32> @hbm, out: tensor<4x512x512xfloat32> @hbm) -> (out) {
  alloc s: tensor<2x64x64xfloat32> @vreg
  for %i in [0,2) @grid {
    for %j in [0,8) @grid {
      for %n in [0,8) @seq {
        s[0, 0, 0 : 2x64x64] = mxu.matmul(arg0[i, j, 0 : 2x64x512], arg1[0, n : 512x64])
        out[i, j, n : 2x64x64] = vpu.copy(s[0, 0, 0 : 2x64x64])
      }
    }
  }
}"""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


# cycles of the spin kernel before each timed call (~0.6 ms at the H100's
# clock): the host enqueues the call while the card spins, so the time
# between the events is the card's, not the host's launch latency
LEAD_CYCLES = 1_000_000


def time_ms(fn, flush: torch.Tensor, iters: int = 50, warm: int = 3) -> float:
    """Mean device time of one call with the L2 cache cold, as a decode
    step finds it (each layer's MLP weights stream through L2 between two
    attention calls).  CUDA events around each call; a 256 MiB write
    before each evicts the 50 MB L2, then a spin kernel that touches no
    memory keeps the card busy while the host enqueues the call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def attention_inputs(dtype, dev):
    """The serving path's decode shapes: B=4 rows, KV=4 groups of rep=7
    heads, hd=128, a 161-deep cache (prompt 128 + 32 generated + 1) held
    as (B, Smax, KV, hd) and read through transposed views."""
    B, KV, rep, hd, Smax = BATCH, 4, 7, 128, PROMPT + GEN + 1
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd))).to(dev, dtype)
    cache = torch.from_numpy(rng.standard_normal((2, B, Smax, KV, hd)))
    cache = cache.to(dev, dtype)
    valid = torch.tensor([0, 1, 129, 161], dtype=torch.int32, device=dev)
    return q, cache[0].transpose(1, 2), cache[1].transpose(1, 2), valid


def clone(tree):
    """A copy of a cache tree, so two runs can start from one state."""
    return {k: clone(v) if isinstance(v, dict) else
            (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def profile_decode(eng, toks, steps: int = 4):
    """Device time per decode step of ``Engine`` ``eng``, after a prefill
    of ``toks``' prompts (``profile_steps``)."""
    return profile_steps(engine_step(eng, toks), steps)


def engine_step(eng, toks):
    """A decode step of ``Engine`` ``eng`` after a prefill of ``toks``'
    prompts, as a callable (each call decodes one more position)."""
    cache = eng.model.cache_init(BATCH, PROMPT + GEN + 1)
    logits, cache = eng.prefill(eng.params, cache, toks[:, :PROMPT])
    state = {"tok": logits.argmax(-1, keepdim=True), "cache": cache}

    def step():
        logits, state["cache"] = eng.decode(eng.params, state["cache"],
                                            state["tok"])
        state["tok"] = logits.argmax(-1, keepdim=True)
    return step


def profile_steps(step, steps: int = 4):
    """Device time per call of ``step``, from torch.profiler's kernel times
    over a few calls, the wall time per call of that same window (the
    profiler slows the host, so it is longer than an unprofiled step), and
    the largest kernels (ms per step, launches per step, name).  Returns
    (busy ms per step or None where the profiler records no device time,
    window ms per step, rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / steps * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: the CPU operators that launched them
        # report the same device time again
        if e.device_type == DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return (busy if busy > 0 else None), window, rows


def roofline(nbytes, flops, peak):
    """(ms, "bytes"|"operations"): the larger of the bytes over the memory
    rate and the flops over ``peak`` flop/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_attention_bound(q, k, valid):
    """Least time for the function on these inputs: each input byte read
    once (K and V only at valid positions; an empty row reads all of V,
    whose mean it returns), the output written once; against the f32
    operations at the CUDA-core rate.  Returns (ms, "bytes"|"operations")."""
    B, KV, rep, hd = q.shape
    Smax = k.shape[2]
    el = q.element_size()
    row = KV * hd * el
    kv_bytes = sum(Smax * row if n <= 0 else 2 * min(n, Smax) * row
                   for n in valid.tolist())
    nbytes = 2 * q.numel() * el + valid.numel() * 4 + kv_bytes
    flops = sum(KV * rep * hd * (Smax if n <= 0 else 4 * min(n, Smax))
                for n in valid.tolist())
    return roofline(nbytes, flops, F32_FLOP_PER_S)


def plan_text(q, k, v) -> str:
    """decode_attention's launch plan for these inputs: the ranges per
    (b, group), the blocks and the kernels a call launches."""
    from repro_torch.kernels import decode_attention as da
    B, KV = q.shape[:2]
    splits, length = da.split_plan(k.shape[2], B * KV)
    copies = "16-byte" if da.wide(k, v) else "element"
    return (f"{splits} splits of {length} positions, {B * KV * splits} "
            f"blocks of 128 threads, {da.kernels_per_call(splits)} kernels "
            f"a call, {copies} copies")


def decode_phase(dev, flush, smi, launches, err32):
    """Phase 7: decode_attention's rows.  The serving shapes (the main
    path's ``launches``, error ``err32`` from phase 3); then, each with the
    counts reset just before and read just after its one call, a prime
    depth (Smax 547, block_k 1) and the element-copy instantiation (K and
    V one element past a 16-byte boundary): each held to the plain
    version and SDPA, then timed beside its bound."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, valid = attention_inputs(torch.float32, dev)
    rows = [decode_row("decode_attention", (q, k, v, valid), 256, launches,
                       err32, flush, smi)]

    B, KV, rep, hd = q.shape
    rng = np.random.default_rng(2)
    cache = torch.from_numpy(rng.standard_normal(
        (2, B, PRIME_DEPTH, KV, hd), dtype=np.float32)).to(dev)
    deep = (q, cache[0].transpose(1, 2), cache[1].transpose(1, 2),
            torch.tensor(PRIME_VALID, dtype=torch.int32, device=dev))
    narrow = (q, shifted(k), shifted(v), valid)
    for name, inputs, block_k, wide in (
            (f"decode_attention Smax={PRIME_DEPTH} block_k=1", deep, 1, True),
            ("decode_attention K/V 4 bytes off 16 [element copies]", narrow,
             256, False)):
        check(da.wide(*inputs[1:3]) == wide, f"{name}: copies")
        da.decode_attention.launches = da.decode_attention.narrow_launches = 0
        got = da.decode_attention(*inputs, block_k=block_k)
        torch.cuda.synchronize()
        counts = (da.decode_attention.launches,
                  da.decode_attention.narrow_launches)
        print(f"[kernel] {name}: launches {counts[0]}, element-copy launches"
              f" {counts[1]}; {plan_text(*inputs[:3])}")
        check(counts == (1, 0 if wide else 1), f"{name} launched {counts}")
        err = (got - da.decode_attention_ref(*inputs)).abs().max().item()
        check(err <= TOL_F32, f"{name}: error {err} > {TOL_F32}")
        # SDPA's fused kernels may fault on misaligned inputs: it reads the
        # aligned originals
        rows.append(decode_row(name, inputs, block_k, counts[0], err, flush,
                               smi,
                               sdpa_kv=(k, v) if not wide else None))
    return rows


def serving_decode_rows(dev, flush, smi, bf16_launches, cont_launches,
                        err_bf16):
    """decode_attention's rows on the paths of phases 6a-6b: bf16 serving
    (phase 3's bf16 inputs and error), and the continuous engine's steps,
    whose rows sit at different lengths (per-row ``valid``), in f32 and
    bf16; each with its path's launches, held to SDPA and timed."""
    from repro_torch.kernels import decode_attention as da
    rows = [decode_row("decode_attention [bf16 serving]",
                       attention_inputs(torch.bfloat16, dev), 256,
                       bf16_launches, err_bf16, flush, smi,
                       lib_tol=TOL_BF16)]
    for dtype, tol in (("float32", TOL_F32), ("bfloat16", TOL_BF16)):
        q, k, v, _ = attention_inputs(getattr(torch, dtype), dev)
        valid = torch.tensor(CONT_VALID, dtype=torch.int32, device=dev)
        got = da.decode_attention(q, k, v, valid)
        err = (got.float() - da.decode_attention_ref(q, k, v, valid).float()
               ).abs().max().item()
        print(f"[kernel] decode_attention {dtype} per-row valid "
              f"{CONT_VALID}: max_abs_err {err:.3e} (limit {tol:g})")
        check(err <= tol, f"decode_attention {dtype} per-row: {err}")
        rows.append(decode_row(f"decode_attention [continuous {dtype}]",
                               (q, k, v, valid), 256, cont_launches[dtype],
                               err, flush, smi, lib_tol=tol))
    return rows


def decode_row(name, inputs, block_k, launches, err, flush, smi,
               sdpa_kv=None, lib_tol=TOL_LIBRARY):
    """A JSON row of decode_attention on ``inputs``: held to SDPA within
    ``lib_tol``, then timed beside its bound, its plain version and
    SDPA."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, valid = inputs
    B, KV, rep, hd = q.shape
    addmask = torch.where(
        torch.arange(k.shape[2], device=q.device)[None, :] < valid[:, None],
        0.0, NEG).to(q.dtype)[:, None, None, :]
    qh = q.reshape(B, KV * rep, 1, hd)
    sk, sv = sdpa_kv or (k, v)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, sk, sv, attn_mask=addmask, enable_gqa=True)

    def kernel():
        return da.decode_attention(q, k, v, valid, block_k=block_k)

    lib_err = (library().reshape(q.shape) - kernel()).abs().max().item()
    check(lib_err <= lib_tol, f"{name}: SDPA differs by {lib_err}")
    bound, bound_by = decode_attention_bound(q, k, valid)
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:33",
           "launches": launches, "max_abs_err": err,
           "ms": time_ms(kernel, flush),
           "plain_ms": time_ms(
               lambda: da.decode_attention_ref(q, k, v, valid), flush),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": time_ms(library, flush)}
    print(f"[timing] {name} {str(q.dtype)[6:]} B={B} KV={KV} rep={rep} hd={hd} "
          f"Smax={k.shape[2]} valid={valid.tolist()}, cold L2: kernel "
          f"{row['ms'] * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
          f"({bound_by}), plain {row['plain_ms'] * 1e3:.1f} us, SDPA "
          f"{row['library_ms'] * 1e3:.1f} us (SDPA vs kernel {lib_err:.1e})"
          f"; {plan_text(q, k, v)}; card {smi}")
    return row


def flash_work(q, k, causal, window):
    """(bytes, flops) that attention needs on these inputs: q, k and v read
    once and the output written once; 4 hd flops per unmasked (query, key)
    pair (2 for q.k, 2 for p.v), and 2 hd per key for a row masked
    everywhere, which averages all of V."""
    *lead, sq, hd = q.shape
    sk = k.shape[-2]
    qpos = np.arange(sq, dtype=np.int64) + sk - sq
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    n = np.maximum(hi - lo + 1, 0)
    flops = math.prod(lead) * hd * float(np.where(n > 0, 4 * n, 2 * sk).sum())
    return (2 * q.numel() + 2 * k.numel()) * q.element_size(), flops


def ssd_work(x, B, chunk):
    """(bytes, flops) that the SSD scan needs: x, dt, B, C (and the f32 A
    and D) read once, y written once; per chunk C B^T's lower triangle once
    for all heads (it does not depend on the head), and per chunk and head
    the intra product's lower triangle, C h^T and the state update, plus
    the D skip."""
    *lead, S, H, P = x.shape
    N = B.shape[-1]
    batch, nc, tri = math.prod(lead), S // chunk, chunk * (chunk + 1) // 2
    flops = (batch * nc * (2 * tri * N + H * (2 * tri * P + 4 * chunk * N * P))
             + 2 * x.numel())
    nbytes = ((2 * x.numel() + x.numel() // P + 2 * B.numel())
              * x.element_size() + 2 * H * 4)
    return nbytes, flops


def share_of(got, want, rtol, atol):
    """Largest |got - want| / (atol + rtol |want|): <= 1 is inside."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary, as a view into a packed buffer may: the 16-byte
    copies of the ffma and wgmma kernels cannot read it, the simt
    kernels' element loads can."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def route_of(wrapper, before) -> str:
    """The route a launch took, from its wrapper's counters against their
    values (wgmma_launches, ffma_launches) before it."""
    if wrapper.wgmma_launches > before[0]:
        return "wgmma"
    return "ffma" if wrapper.ffma_launches > before[1] else "simt"


def attention_phase(dev, flush, smi):
    """Phase 9: drive ops.attention (backend "cuda") once per case with the
    launch count reset, then hold each result to the plain version and to
    SDPA, and time it.  Returns the JSON rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cases = []
    for arch, seq in ATTN:
        cfg = get_config(arch)
        hd, rep = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.num_heads, seq, hd), dtype=np.float32)).to(dev)
        kv = [torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.num_kv_heads, seq, hd), dtype=np.float32)).to(dev)
            .repeat_interleave(rep, dim=1) for _ in range(2)]
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((cfg, seq, cfg.layer_windows()[0], dtype,
                          [t.to(dtype) for t in (q, *kv)]))
        del q, kv

    # the path: one ops.attention call per case
    fa.flash_attention.launches = 0
    fa.flash_attention.wgmma_launches = fa.flash_attention.ffma_launches = 0
    outs, counts, routes = [], [], []
    for cfg, seq, window, dtype, (q, k, v) in cases:
        before = (fa.flash_attention.launches,
                  fa.flash_attention.wgmma_launches,
                  fa.flash_attention.ffma_launches)
        outs.append(ops.attention(q, k, v, causal=True, window=window,
                                  backend="cuda"))
        counts.append(fa.flash_attention.launches - before[0])
        routes.append(route_of(fa.flash_attention, before[1:]))
    torch.cuda.synchronize()
    total = fa.flash_attention.launches
    wgmma = fa.flash_attention.wgmma_launches
    ffma = fa.flash_attention.ffma_launches
    bf16 = sum(c[3] == torch.bfloat16 for c in cases)
    print(f"[attention] flash_attention launches {total} = {len(cases)} "
          f"ops.attention calls, {wgmma} of them on the tensor-core kernel "
          f"(flash_attention_sm90.cu) = the {bf16} bf16 calls, {ffma} on "
          f"the register-tiled one (flash_attention_ffma.cu) = the "
          f"{len(cases) - bf16} f32 calls")
    check(counts == [1] * len(cases) and total == len(cases),
          f"flash_attention launched {counts} per call, {total} in all")
    check(wgmma == bf16 and ffma == len(cases) - bf16 and routes == [
        "wgmma" if c[3] == torch.bfloat16 else "ffma" for c in cases],
        f"flash_attention routes {routes}")

    rows = [attention_row(c, got, count, path, flush, smi) for c, got,
            count, path in zip(cases, outs, counts, routes)]
    del outs

    # the simt path: qwen2-7b's f32 call again, on q, k and v that start 4
    # bytes past a 16-byte boundary, which only flash_attention.cu reads
    cfg, seq, window, dtype, qkv = cases[0]
    case = (cfg, seq, window, dtype, [shifted(t) for t in qkv])
    fa.flash_attention.launches = 0
    fa.flash_attention.wgmma_launches = fa.flash_attention.ffma_launches = 0
    got = ops.attention(*case[4], causal=True, window=window, backend="cuda")
    torch.cuda.synchronize()
    launched = (fa.flash_attention.launches,
                fa.flash_attention.wgmma_launches,
                fa.flash_attention.ffma_launches)
    print(f"[attention] {cfg.name} {str(dtype)[6:]} on inputs 4 bytes past "
          f"a 16-byte boundary: flash_attention launches {launched[0]}, "
          f"wgmma_launches {launched[1]}, ffma_launches {launched[2]}")
    check(launched == (1, 0, 0), f"unaligned attention launched {launched}")
    # SDPA's fused kernels fault on such inputs (misaligned address), so
    # it reads the aligned originals
    rows.append(attention_row(case, got, 1, "simt", flush, smi,
                              note=" unaligned", sdpa_qkv=qkv))
    return rows


def attention_row(case, got, count, path, flush, smi, note="",
                  sdpa_qkv=None):
    """Phase 9's JSON row of one ops.attention call ``case`` = (config,
    length, window, dtype, (q, k, v)) that ran on ``path`` with result
    ``got``: held to the plain version and SDPA, then timed.  SDPA reads
    ``sdpa_qkv`` where given: the same values, 16-byte aligned."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    cfg, seq, window, dtype, (q, k, v) = case
    B, H, _, hd = q.shape
    name = (f"flash_attention {cfg.name} B={B} H={H} S={seq} hd={hd} "
            f"causal window={window} {str(dtype)[6:]}{note} [{path}]")
    kw = dict(causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, **kw)
    check(got.shape == want.shape and got.dtype == dtype,
          f"{name}: {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    line = (f"[attention] {name}: max_abs_err {err:.3e} vs the plain "
            f"version (limit {tol:g})")
    check(err <= tol, f"{name}: error {err} > {tol}")
    if dtype == torch.bfloat16:
        want32 = fa.flash_attention_plain(q.float(), k.float(),
                                          v.float(), **kw)
        ratio = ((got.float() - want32).abs()
                 / (BF16_ROUND * want32.abs() + TOL_F32)).max().item()
        line += (f"; vs the plain version in f32 on the same inputs, "
                 f"max |err| / (2^-8 |want| + {TOL_F32:g}) = {ratio:.3f}"
                 f" (limit 1)")
        check(ratio <= 1.0, f"{name}: off its output-rounding bound")
        del want32
    del want
    mask = (None if window is None else
            ref.attention_mask(seq, seq, True, window, q.device))

    def library(qkv=sdpa_qkv or (q, k, v), mask=mask):
        return torch.nn.functional.scaled_dot_product_attention(
            *qkv, attn_mask=mask, is_causal=mask is None)

    lib_err = (library().float() - got.float()).abs().max().item()
    # the same function: a wrong mask or scale moves outputs by O(0.1)
    check(lib_err <= TOL_BF16, f"{name}: SDPA differs by {lib_err}")
    print(line + f"; SDPA{' (on aligned copies)' if sdpa_qkv else ''} vs "
          f"kernel {lib_err:.1e}")
    nbytes, flops = flash_work(q, k, True, window)
    bound, bound_by = roofline(nbytes, flops, PEAK[dtype])
    source = {"wgmma": "flash_attention_sm90.cu",
              "ffma": "flash_attention_ffma.cu",
              "simt": "flash_attention.cu"}[path]
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source}",
           "replaces": "src/repro/kernels/flash_attention.py:34",
           "launches": count, "max_abs_err": err,
           "ms": time_ms(lambda: ops.attention(
               q, k, v, backend="cuda", **kw), flush, iters=10),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, **kw), flush, iters=10),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": time_ms(library, flush, iters=10)}
    print(f"[timing] {name}, cold L2: kernel {row['ms']:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP of unmasked pairs; at the f32 "
          f"CUDA-core rate, {flops / F32_FLOP_PER_S * 1e3:.3f} ms; the "
          f"tensor-core kernel's split P makes P V twice the work), plain "
          f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.3f} ms; "
          f"card {smi}")
    return row


def ssd_phase(dev, flush, smi):
    """Phase 10: drive ops.ssd (backend "cuda") in f32 and bf16 with the
    launch count reset, then hold each result to the plain version (and
    the f32 one to ops.ssd's "torch" backend), and time it.  Returns the
    JSON rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    cfg = get_config("mamba2_130m")
    H, P = cfg.ssm.d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim
    N, chunk = cfg.ssm.state_dim, cfg.ssm.chunk
    rng = np.random.default_rng(0)       # tests/test_kernels.py:82-90's draw
    f32 = np.float32
    host = [rng.standard_normal((SSD_BATCH, SSD_SEQ, H, P), dtype=f32),
            np.abs(rng.standard_normal((SSD_BATCH, SSD_SEQ, H),
                                       dtype=f32)) * 0.1]
    A = torch.from_numpy(-np.abs(rng.standard_normal(H, dtype=f32))).to(dev)
    host += [rng.standard_normal((SSD_BATCH, SSD_SEQ, N), dtype=f32)
             for _ in range(2)]
    D = torch.from_numpy(rng.standard_normal(H, dtype=f32)).to(dev)
    cases = [(dtype, [torch.from_numpy(a).to(dev, dtype) for a in host])
             for dtype in (torch.float32, torch.bfloat16)]

    # the path: one ops.ssd call per dtype
    ss.ssd_scan.launches = 0
    outs, counts = [], []
    for dtype, (x, dt, B, C) in cases:
        before = ss.ssd_scan.launches
        outs.append(ops.ssd(x, dt, A, B, C, D, chunk=chunk, backend="cuda"))
        counts.append(ss.ssd_scan.launches - before)
    torch.cuda.synchronize()
    total = ss.ssd_scan.launches
    print(f"[ssd] ssd_scan launches {total} = {len(cases)} ops.ssd calls")
    check(counts == [1] * len(cases) and total == len(cases),
          f"ssd_scan launched {counts} per call, {total} in all")

    rows = []
    rtol, atol = SSD_F32
    for (dtype, (x, dt, B, C)), got, count in zip(cases, outs, counts):
        name = (f"ssd_scan {cfg.name} batch={SSD_BATCH} S={SSD_SEQ} H={H} "
                f"P={P} N={N} chunk={chunk} {str(dtype)[6:]}")
        args = (x, dt, A, B, C, D)
        want = ss.ssd_scan_plain(*args, chunk=chunk)
        check(got.shape == want.shape and got.dtype == dtype,
              f"{name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            share = share_of(got, want, rtol, atol)
            torch_err = share_of(got, ops.ssd(*args, chunk=chunk,
                                              backend="torch"), rtol, atol)
            print(f"[ssd] {name}: max_abs_err {err:.3e} vs the plain "
                  f"version, worst element at {share:.3g} of rtol {rtol:g} "
                  f"atol {atol:g}; vs ops.ssd backend torch (ssd_chunked) "
                  f"at {torch_err:.3g}")
            check(share <= 1 and torch_err <= 1, f"{name}: off its bound")
        else:
            lo, hi = ss.bracket(*args, chunk=chunk, rtol=rtol, atol=atol)
            outside = ((got < lo) | (got > hi)).sum().item()
            moved = (got != want).float().mean().item()
            share = share_of(got, want, TOL_BF16, TOL_BF16)
            print(f"[ssd] {name}: max_abs_err {err:.3e} vs the plain "
                  f"version (worst element at {share:.3g} of the 5e-2 "
                  f"bound), {moved:.3%} of elements differ; {outside} "
                  f"outside ssd_scan.bracket (f32 bound on y, then the "
                  f"plain version's roundings)")
            check(outside == 0 and share <= 1, f"{name}: off its bounds")
            del lo, hi
        del want
        nbytes, flops = ssd_work(x, B, chunk)
        bound, bound_by = roofline(nbytes, flops, PEAK[dtype])
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan.py:35",
               "launches": count, "max_abs_err": err,
               "ms": time_ms(lambda: ops.ssd(*args, chunk=chunk,
                                             backend="cuda"), flush,
                             iters=10),
               "plain_ms": time_ms(lambda: ss.ssd_scan_plain(
                   *args, chunk=chunk), flush, iters=10),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None}
        rows.append(row)
        print(f"[timing] {name}, cold L2: kernel {row['ms']:.3f} ms, bound "
              f"{bound:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP; at the f32 CUDA-core rate the "
              f"kernel computes in, {flops / F32_FLOP_PER_S * 1e3:.3f} ms), "
              f"plain {row['plain_ms']:.3f} ms, library: no single PyTorch "
              f"call; card {smi}")
        ssd_pass_times(name, args, chunk, flush, smi)
    del cases, outs
    rows.append(ssd_wide_row(dev, flush, smi))
    return rows


def ssd_pass_times(name, args, chunk, flush, smi, iters: int = 10):
    """Device time of each of an ssd_scan call's three kernels (chunk
    states, state passing, chunk outputs), from torch.profiler over
    ``iters`` ordinary calls, each after an L2 flush."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ssd_scan as ss
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            ss.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    ms = dict.fromkeys(kernel for _, kernel in SSD_PASSES)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        for kernel in ms:
            if kernel in e.key and e.self_device_time_total > 0:
                ms[kernel] = ((ms[kernel] or 0.0)
                              + e.self_device_time_total / 1e3 / iters)
    print(f"[timing] {name} by pass (device time per call, cold L2): "
          + ", ".join(f"{what} " + ("not measured (the profiler recorded no"
                                    " device time)" if ms[kernel] is None
                                    else f"{ms[kernel]:.3f} ms")
                      for what, kernel in SSD_PASSES) + f"; card {smi}")


def ssd_wide_row(dev, flush, smi):
    """One f32 call at chunk 256, P 128 and N 256, with the count reset
    just before and read just after, held to the plain version and
    timed."""
    from repro_torch.kernels import ssd_scan as ss
    batch, S, H, P, N, chunk = SSD_WIDE
    rng = np.random.default_rng(3)
    f32 = np.float32
    x, dt, B, C = (torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((batch, S, H, P), dtype=f32),
        np.abs(rng.standard_normal((batch, S, H), dtype=f32)) * 0.1,
        rng.standard_normal((batch, S, N), dtype=f32),
        rng.standard_normal((batch, S, N), dtype=f32)))
    A = torch.from_numpy(-np.abs(rng.standard_normal(H, dtype=f32))).to(dev)
    D = torch.from_numpy(rng.standard_normal(H, dtype=f32)).to(dev)
    args = (x, dt, A, B, C, D)
    name = (f"ssd_scan batch={batch} S={S} H={H} P={P} N={N} chunk={chunk} "
            f"float32 [wide]")
    ss.ssd_scan.launches = 0
    got = ss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    count = ss.ssd_scan.launches
    want = ss.ssd_scan_plain(*args, chunk=chunk)
    rtol, atol = SSD_F32
    share = share_of(got, want, rtol, atol)
    err = (got - want).abs().max().item()
    print(f"[ssd] {name}: launches {count}; max_abs_err {err:.3e} vs the "
          f"plain version, worst element at {share:.3g} of rtol {rtol:g} "
          f"atol {atol:g}")
    check(count == 1 and share <= 1 and bool(torch.isfinite(got).all()),
          f"{name}: {count} launches, {share} of its bound")
    nbytes, flops = ssd_work(x, B, chunk)
    bound, bound_by = roofline(nbytes, flops, PEAK[torch.float32])
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:35",
           "launches": count, "max_abs_err": err,
           "ms": time_ms(lambda: ss.ssd_scan(*args, chunk=chunk), flush,
                         iters=10),
           "plain_ms": time_ms(lambda: ss.ssd_scan_plain(*args, chunk=chunk),
                               flush, iters=3),
           "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    print(f"[timing] {name}, cold L2: kernel {row['ms']:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}), plain {row['plain_ms']:.3f} ms; "
          f"card {smi}")
    ssd_pass_times(name, args, chunk, flush, smi)
    return row


def compile_graphs(dev):
    """Phase 11's graphs through the compiler stack: (label, kind, dims,
    window / valid, compiled kernel)."""
    import repro_torch.core.frontend as fe
    from repro_torch.core import compile_traced
    build = {"flash": fe.flash_attention_graph,
             "decode": fe.decode_attention_graph, "ssd": fe.ssd_scan_graph}
    out = []
    for label, kind, dims, extra, pipe in COMPILED:
        t0 = time.perf_counter()
        ck = compile_traced(build[kind](*dims), pipeline=pipe,
                            device=str(dev), want_torch=False)
        check(ck.run_cuda is not None and ck.run_cuda.plan is None,
              f"{label}: no general CUDA emission")
        stages = ck.run_cuda.stages
        print(f"[compile] stagecc_general {label}: {ck.name}, {pipe}; "
              f"{len(stages)} stages; compiled in "
              f"{time.perf_counter() - t0:.2f}s")
        for st in stages:
            print(f"[compile]   stage {st.index}: {st.layout}")
        # the last nest (flash P V, SSD (h.C) G) is a matmul over 16 or
        # 32 row tiles, spread and split to at least 128 blocks
        check(kind == "decode" or stages[-1].programs >= 128,
              f"{label}: last stage launches {stages[-1].programs} blocks")
        out.append((label, kind, dims, extra, ck))
    return out


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


def compiled_case(kind, dims, extra, dev):
    """The graph's inputs on the card (numpy seed 0, built as
    tests/test_compiled_kernels.py's _flash_case / _ssd_case build them)
    and the port's hand kernel on the same slice, as a thunk."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.default_rng(0)
    f32 = np.float32
    if kind in ("flash", "decode"):
        sq, sk, d = dims
        q, k, v = (rng.standard_normal((1, n, d)).astype(f32)
                   for n in (sq, sk, sk))
        mask = (attn_mask(sq, sk, causal=True, window=extra)
                if kind == "flash"
                else attn_mask(sq, sk, causal=False, valid=extra))
        host = [q[0] / np.sqrt(d).astype(f32), k[0].T.copy(), v[0], mask]
        tq, tk, tv = (torch.from_numpy(a).to(dev) for a in (q, k, v))
        if kind == "flash":
            hand = lambda: flash_attention(tq, tk, tv, causal=True,
                                           window=extra)[0]
        else:       # one (batch, kv group) of the decode kernel's input
            valid = torch.tensor([extra], dtype=torch.int32, device=dev)
            hand = lambda: decode_attention(tq[None], tk[None], tv[None],
                                            valid)[0, 0]
    else:
        s, p, n = dims
        head, H = 0, 1
        x = rng.standard_normal((s, H, p)).astype(f32)
        dt = rng.uniform(0.01, 0.5, (s, H)).astype(f32)
        A = rng.uniform(-1.0, -0.1, (H,)).astype(f32)
        B = rng.standard_normal((s, n)).astype(f32)
        C = rng.standard_normal((s, n)).astype(f32)
        a = np.repeat(np.exp(dt[:, head] * A[head])[:, None], p * n, axis=1)
        u = ((dt[:, head, None] * x[:, head, :])[:, :, None]
             * B[:, None, :]).reshape(s, p * n)
        ct = np.broadcast_to(C[:, None, :], (s, p, n)).reshape(s, p * n)
        g = np.kron(np.eye(p), np.ones((n, 1))).astype(f32)
        host = [a.astype(f32), u.astype(f32), ct.astype(f32), g]
        tx, tdt, tA, tB, tC = (torch.from_numpy(t).to(dev)
                               for t in (x, dt, A, B, C))
        hand = lambda: ssd_scan(tx, tdt, tA, tB, tC, None, chunk=64)[:, head]
    return [torch.from_numpy(np.ascontiguousarray(t)).to(dev)
            for t in host], hand


def compiled_oracle(kind, xs):
    """tests/test_compiled_kernels.py's _softmax_oracle / _scan_oracle, in
    float64 on the card."""
    if kind in ("flash", "decode"):
        qs, kt, v, mask = (t.double() for t in xs)
        sc = qs @ kt + mask
        p = torch.exp(sc - sc.max(dim=1, keepdim=True).values)
        return ((p @ v) / p.sum(dim=1, keepdim=True)).float()
    a, u, ct, g = (t.double() for t in xs)
    h = torch.zeros_like(u[0])
    hs = torch.empty_like(u)
    for t in range(u.shape[0]):
        h = a[t] * h + u[t]
        hs[t] = h
    return ((hs * ct) @ g).float()


def compiled_phase(compiled, dev, flush, smi):
    """Phase 11: drive each compiled graph's run_cuda once with the stage
    launch count reset, then hold each result to its plain version, the
    float64 oracle and the hand kernel, and time it per call and per
    stage.  Returns the JSON rows."""
    from repro_torch.core import backend_cuda
    from repro_torch.kernels import gemm
    cases = [(label, kind, dims, ck) + compiled_case(kind, dims, extra, dev)
             for label, kind, dims, extra, ck in compiled]

    # the path: one run_cuda call per graph
    backend_cuda.emit_general.launches = 0
    gemm_before = gemm.cuda_gemm.launches
    outs, counts = [], []
    for label, kind, dims, ck, xs, hand in cases:
        before = backend_cuda.emit_general.launches
        outs.append(ck.run_cuda(*xs))
        counts.append(backend_cuda.emit_general.launches - before)
    torch.cuda.synchronize()
    total = backend_cuda.emit_general.launches
    want = [len(c[3].run_cuda.stages) for c in cases]
    print(f"[compiled] emit_general stage launches {counts} per run_cuda "
          f"call ({total} in all); stages per graph {want}; cuda_gemm "
          f"launches moved by {gemm.cuda_gemm.launches - gemm_before}")
    check(counts == want and total == sum(want),
          f"stage launches {counts}, expected {want}")
    check(gemm.cuda_gemm.launches == gemm_before, "cuda_gemm launched")

    rows = []
    rtol, atol = TOL_COMPILED
    for (label, kind, dims, ck, xs, hand), got, count in zip(cases, outs,
                                                             counts):
        fn = ck.run_cuda
        name = f"stagecc_general {label} {'x'.join(map(str, dims))} float32"
        plain = backend_cuda.general_plain(fn, *xs)
        torch.cuda.synchronize()
        check(got.shape == plain.shape and got.dtype == plain.dtype,
              f"{name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        err = (got - plain).abs().max().item()
        oracle = compiled_oracle(kind, xs)
        ref = hand()
        shares = {"plain": share_of(got, plain, rtol, atol),
                  "oracle": share_of(got, oracle, rtol, atol)}
        hand_tol = SSD_F32 if kind == "ssd" else TOL_COMPILED
        shares["hand"] = share_of(got, ref, *hand_tol)
        hand_name = {"flash": "flash_attention", "decode":
                     "decode_attention", "ssd": "ssd_scan(chunk=64)"}[kind]
        print(f"[compiled] {name}: max_abs_err {err:.3e} vs general_plain; "
              f"worst element at {shares['plain']:.3g} of rtol {rtol:g} atol "
              f"{atol:g} vs general_plain, {shares['oracle']:.3g} vs the "
              f"float64 oracle, {shares['hand']:.3g} of rtol {hand_tol[0]:g}"
              f" atol {hand_tol[1]:g} vs {hand_name} (max |diff| "
              f"{(got - ref).abs().max().item():.3e})")
        check(max(shares.values()) <= 1, f"{name}: off its bounds {shares}")
        del plain, oracle, ref
        library = None
        if kind != "ssd":
            qs, kt, v, mask = xs
            args4 = (qs[None, None], kt.t()[None, None], v[None, None])
            sdpa_mask = mask[None, None]

            def library(args4=args4, sdpa_mask=sdpa_mask):
                return torch.nn.functional.scaled_dot_product_attention(
                    *args4, attn_mask=sdpa_mask, scale=1.0)

            lib_share = share_of(library()[0, 0], got, rtol, atol)
            print(f"[compiled] {name}: SDPA (the same additive mask, scale "
                  f"1) vs run_cuda at {lib_share:.3g} of the bound")
            check(lib_share <= 1, f"{name}: SDPA differs")

        # the function's bound: the graph's inputs read once and its output
        # written once, against the f32 operations its stages do
        flops = sum(st.flops for st in fn.stages)
        nbytes = sum(t.numel() * 4 for t in xs) + got.numel() * 4
        bound, bound_by = roofline(nbytes, flops, F32_FLOP_PER_S)
        # per stage: its own HBM reads and writes, the materialised
        # temporaries included
        env = fn.environment(*xs)
        for st in fn.stages:
            st(env)
        stage_ms, stage_bounds = [], []
        for st in fn.stages:
            stage_ms.append(time_ms(lambda st=st: st(env), flush, iters=5))
            stage_bounds.append(roofline(st.hbm_bytes, st.flops,
                                         F32_FLOP_PER_S))
        del env
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/stagecc_stage.cuh",
               "replaces": "src/repro/core/backend_pallas.py:402",
               "launches": count, "max_abs_err": err,
               "ms": time_ms(lambda: fn(*xs), flush, iters=5),
               "plain_ms": time_ms(lambda: backend_cuda.general_plain(
                   fn, *xs), flush, iters=3, warm=1),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": (None if library is None else
                              time_ms(library, flush, iters=10))}
        rows.append(row)
        for st, ms, (b, by) in zip(fn.stages, stage_ms, stage_bounds):
            print(f"[timing] {name} stage {st.index}: {st.layout}, cold "
                  f"L2: {ms:.3f} ms, bound {b:.4f} ms ({by}: "
                  f"{st.hbm_bytes / 1e6:.1f} MB of its HBM reads and writes, "
                  f"{st.flops / 1e9:.3f} GFLOP at 67 TFLOP/s f32)")
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.3f} ms")
        print(f"[timing] {name}, cold L2: run_cuda {row['ms']:.3f} ms per "
              f"call ({count} stage launches; stages sum to "
              f"{sum(stage_ms):.3f} ms), bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB of inputs and output, "
              f"{flops / 1e9:.3f} GFLOP; the stages' own bounds sum to "
              f"{sum(b for b, _ in stage_bounds):.4f} ms with the "
              f"temporaries), general_plain {row['plain_ms']:.3f} ms, SDPA "
              f"{lib}; card {smi}")
        del got
    return rows


def compile_gemms(dev):
    """The GEMM variants through the compiler stack, each with its
    modelled cycles (priced on the TPU_V5E machine model: not a time)."""
    import repro_torch.core.frontend as fe
    from repro_torch.core import compile_gemm, compile_traced
    out = []
    for prod, sched, dtype, epi in GEMMS:
        m, n, k = MLP[prod]
        t0 = time.perf_counter()
        if dtype == "bf16-acc":
            g = fe.trace(lambda a, b: a._emit("matmul", [b],
                                              acc_dtype="bfloat16"),
                         [fe.spec((m, k), "bfloat16"),
                          fe.spec((k, n), "bfloat16")],
                         name=f"gemm_{m}x{n}x{k}_bf16acc")
            ck = compile_traced(g, schedule=sched, device=str(dev),
                                want_torch=False)
        else:
            ck = compile_gemm(m, n, k, schedule=sched, dtype=dtype,
                              epilogue=epi, device=str(dev),
                              want_torch=False)
        name = f"stagecc_gemm {prod} {sched} {dtype} {epi}"
        check(ck.run_cuda is not None, f"{name}: no CUDA emission")
        print(f"[compile] {name}: M={m} N={n} K={k}, tiles "
              f"{ck.run_cuda.plan.tiles}, {ck.cycles.total:,} cycles "
              f"modelled on TPU_V5E (a machine model, not a time), "
              f"compiled in {time.perf_counter() - t0:.2f}s")
        out.append((prod, name, ck))
    return out


def gemm_bound(plan, m, n, k):
    """Least time for the GEMM on this card: each input read once and the
    output written once over the memory rate, against 2MNK flops over the
    peak of the inputs' type (bf16 tensor cores, or f32 CUDA cores).
    Returns (ms, "bytes"|"operations")."""
    size = {"float32": 4, "bfloat16": 2}
    lhs = plan.dtypes[plan.matmul.lhs.buffer.name]
    nbytes = ((m * k + k * n) * size[lhs]
              + m * n * size[plan.dtypes[plan.out_buffer]]
              + sum(n * size[plan.dtypes[e]] for e in plan.epilogue_inputs))
    peak = BF16_FLOP_PER_S if lhs == "bfloat16" else F32_FLOP_PER_S
    return roofline(nbytes, 2 * m * n * k, peak)


def gemm_args(gemms, gen):
    """Each variant's inputs: per product, A, B and the bias drawn from
    N(0, 1) with ``gen`` and cast to each buffer's type."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    data = {prod: [torch.randn(s, generator=gen, device=gen.device)
                   for s in ((m, k), (k, n), (n,))]
            for prod, (m, n, k) in MLP.items()}
    return [[x.to(dtypes[ck.run_cuda.plan.dtypes[b]]) for b, x in
             zip(ck.run_cuda.plan.in_buffers, data[prod])]
            for prod, _, ck in gemms]


def gemm_gates(name, plan, a, got):
    """Hold one emitted GEMM's result to gemm_plain on the same inputs:
    the bound of its input type, the bracket of its roundings, the f32
    bound for bf16 inputs with an f32 output, and no moved element where
    a bf16 output can round only one way.  Returns (max_abs_err, the
    line to print, the gates as (ok, what), the worst shares by name)."""
    from repro_torch.core import backend_cuda
    want = backend_cuda.gemm_plain(plan, *a)
    lo, hi = backend_cuda.bracket(plan, *a)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype}")
    got32, want32 = got.float(), want.float()
    check(bool(torch.isfinite(got32).all()), f"{name}: non-finite")
    diff = (got32 - want32).abs()
    err = diff.max().item()
    outside = ((got32 < lo) | (got32 > hi)).sum().item()
    excess = torch.maximum(lo - got32, got32 - hi).max().item()
    bf16_in = plan.dtypes[plan.matmul.lhs.buffer.name] == "bfloat16"
    rtol, atol = GEMM_BF16 if bf16_in else GEMM_F32
    shares = {"bound": (diff / (atol + rtol * want32.abs())).max().item()}
    gates = [(shares["bound"] <= 1 and outside == 0,
              f"{name}: off its bounds")]
    line = (f"[gemm] {name}: max_abs_err {err:.3e} vs gemm_plain, worst "
            f"element at {shares['bound']:.3g} of rtol {rtol:g} atol "
            f"{atol:g}; {outside} elements outside the bracket of its "
            f"roundings (worst excess {max(excess, 0.0):.3g})")
    if plan.dtypes[plan.out_buffer] == "bfloat16":
        exact = lo == hi
        moved = (got32[exact] != want32[exact]).sum().item()
        wide = torch.maximum(hi - want32, want32 - lo)
        shares["bracket"] = torch.where(diff > 0, diff / wide,
                                        0.0).max().item()
        line += (f"; bf16 output: {1 - exact.float().mean().item():.3%} of "
                 f"elements may round either way, {moved} of the others "
                 f"differ, worst element at {shares['bracket']:.3g} of its "
                 f"bracket")
        gates.append((moved == 0, f"{name}: {moved} elements rounded "
                                  f"elsewhere"))
    elif bf16_in:
        shares["f32"] = (diff / (GEMM_F32[1] + GEMM_F32[0] * want32.abs())
                         ).max().item()
        line += (f"; f32 output, so no bf16 rounding after the inputs: worst"
                 f" element at {shares['f32']:.3g} of the f32 bound")
        gates.append((shares["f32"] <= 1, f"{name}: off the f32 bound"))
    return err, line, gates, shares


def gemm_row(g, a, got, count, path, flush, smi):
    """Phase 8's JSON row of one product ``g`` = (MLP product, name,
    compiled kernel) that ran on ``path``, on inputs ``a`` with result
    ``got``: held to its gates, then timed."""
    from repro_torch.core import backend_cuda
    prod, name, ck = g
    plan = ck.run_cuda.plan
    name = f"{name} [{path}]"
    err, line, gates, _ = gemm_gates(name, plan, a, got)
    print(line)
    for ok, what in gates:
        check(ok, what)
    bound, bound_by = gemm_bound(plan, *MLP[prod])
    r = {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/" + GEMM_SOURCE[path],
         "replaces": "src/repro/core/backend_pallas.py:229",
         "launches": count, "max_abs_err": err,
         "ms": time_ms(lambda: ck.run_cuda(*a), flush, iters=20),
         "plain_ms": time_ms(
             lambda: backend_cuda.gemm_plain(plan, *a), flush, iters=20),
         "bound_ms": bound, "bound_by": bound_by,
         "library_ms": time_ms(lambda: torch.matmul(a[0], a[1]), flush,
                               iters=20)}
    print(f"[timing] {name}, cold L2: kernel {r['ms']:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}), gemm_plain {r['plain_ms']:.3f} ms, "
          f"torch.matmul {r['library_ms']:.3f} ms; card {smi}")
    return r


def gemm_phase(gemms, dev, flush, smi):
    """Phase 8: drive the compiled-GEMM path with the launch count reset,
    then hold each result to its plain version and time it.  Returns the
    JSON rows."""
    from repro_torch.core import backend_cuda, compile_gemm, integrate
    from repro_torch.kernels import gemm
    gen = torch.Generator(device=dev).manual_seed(0)
    args = gemm_args(gemms, gen)
    m, n, k = GEMM_OP
    x, y, w = (torch.randn(s, generator=gen, device=dev)
               for s in ((m, k), (k, n), (m, n)))
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()

    # the path: every product once, then gemm_op forward and backward
    cg = gemm.cuda_gemm
    cg.launches = cg.wgmma_launches = cg.ffma_launches = 0
    outs, counts, routes = [], [], []
    for (_, _, ck), a in zip(gemms, args):
        before = (cg.launches, cg.wgmma_launches, cg.ffma_launches)
        outs.append(ck.run_cuda(*a))
        counts.append(cg.launches - before[0])
        routes.append(route_of(cg, before[1:]))
    wgmma, ffma = cg.wgmma_launches, cg.ffma_launches
    op = integrate.gemm_op(m, n, k, backend="cuda")
    (op(xg, yg) * w).sum().backward()
    torch.cuda.synchronize()
    total = cg.launches
    bf16 = [ck.run_cuda.plan.dtypes[ck.run_cuda.plan.matmul.lhs.buffer.name]
            == "bfloat16" for _, _, ck in gemms]
    f32 = len(gemms) - sum(bf16)
    print(f"[gemm] cuda_gemm launches {total} = {len(gemms)} products + "
          f"gemm_op {m}x{n}x{k} (f32) forward 1 and backward 2; "
          f"wgmma_launches {cg.wgmma_launches} = the {sum(bf16)} bf16 "
          f"products; ffma_launches {cg.ffma_launches} = the {f32} f32 "
          f"products + gemm_op's 3")
    check(counts == [1] * len(gemms) and total == len(gemms) + 3,
          f"cuda_gemm launched {counts} per product, {total} in all")
    check(routes == ["wgmma" if b else "ffma" for b in bf16]
          and wgmma == cg.wgmma_launches == sum(bf16)
          and ffma == f32 and cg.ffma_launches == f32 + 3,
          f"cuda_gemm routes {routes}, {cg.wgmma_launches} wgmma and "
          f"{cg.ffma_launches} ffma launches")

    rows = [gemm_row(g, a, got, count, path, flush, smi) for g, a, got,
            count, path in zip(gemms, args, outs, counts, routes)]
    del outs

    # the simt path: one f32 product again, on operands 4 bytes past a
    # 16-byte boundary, which only stagecc_gemm.cuh reads
    i = GEMMS.index(SIMT_GEMM)
    a = [shifted(t) for t in args[i]]
    cg.launches = cg.wgmma_launches = cg.ffma_launches = 0
    got = gemms[i][2].run_cuda(*a)
    torch.cuda.synchronize()
    launched = (cg.launches, cg.wgmma_launches, cg.ffma_launches)
    print(f"[gemm] {gemms[i][1]} on operands 4 bytes past a 16-byte "
          f"boundary: cuda_gemm launches {launched[0]}, wgmma_launches "
          f"{launched[1]}, ffma_launches {launched[2]}")
    check(launched == (1, 0, 0), f"unaligned product launched {launched}")
    rows.append(gemm_row((gemms[i][0], gemms[i][1] + " unaligned",
                          gemms[i][2]), a, got, 1, "simt", flush, smi))
    del a, got

    plan = compile_gemm(m, n, k).run_cuda.plan
    xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
    (backend_cuda.gemm_plain(plan, xp, yp) * w).sum().backward()
    for what, g, p in (("dA", xg.grad, xp.grad), ("dB", yg.grad, yp.grad)):
        e = (g - p).abs().max().item()
        ok = bool(((g - p).abs() <= GEMM_F32[1]
                   + GEMM_F32[0] * p.abs()).all())
        print(f"[gemm] gemm_op {m}x{n}x{k} {what}: kernels vs autograd "
              f"through gemm_plain, max_abs_err {e:.3e}")
        check(ok, f"gemm_op {what} off by {e}")
    return rows


def gemm_margin(gemms, dev, seeds: int) -> int:
    """The bf16 products of phase 8 on the inputs of seeds 0..seeds-1:
    each variant's gates per seed, then its worst share of each over the
    seeds.  Returns the count of failed gates."""
    from repro_torch.kernels import _build
    bf16 = [(i, name, ck) for i, (_, name, ck) in enumerate(gemms)
            if ck.run_cuda.plan.dtypes[
                ck.run_cuda.plan.matmul.lhs.buffer.name] == "bfloat16"]
    sources = sorted({ck.run_cuda.source for _, _, ck in bf16})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load_source, sources))
    worst, failed = {}, 0
    for seed in range(seeds):
        args = gemm_args(gemms, torch.Generator(device=dev).manual_seed(seed))
        for i, name, ck in bf16:
            got = ck.run_cuda(*args[i])
            _, line, gates, shares = gemm_gates(name, ck.run_cuda.plan,
                                                args[i], got)
            print(f"{line} [seed {seed}]")
            failed += sum(not ok for ok, _ in gates)
            for key, v in shares.items():
                worst[name, key] = max(worst.get((name, key), 0.0), v)
        del args
        torch.cuda.empty_cache()
    for (name, key), v in worst.items():
        print(f"[margin] {name}: worst share of the {key} gate over seeds "
              f"0..{seeds - 1}: {v!r}")
    return failed


# ---- phases 6a-6c: bf16 serving, continuous batching, the repaired emitters


def serving_profile(label, step, steps, bound_ms, step_ms):
    """Print a profiled window of ``step`` (device busy, idle share beside
    the unprofiled ``step_ms``, the weight-bytes bound, the top kernels);
    returns the busy ms per step, or None."""
    busy, window, rows = profile_steps(step, steps)
    if busy is None:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"recorded no device time)")
        return None
    print(f"[profile] {label}: device busy {busy:.2f} ms of {window:.2f} ms "
          f"wall in the profiled window (idle share {1 - busy / window:.1%})"
          f"; of {step_ms:.2f} ms unprofiled, idle share "
          f"{1 - busy / step_ms:.1%}; weight-bytes bound {bound_ms:.2f} ms; "
          f"{sum(r[1] for r in rows)} kernel launches a step")
    for ms, n, name in rows[:8]:
        print(f"[profile]   {ms:8.3f} ms/step  {n:4d} launches/step"
              f"  {name[:90]}")
    return busy


def bf16_serving_phase(cfg, dev, toks):
    """Phase 6a: qwen2-7b at full width with bf16 params and caches, drawn
    from the launcher's seed (each param drawn in f32 and cast: the cast
    of phase 4's weights), serving the launcher's prompts through
    ``Engine``: the kernel's launches, prefill and decode rates, the step
    beside its weight-bytes bound, peak memory and a profiled step; then
    the decode logits with the kernels against the plain versions.
    Returns (model, params, launches, logits error)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.engine import (Engine, EngineConfig,
                                          throughput_stats)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, RunConfig(**BF16_RUN), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, EngineConfig(max_len=PROMPT + GEN + 1))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    da.decode_attention.launches = 0
    res = throughput_stats(eng, prompts, GEN)
    launches, steps = da.decode_attention.launches, res["decode_steps"]
    print(f"[bf16] {cfg.name} params and caches bfloat16, "
          f"{model.param_count():,} params: prefill "
          f"{res['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s ({res['decode_s'] / steps * 1e3:.2f}"
          f" ms/step), decode_attention launches {launches} = "
          f"{cfg.num_layers} layers x {steps} decode steps")
    check(steps == GEN, f"bf16: {steps} decode steps, expected {GEN}")
    check(launches == cfg.num_layers * steps,
          f"bf16: decode_attention launched {launches} times, expected "
          f"{cfg.num_layers} x {steps}")
    warm = throughput_stats(eng, prompts, GEN)
    step_ms = warm["decode_s"] / GEN * 1e3
    bound = model.param_count() * 2 / HBM_BYTES_PER_S * 1e3
    print(f"[bf16] warm rerun: prefill {warm['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {warm['decode_tok_per_s']:.1f} tok/s "
          f"({step_ms:.2f} ms/step; weight-bytes bound {bound:.2f} ms), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    with torch.no_grad():
        serving_profile("bf16 decode step", engine_step(eng, toks), 4,
                        bound, step_ms)
        # decode logits, kernels vs plain versions, same params and cache
        plain = Model(cfg, RunConfig(backend="torch", **BF16_RUN), dev)
        cache = model.cache_init(BATCH, PROMPT + GEN + 1)
        model.apply(params, toks[:, :PROMPT], cache=cache)
        twin = clone(cache)
        got, _ = model.apply(params, toks[:, PROMPT:PROMPT + 1], cache=cache)
        want, _ = plain.apply(params, toks[:, PROMPT:PROMPT + 1], cache=twin)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    print(f"[bf16] full-width decode logits, cuda vs torch: max_abs_diff "
          f"{err:.3e}, logits max |x| {scale:.2f}: {err / scale:.3g} of it "
          f"(limit {TOL_BF16_LOGITS:g} of it; the reference's bf16 bound "
          f"is {TOL_BF16:g} absolute)")
    check(bool(torch.isfinite(got).all()), "non-finite bf16 decode logits")
    check(err <= TOL_BF16_LOGITS * scale, f"bf16 backends differ by {err}")
    return model, params, launches, err


def continuous_stream(cfg):
    """The launcher's --continuous stream at the smoke's widths, as
    Requests."""
    from repro_torch.serve import loadgen
    from repro_torch.serve.continuous import Request
    load = loadgen.LoadConfig(
        num_requests=CONT_REQUESTS, vocab_size=cfg.vocab_size, seed=0,
        rate=CONT_RATE, prompt=loadgen.LengthDist("uniform", 4, PROMPT),
        output=loadgen.LengthDist("uniform", 2, GEN))
    return [Request(r.rid, r.prompt, r.max_new)
            for r in loadgen.generate_stream(load)]


def snapshot_line(label, snap):
    print(f"[continuous] {label}: {snap['requests']['completed']} requests, "
          f"{snap['tokens']['decode']} tokens in {snap['duration']:.2f} s = "
          f"{snap['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{snap['ttft']['p50'] * 1e3:.1f} ms p99 "
          f"{snap['ttft']['p99'] * 1e3:.1f} ms; TPOT p50 "
          f"{snap['tpot']['p50'] * 1e3:.2f} ms p99 "
          f"{snap['tpot']['p99'] * 1e3:.2f} ms; slot utilisation "
          f"{snap['slot_utilization']:.3f}; {snap['steps']} engine steps")


def batched_vs_single(model, params, tol, label):
    """One batched decode step of the continuous engine, its four slots at
    different lengths, against B=1 decode steps of the same slots (the
    serial engine's path).  Returns (max error, the logits' max |x|)."""
    from repro_torch.serve.continuous import ContinuousEngine, Request
    eng = ContinuousEngine(model, params, slots=BATCH,
                           max_len=PROMPT + GEN + 1)
    rng = np.random.default_rng(3)
    for i, n in enumerate((PROMPT, PROMPT * 3 // 4, PROMPT // 2,
                           PROMPT // 4)):
        eng.submit(Request(i, rng.integers(0, model.cfg.vocab_size, (n,))
                           .astype(np.int32), GEN))
    eng.step()
    states = [eng.slot_state(s) for s in range(BATCH)]
    with torch.no_grad():
        batched = eng.decode_step().float()
        single = torch.cat([model.apply(params, tok, cache=one)[0][:, -1]
                            for one, tok in states]).float()
    err = (batched - single).abs().max().item()
    scale = single.abs().max().item()
    print(f"[continuous] {label}: one batched step (rows at lengths "
          f"{[one['len'] for one, _ in states]}) vs B=1 steps of the same "
          f"slots: max_abs_diff {err:.3e}, logits max |x| {scale:.2f} "
          f"(limit {tol(scale):.3g})")
    check(err <= tol(scale), f"{label}: batched vs B=1 off by {err}")
    return err, scale


def same_streams(label, got, model, params):
    """How many of ``got``'s greedy streams the serial B=1 engine
    reproduces bit for bit, on the same stream."""
    from repro_torch.serve.engine import SerialSlotEngine
    want = SerialSlotEngine(model, params, slots=BATCH,
                            max_len=PROMPT + GEN + 1).serve(
                                continuous_stream(model.cfg))
    same = sum(np.array_equal(got[r], want[r]) for r in want)
    print(f"[continuous] {label}: {same} of {len(want)} greedy streams "
          f"bit-identical to SerialSlotEngine's (B=1 steps)")
    return same


def continuous_phase(cfg, bmodel, bparams, dev):
    """Phase 6b: serve the load generator's stream through
    ``launch.serve --continuous`` (f32, the launcher's default), then the
    bf16 model of phase 6a through ContinuousEngine on the same stream;
    every request completes, decode_attention launches once a layer per
    batched step, one batched step matches B=1 steps of its slots, and the
    greedy streams are compared with the serial engine's.  Returns the
    launches of each run."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.metrics import ServeMetrics, WallClock
    da.decode_attention.launches = 0
    res = serve.main(["--arch", ARCH, "--continuous", "--slots", str(BATCH),
                      "--requests", str(CONT_REQUESTS), "--rate",
                      str(CONT_RATE), "--prompt-len", str(PROMPT), "--gen",
                      str(GEN)])
    launches = {"float32": da.decode_attention.launches}
    eng = res.pop("engine")
    snapshot_line("float32 (launch.serve --continuous)", res)
    check(res["requests"]["completed"] == CONT_REQUESTS,
          f"{res['requests']['completed']} of {CONT_REQUESTS} completed")
    print(f"[continuous] float32: decode_attention launches "
          f"{launches['float32']} = {cfg.num_layers} layers x {eng.steps} "
          f"batched steps")
    check(launches["float32"] == cfg.num_layers * eng.steps,
          f"continuous: {launches['float32']} launches, {eng.steps} steps")
    model, params = eng.model, eng.params
    results = dict(eng.results)
    del eng, res
    batched_vs_single(model, params, lambda s: TOL_BACKENDS,
                      "float32")
    same_streams("float32", results, model, params)
    step_time(model, params)
    del model, params
    torch.cuda.empty_cache()

    metrics = ServeMetrics(WallClock(), slots=BATCH)
    beng = ContinuousEngine(bmodel, bparams, slots=BATCH,
                            max_len=PROMPT + GEN + 1, metrics=metrics)
    da.decode_attention.launches = 0
    for r in continuous_stream(cfg):
        while not beng.submit(r):
            beng.step()
    beng.drain()
    launches["bfloat16"] = da.decode_attention.launches
    snap = metrics.snapshot()
    snapshot_line("bfloat16 (ContinuousEngine)", snap)
    check(snap["requests"]["completed"] == CONT_REQUESTS,
          f"bf16: {snap['requests']['completed']} of {CONT_REQUESTS}")
    check(launches["bfloat16"] == cfg.num_layers * beng.steps,
          f"bf16 continuous: {launches['bfloat16']} launches, "
          f"{beng.steps} steps")
    print(f"[continuous] bfloat16: decode_attention launches "
          f"{launches['bfloat16']} = {cfg.num_layers} layers x "
          f"{beng.steps} batched steps")
    batched_vs_single(bmodel, bparams, lambda s: TOL_BF16_LOGITS * s,
                      "bfloat16")
    same_streams("bfloat16", beng.results, bmodel, bparams)
    return launches


def step_time(model, params, steps: int = 8):
    """The continuous engine's batched step with all four slots occupied
    (per-row lengths, uploaded each step), wall ms per step over
    ``steps`` steps that end in one synchronise, beside the same rows'
    uniform-length step (Engine's path: one int length, nothing uploaded)
    in the same call; then a profiled window of the batched step."""
    from repro_torch.models.transformer import cache_leaves
    from repro_torch.serve.continuous import ContinuousEngine, Request
    eng = ContinuousEngine(model, params, slots=BATCH,
                           max_len=PROMPT + GEN + 1)
    rng = np.random.default_rng(4)
    for i in range(BATCH):
        eng.submit(Request(i, rng.integers(0, model.cfg.vocab_size,
                                           (PROMPT,)).astype(np.int32), GEN))
    eng.step()
    uniform = model.cache_init(BATCH, eng.depth)
    toks = []
    for s in range(BATCH):
        one, tok = eng.slot_state(s)
        for leaf, src in zip(cache_leaves(uniform), cache_leaves(one)):
            leaf[:, s] = src[:, 0]
        uniform["len"] = one["len"]
        toks.append(tok)
    toks = torch.cat(toks)

    def wall(step):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    with torch.no_grad():
        ms = wall(eng.decode_step)
        uni = wall(lambda: model.apply(params, toks, cache=uniform))
    print(f"[continuous] float32 batched step, 4 slots at {PROMPT + 2}-"
          f"{PROMPT + 2 + steps} cached positions: {ms:.2f} ms/step wall; "
          f"the same rows at one length through Engine's path: {uni:.2f} "
          f"ms/step")
    with torch.no_grad():
        serving_profile("float32 continuous step", eng.decode_step, 4,
                        model.param_count() * 4 / HBM_BYTES_PER_S * 1e3, ms)


def compile_repaired(dev):
    """Phase 6c's kernels, each one the port once refused: an f16 GEMM
    (qwen2-7b's up product, f32 output) and a kernel whose matmul scratch
    exceeds a block's shared memory, both through compile_traced; a
    batched product with a rank-3 matmul tile through backend_cuda.emit on
    its LoopIR (no traced graph has rank-3 tiles).  Returns (label, fn,
    inputs, bound, library) tuples."""
    import repro_torch.core.frontend as fe
    from repro_torch.core import backend_cuda, compile_traced, ir_text
    m, n, k = MLP["up"]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    ck = compile_traced(fe.trace(
        lambda a, b: fe.matmul(a, b), [fe.spec((m, k), "float16"),
                                       fe.spec((k, n), "float16")],
        name=f"gemm_{m}x{n}x{k}_f16"), device=str(dev), want_torch=False)
    check(ck.run_cuda is not None and ck.run_cuda.plan is not None,
          "f16 GEMM: no emitted GEMM")
    xs = [torch.randn(s, generator=gen, device=dev).half()
          for s in ((m, k), (k, n))]
    out.append((f"stagecc_gemm up tpu_mxu float16 none [simt]", ck.run_cuda,
                xs, roofline((m * k + k * n) * 2 + m * n * 4, 2 * m * n * k,
                             BF16_FLOP_PER_S), None))
    sm, sk, sn = WS_GEMM
    ck = compile_traced(fe.trace(
        lambda a, b: fe.exp(fe.matmul(a, b)), [fe.spec((sm, sk)),
                                               fe.spec((sk, sn))],
        name="exp_matmul_256_tiles"), pipeline=WS_PIPE, device=str(dev),
        want_torch=False)
    check(ck.run_cuda is not None and ck.run_cuda.plan is None,
          "workspace kernel: no general emission")
    check(ck.run_cuda.stages[0].ws_bytes > 0, "workspace kernel: none")
    # entries of N(0, K^-1/2), so that A @ B is about N(0, 1) and its exp
    # finite
    xs = [torch.randn(s, generator=gen, device=dev) * sk ** -0.25
          for s in ((sm, sk), (sk, sn))]
    out.append(("stagecc_general exp(A @ B) 256 x 256 tiles [workspace]",
                ck.run_cuda, xs, roofline((sm * sk + sk * sn + sm * sn) * 4,
                                          2 * sm * sn * sk, F32_FLOP_PER_S),
                None))
    b, mm, kk = RANK3
    fn = backend_cuda.emit(ir_text.parse_ir(RANK3_TEXT), device=str(dev))
    check(fn.plan is None, "rank-3 kernel: not the general path")
    xs = [torch.randn(s, generator=gen, device=dev)
          for s in ((b, mm, kk), (kk, kk))]
    out.append(("stagecc_general batched (4, 512, 512) @ (512, 512), "
                "rank-3 tiles", fn, xs,
                roofline((2 * b * mm * kk + kk * kk) * 4, 2 * b * mm * kk * kk,
                         F32_FLOP_PER_S),
                lambda xs=xs: torch.matmul(*xs)))
    for label, fn, *_ in out:
        where = ("simt" if fn.plan is not None else
                 "; ".join(f"stage {st.index}: {st.layout}"
                           + (f", workspace {st.ws_bytes} bytes x "
                              f"{st.ws_blocks} blocks" if st.ws_bytes
                              else "") for st in fn.stages))
        print(f"[compile] {label}: {where}")
    return out


def repaired_phase(repaired, flush, smi):
    """Phase 6c: launch each repaired kernel once through its callable with
    the counts reset, hold it to its plain version within 1e-4, then time
    it beside its bound.  Returns the JSON rows."""
    from repro_torch.core import backend_cuda
    from repro_torch.kernels import gemm
    rows = []
    rtol, atol = TOL_COMPILED
    for label, fn, xs, (bound, bound_by), library in repaired:
        gemm.cuda_gemm.launches = backend_cuda.emit_general.launches = 0
        got = fn(*xs)
        torch.cuda.synchronize()
        count = (gemm.cuda_gemm.launches if fn.plan is not None
                 else backend_cuda.emit_general.launches)
        want_count = 1 if fn.plan is not None else len(fn.stages)
        if fn.plan is not None:
            plain = lambda: backend_cuda.gemm_plain(fn.plan, *xs)
        else:
            plain = lambda: backend_cuda.general_plain(fn, *xs)
        want = plain()
        err = (got.double() - want.double()).abs().max().item()
        share = share_of(got.float(), want.float(), rtol, atol)
        print(f"[repaired] {label}: launches {count} (expected "
              f"{want_count}), max_abs_err {err:.3e} vs its plain version, "
              f"worst element at {share:.3g} of rtol {rtol:g} atol {atol:g}")
        check(count == want_count, f"{label}: {count} launches")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(share <= 1, f"{label}: off its bound")
        if library is not None:
            lib_share = share_of(library(), got.float(), rtol, atol)
            print(f"[repaired] {label}: torch.matmul vs the kernel at "
                  f"{lib_share:.3g} of the bound")
            check(lib_share <= 1, f"{label}: torch.matmul differs")
        row = {"name": label, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/" + (
                   "stagecc_gemm.cuh" if fn.plan is not None
                   else "stagecc_stage.cuh"),
               "replaces": "src/repro/core/backend_pallas.py:" + (
                   "229" if fn.plan is not None else "402"),
               "launches": count, "max_abs_err": err,
               "ms": time_ms(lambda: fn(*xs), flush, iters=5),
               "plain_ms": time_ms(plain, flush, iters=3, warm=1),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": (None if library is None else
                              time_ms(library, flush, iters=10))}
        lib = ("none" if library is None
               else f"{row['library_ms']:.3f} ms")
        print(f"[timing] {label}, cold L2: kernel {row['ms']:.3f} ms, bound "
              f"{bound:.4f} ms ({bound_by}), plain {row['plain_ms']:.3f} ms, "
              f"library {lib}; card {smi}")
        rows.append(row)
        del got, want
    return rows


# the kernels whose resources phase 2 prints: (mangled name, kind)
PTXAS_KERNELS = (
    (r"gemm_wgmma_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", "gemm_wgmma"),
    (r"flash_sm90_kernelILi(\d+)E", "flash_sm90"),
    (r"gemm_ffma_kernelILi(\d+)ELb(\d)E", "gemm_ffma"),
    (r"flash_ffma_kernelILi(\d+)E", "flash_ffma"),
    (r"decode_split_kernelI(f|13__nv_bfloat16)Lb([01])E", "decode_split"),
    (r"decode_combine_kernelI(f|13__nv_bfloat16)E", "decode_combine"),
    (r"ssd_states_kernelI(f|13__nv_bfloat16)E", "ssd_states"),
    (r"ssd_passing_kernelILi(\d)E", "ssd_passing"),
    (r"ssd_outputs_kernelI(f|13__nv_bfloat16)E", "ssd_outputs"))


def ptxas_rows(lib):
    """(kind, template arguments, registers, spill stores, spill loads) of
    each tensor-core, register-tiled, decode and SSD kernel in ``lib``'s
    build log (``nvcc -Xptxas -v``)."""
    import re
    from repro_torch.kernels import _build
    rows, kind = [], None
    for line in _build.ptxas_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kind = None
            for pattern, k in PTXAS_KERNELS:
                g = re.search(pattern, m.group(1))
                if g:
                    kind, targs = k, tuple(
                        int(x) if x.isdigit() else
                        ("f32" if x == "f" else "bf16") for x in g.groups())
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if kind and spill:
            stores, loads = int(spill[1]), int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if kind and regs:
            rows.append((kind, targs, int(regs[1]), stores, loads))
            kind = None
    return rows


def print_resources(sources):
    """Phase 2's [resources] lines: registers, dynamic shared memory and
    spills of the tensor-core, register-tiled, decode attention and SSD
    kernels built."""
    from repro_torch.kernels import _build
    built = [(_build.library_path(n), _build.load(n)) for n in (
        "flash_attention_sm90", "flash_attention_ffma", "decode_attention",
        "ssd_scan")]
    built += [(_build.source_library(s), _build.load_source(s))
              for s in sources if "stagecc_gemm_sm90.cuh" in s
              or "stagecc_gemm_ffma.cuh" in s]
    for path, lib in built:
        for kind, t, regs, stores, loads in ptxas_rows(path):
            if kind == "gemm_wgmma":
                name = (f"gemm_wgmma_kernel tk={t[0]} kgrid={t[1]} A "
                        f"{'MK'[t[2] == 0]}-major B {'NK'[t[3] == 0]}-major")
                smem = lib.stagecc_gemm_wgmma_smem()
                how = ("at launch, then by setmaxnreg 40 for the producer and "
                       "232 for the consumers")
            elif kind == "flash_sm90":
                name, smem = (f"flash_sm90_kernel D<={t[0]}",
                              lib.flash_attention_sm90_smem(t[0]))
                how = ("at launch, then by setmaxnreg 24 for the producer and "
                       "240 for the consumers")
            elif kind == "gemm_ffma":
                name = f"gemm_ffma_kernel 64x64 tk={t[0]} kgrid={t[1]}"
                smem, how = lib.stagecc_gemm_ffma_smem(), ""
            elif kind == "flash_ffma":
                name, smem = (f"flash_ffma_kernel D<={t[0]}",
                              lib.flash_attention_ffma_smem(t[0]))
                how = ""
            else:       # the hand kernels of decode attention and SSD
                name = f"{kind}_kernel {' '.join(map(str, t))}"
                if kind == "decode_split":
                    name += " (1: 16-byte copies)"
                smem, how = "", ""
            smem = f"{smem} bytes of" if smem != "" else "sized per call,"
            print(f"[resources] {path.name} {name}: {regs} registers a "
                  f"thread{' ' + how if how else ''}; {smem} dynamic "
                  f"shared memory; spills {stores}/{loads} bytes "
                  f"stored/loaded")


def main() -> int:
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--gemm-seeds", type=int, default=0,
                     help="run only the bf16 GEMM gates over this many "
                          "seeds")
    cli.add_argument("--timing-of", metavar="DIR", type=pathlib.Path,
                     help="run DIR/chip_smoke.py (another checkout's smoke, "
                          "on its own code) with this script's time_ms, so "
                          "that both checkouts' times share one method")
    opts = cli.parse_args()
    if opts.timing_of:
        spec = importlib.util.spec_from_file_location(
            "other_chip_smoke", opts.timing_of.resolve() / "chip_smoke.py")
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        other.time_ms = time_ms
        sys.argv = sys.argv[:1]
        return other.main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.engine import throughput_stats

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)      # the card's name and power limit, as nvidia-smi gives them
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. compile the GEMMs and the graphs; build every kernel, one nvcc per
    # source at once
    gemms = compile_gemms(dev)
    if opts.gemm_seeds:
        failed = gemm_margin(gemms, dev, opts.gemm_seeds)
        print(f"[margin] {failed} gates failed")
        return 1 if failed else 0
    compiled = compile_graphs(dev)
    repaired = compile_repaired(dev)
    sources = sorted({ck.run_cuda.source for _, _, ck in gemms})
    general = [ck.run_cuda.source for *_, ck in compiled]
    general += [fn.source for _, fn, *_ in repaired]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(sources) + len(general) + len(HAND_KERNELS)) as pool:
        jobs = [pool.submit(_build.load, name) for name in HAND_KERNELS]
        jobs += [pool.submit(_build.load_source, src)
                 for src in sources + general]
        for job in jobs:
            job.result()
    # the tensor-core and ffma kernels' resources, from the build's ptxas
    # output
    print_resources(sources)
    print(f"[build] {', '.join(HAND_KERNELS)}, {len(sources)} emitted "
          f"GEMM sources and {len(general)} more emitted sources (the "
          f"general emitter's, and the repaired kernels' of phase 6c), one "
          f"nvcc each, in parallel: {time.perf_counter() - t0:.1f}s")

    # 3. kernel vs plain version at the serving path's shapes
    errs = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        q, k, v, valid = attention_inputs(dtype, dev)
        got = da.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, valid)
        err = (got.float() - want.float()).abs().max().item()
        errs[dtype] = err
        print(f"[kernel] decode_attention {str(dtype)[6:]} "
              f"B=4 KV=4 rep=7 hd=128 Smax=161 valid=[0,1,129,161]: "
              f"max_abs_err {err:.3e} (limit {tol:g}); {plan_text(q, k, v)}")
        check(err <= tol, f"decode_attention {dtype} error {err} > {tol}")
        if dtype == torch.bfloat16:
            want32 = da.decode_attention_ref(q.float(), k.float(), v.float(),
                                             valid)
            diff = (got.float() - want32).abs()
            ratio = (diff / (BF16_ROUND * want32.abs() + TOL_F32)).max().item()
            print(f"[kernel] decode_attention bfloat16 vs the plain version "
                  f"in f32 on the same inputs: max_abs_err "
                  f"{diff.max().item():.3e}, max |err| / (2^-8 |want| + "
                  f"{TOL_F32:g}) = {ratio:.3f} (limit 1)")
            check(ratio <= 1.0, f"bf16 decode_attention off by {ratio} x "
                  "its output-rounding bound")

    # 4. serve at full width through the user's entry point
    da.decode_attention.launches = 0
    res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--gen", str(GEN)])
    launches = da.decode_attention.launches
    eng = res["engine"]
    model, params, cfg = eng.model, eng.params, eng.model.cfg
    steps = res["decode_steps"]
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab_size}, "
          f"{model.param_count():,} params")
    print(f"[serve] prefill {res['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s "
          f"({res['decode_s'] / max(steps, 1) * 1e3:.2f} ms/step), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"[serve] decode_attention launches {launches} = "
          f"{cfg.num_layers} layers x {steps} decode steps")
    check(steps == GEN, f"{steps} decode steps, expected {GEN}")
    check(launches == cfg.num_layers * steps,
          f"decode_attention launched {launches} times, expected "
          f"{cfg.num_layers} x {steps}")
    warm = throughput_stats(eng, np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32), GEN)
    print(f"[serve] warm rerun: prefill {warm['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {warm['decode_tok_per_s']:.1f} tok/s "
          f"({warm['decode_s'] / GEN * 1e3:.2f} ms/step)")

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        BATCH, PROMPT + 4)).astype(np.int64)).to(dev)
    plain = Model(cfg, RunConfig(backend="torch"), dev)
    with torch.no_grad():
        busy, window, rows = profile_decode(eng, toks)
        step_ms = warm["decode_s"] / GEN * 1e3
        if busy is None:
            print("[profile] decode step device time: not measured (the "
                  "profiler recorded no device time)")
        else:
            print(f"[profile] decode step: device busy {busy:.2f} ms of "
                  f"{window:.2f} ms wall in the same profiled window (idle "
                  f"share {1 - busy / window:.1%}); of {step_ms:.2f} ms in "
                  f"the unprofiled warm rerun, idle share "
                  f"{1 - busy / step_ms:.1%}; weight-bytes bound "
                  f"{model.param_count() * 4 / HBM_BYTES_PER_S * 1e3:.2f} ms"
                  f"; {sum(r[1] for r in rows)} kernel launches a step")
            for ms, n, name in rows[:8]:
                print(f"[profile]   {ms:8.3f} ms/step  {n:4d} launches/step"
                      f"  {name[:90]}")
            ours = [(ms, n, name) for ms, n, name in rows
                    if "decode_split_kernel" in name
                    or "decode_combine_kernel" in name]
            print(f"[profile] decode_attention: "
                  f"{sum(r[0] for r in ours):.3f} ms/step over "
                  f"{sum(r[1] for r in ours)} kernel launches/step (" +
                  ", ".join(f"{name[name.index('decode_'):].split('(')[0]}"
                            f" {ms:.3f} ms" for ms, _, name in ours) + ")")

        # 5. decode logits, kernels vs plain versions, same params and cache
        cache = model.cache_init(BATCH, PROMPT + GEN + 1)
        model.apply(params, toks[:, :PROMPT], cache=cache)
        twin = clone(cache)
        got, _ = model.apply(params, toks[:, PROMPT:PROMPT + 1], cache=cache)
        want, _ = plain.apply(params, toks[:, PROMPT:PROMPT + 1], cache=twin)
        err = (got - want).abs().max().item()
        print(f"[backends] full-width decode logits, cuda vs torch: "
              f"max_abs_diff {err:.3e} (limit {TOL_BACKENDS:g}; logits "
              f"max |x| {want.abs().max().item():.2f})")
        check(bool(torch.isfinite(got).all()), "non-finite decode logits")
        check(err <= TOL_BACKENDS, f"backends differ by {err}")

        # 6. prefill + decode against one full forward
        full, _ = model.apply(params, toks)
        cache = model.cache_init(BATCH, PROMPT + GEN + 1)
        pre, _ = model.apply(params, toks[:, :PROMPT], cache=cache)
        errs_tf = [(pre - full[:, :PROMPT]).abs().max().item()]
        for t in range(PROMPT, PROMPT + 4):
            lg, _ = model.apply(params, toks[:, t:t + 1], cache=cache)
            errs_tf.append((lg[:, 0] - full[:, t]).abs().max().item())
        check(tuple(full.shape) == (BATCH, PROMPT + 4, cfg.padded_vocab),
              f"logits shape {tuple(full.shape)}")
        check(bool(torch.isfinite(full).all()), "non-finite logits")
        print(f"[teacher] full-width prefill {PROMPT} + 4 decode steps vs "
              f"full forward: max_abs_diff {max(errs_tf):.3e} "
              f"(limit {TOL_TEACHER:g})")
        check(max(errs_tf) <= TOL_TEACHER, f"decode drift {errs_tf}")
    del cache, twin, full, pre, eng, res, params
    torch.cuda.empty_cache()

    # 6a. bf16 serving; 6b. continuous batching, f32 through the launcher
    # and the bf16 model on the same stream
    bmodel, bparams, bf16_launches, _ = bf16_serving_phase(cfg, dev, toks)
    cont_launches = continuous_phase(cfg, bmodel, bparams, dev)
    del bmodel, bparams
    torch.cuda.empty_cache()

    # 6c. the repaired emitters
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    rows = repaired_phase(repaired, flush, smi)
    del repaired
    torch.cuda.empty_cache()

    # 7. time per launch beside the bound, the plain version and SDPA
    rows += decode_phase(dev, flush, smi, launches, errs[torch.float32])
    rows += serving_decode_rows(dev, flush, smi, bf16_launches,
                                cont_launches, errs[torch.bfloat16])
    torch.cuda.empty_cache()

    # 8. the compiled-GEMM path
    rows += gemm_phase(gemms, dev, flush, smi)

    # 9. blocked attention; 10. the SSD scan
    rows += attention_phase(dev, flush, smi)
    torch.cuda.empty_cache()
    rows += ssd_phase(dev, flush, smi)
    torch.cuda.empty_cache()

    # 11. the compiled serving kernels through the general emitter
    rows += compiled_phase(compiled, dev, flush, smi)

    # 12. every kernel's row
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
