#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. compile qwen2-7b's MLP products (repro_torch.core.compile_gemm),
     the four serving-kernel graphs of phase 11 and phase 15's raised
     blocks through the compiler stack,
     then build every CUDA kernel, one nvcc per source, all at once:
     decode_attention, flash_attention, flash_attention_sm90,
     flash_attention_ffma and ssd_scan from src/repro_torch/kernels/csrc/,
     the emitted GEMMs (phase 8's and phase 8b's searched ones) and the
     general emitter's sources; print the
     tensor-core, register-tiled (ffma), decode attention and SSD kernels'
     registers, shared memory and spills (ptxas);
  3. decode_attention against its plain PyTorch version at the serving
     path's shapes, in float32 and bfloat16, with its launch plan (splits,
     blocks, kernels a call);
  4. serve qwen2-7b at full width (random weights from a seed) through
     repro_torch.launch.serve.main, whose Engine replays each decode step
     as a CUDA graph, counting the kernel's launches (a replay adds the
     launches its capture recorded); an eager Engine's warm decode time
     and greedy streams beside it; profile a few eager decode steps for
     the device's busy time; then the captured step against the eager one
     from one state: logits, wall ms, device busy ms and idle share, host
     launch calls a step;
  5. the full-width decode step with the kernels against the plain versions;
  6. full-width prefill + decode against one full forward (teacher forcing);
 6a. bf16 serving: qwen2-7b with RunConfig(param_dtype="bfloat16",
     cache_dtype="bfloat16"), weights from the launcher's seed, through
     Engine at B=4, 128 + 32 tokens, counting decode_attention's launches;
     tok/s, ms per step beside the bf16 weight-bytes bound, peak memory;
     the eager Engine and the captured step against the eager one as in
     phase 4, a profiled eager step; then the decode logits with the
     kernels against the plain versions;
 6b. continuous batching: repro_torch.launch.serve --continuous (f32, 16
     requests of the load generator at rate 4, 4 slots) and the bf16 model
     through ContinuousEngine on the same stream, both on captured batched
     steps, counting the kernel's launches per batched step; each again
     with eager steps (its snapshot), its greedy streams against the
     captured ones and SerialSlotEngine's (captured and eager), one
     batched step against B=1 steps of its slots, and the captured batched
     step against the eager one as in phase 4;
 6c. the repaired emitters: an f16 GEMM and a kernel whose scratch exceeds
     a block's shared memory through compile_traced, and a batched product
     with rank-3 matmul tiles through backend_cuda.emit, each launched once
     with the counts reset, held to its plain version and timed (the f16
     GEMM beside torch.mm(..., out_dtype=torch.float32), the one call
     that computes the same function);
 6d. the recurrent and MoE families at their published widths, weights
     from the launcher's seed: mamba2-130m and recurrentgemma-2b whole (f32
     and bf16), deepseek-v2-236b (f32 and bf16) and kimi-k2-1t (bf16) cut
     to two layers (the dense prefix and one MoE layer with all its
     experts), each through Engine at B=4, 128 + 32 tokens on captured
     decode steps: decode_attention's launches (2 a step for kimi-k2, 0
     for the others), tok/s, ms per step beside the weight-bytes bound,
     peak memory; the eager Engine's streams; the captured step against
     the eager one (bit-equal logits, idle share); a profiled eager step;
     prefill + decode against one full forward; kimi-k2's decode logits
     with the kernel against the plain versions; mamba2-130m and
     recurrentgemma-2b (f32) through ContinuousEngine on the launcher's
     stream, whose greedy streams must be SerialSlotEngine's and the
     eager engine's; then decode_attention at kimi-k2's decode shapes;
 6e. the stub-frontend models whole, f32 and bf16, weights from the
     launcher's seed: whisper-base (a 6-layer encoder over 1,500 stub
     frames, 6 decoder layers with cross attention) and pixtral-12b (1,024
     stub patches in place of the first token embeddings), f32 through
     repro_torch.launch.serve.main, each through Engine with the
     launcher's stub embeddings at B=4, 128 + 32 tokens on captured
     decode steps: decode_attention's launches (one a decoder layer a
     step), tok/s, ms per step beside the bytes bound (whisper's adds the
     cross K/V a step reads), idle share, peak memory; the eager Engine's
     streams; the captured step against the eager one; prefill + decode
     against one full forward; the decode logits with the kernel against
     the plain versions; a B=1 prefill of 1,152 tokens for pixtral (all
     1,024 patches) against its full forward; then decode_attention at
     both models' decode shapes, f32 and bf16, held to the plain version
     and timed;
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
     bracket of its roundings, then timed like phase 7 (a bf16 product,
     whose output is f32, beside torch.mm(..., out_dtype=torch.float32)
     and torch.matmul);
  8b. ops.matmul(backend="cuda_auto") on the MLP products, f32 and bf16,
     at the schedule and tiles the cost-model search picks (tpu_mxu, 256 x
     256 x K), with the counts reset: its route, held to phase 8's gates
     and timed likewise;
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
 11b. python -m repro_torch.core.reproc in three subprocesses (the whole
     stack to Verilog, a host-coupled transaction, a small design-space
     exploration), each of which must exit 0 without importing jax;
 12. a JSON line with the rows of phases 6c-11 and 14b (phase 7 adds
     decode_attention's rows on the paths of 6a-6b, phase 6d its row on
     kimi-k2's path, phase 6e its rows on whisper-base's and
     pixtral-12b's paths);
 13. training: minicpm-2b whole, f32, through repro_torch.launch.train
     (8 steps of 8 x 256 tokens, WSD, AdamW, remat full): finite losses,
     the last below the first, step ms, tokens/s, peak memory, model
     FLOPs a step against the f32 peak, one more step profiled; then at
     full width cut to two layers: microbatches 2 against the full batch
     and remat full / dots against none (loss and every gradient leaf),
     save + restore into a fresh state + 2 steps against 4 straight
     steps (bit-equal losses), and the first three losses of a batch of
     2 x 64 against the same steps on the CPU.  The training forward
     reaches no kernel (the reference's is jnp code): it runs plain
     PyTorch attention;
 14. the distribution layer [dist], on a 1-rank NCCL (1, 1) mesh:
     (a) minicpm-2b whole through repro_torch.launch.train --mesh host
     with phase 13's settings on DTensor params, moments and batches: the
     losses against phase 13's (relative 1e-6), ms a step, tokens/s, the
     model-FLOP share, peak memory, a profiled step's idle share; (b)
     sharded_gemm_op at qwen2-7b's up product, f32 and bf16: 3 launches of
     the emitted GEMM a forward and backward, bit-equal to gemm_op's, then
     timed; (c) deepseek-v2-236b cut to two layers, a prefill with
     set_moe_impl("shardmap") against "gspmd", f32 and bf16, held to phase
     6d's gates; (d) the int8 error-feedback and compressed all-reduce over
     a minicpm-2b-shaped gradient tree, bit-equal to the same functions on
     the CPU; (e) FailoverRunner at two layers with injected failures,
     bit-equal to an uninterrupted run; then (f) launch.dryrun on a fake
     process group (host only): qwen2-7b train_4k on 16 x 16, kimi-k2-1t's
     state bytes a device on both production meshes; (g) host only, on
     this machine's torch: 4 gloo CPU ranks (this script again, a
     FileStore, no card visible) train reduced qwen2-7b and
     deepseek-v2-236b (its MoE expert-parallel) for 3 SGD steps on a
     (2, 2) mesh, run sharded_gemm_op on it and launch.train --mesh host
     on (4, 1), each against the same run without a mesh in this process
     (losses 1e-6 relative; params, outputs and gradients 1e-6 of their
     largest magnitude); (h), before the NCCL group ends: qwen1.5-32b at
     full width cut to two layers, f32, params and caches on the (1, 1)
     mesh, through ContinuousEngine on phase 6b's stream with captured
     batched steps: its streams those of the same engine without a mesh,
     decode_attention launched a layer a batched step by the replays,
     the captured step bit-equal to the eager one on the mesh (timed, and
     decode_attention's row at that shape);
 15. the raising entry point [raise]: (a) every block of qwen2_7b,
     mamba2_130m and recurrentgemma_2b raised from traced PyTorch
     (repro_torch.core.raise), their raisability against
     docs/RAISING.md's rows, serve.compiled.plan_blocks(device="cuda")
     against the reference's plan rows (block, status, schedule, modelled
     cycles, CUDA emission), and each compiled block's run_cuda (the
     general emitter's stage kernels) against run_ref and its plain
     version; (b) qwen2-7b's MLP block (layers.apply_mlp, f32, full-width
     params) over 4 x 128 tokens raised with raise_fx, compiled in the
     plan's schedule order and run through run_cuda, against apply_mlp on
     the card and run_ref, timed beside its bound and apply_mlp's own
     time; both drive the stage kernels with the count reset; (c) phase
     6b's bf16 ContinuousEngine carries the qwen2_7b plan (plan=), which
     changes none of its streams.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, it exits nonzero and prints no result.

    python3 chip_smoke.py --gemm-seeds N

instead runs only the bf16 products of phase 8 on the inputs of seeds
0..N-1 (seed 0 is phase 8's draw) and prints each variant's worst share of
its gates over the seeds: how much room the gates leave.  It exits
nonzero if any gate fails, and prints no result line.

    python3 chip_smoke.py --launcher-cards 4

instead needs four cards.  First it runs the launcher's reduced
comparison there: torchrun of launch.train --arch qwen2-7b --reduced
--mesh host on four NCCL ranks, as phase 14g runs it and with --remat
full, every step's loss held to the same command on one card without a
mesh (1e-6 relative).  Then it trains qwen2-7b whole (28 layers, f32
AdamW, remat full, 8 steps of 8 x 256 tokens; its state fits no one
card) through the launcher's own command, torchrun --nproc-per-node 4 -m
repro_torch.launch.train --mesh host, on a (4, 1) NCCL mesh, each rank
this script again (--cards-rank), which calls launch.train.main and
prints its losses, ms a step, tokens/s, model-FLOP share, peak GiB and
the gradients autograd returns Partial; the first loss is held to one
card's forward of the same seed's params (1e-5 relative), every rank's
losses to rank 0's, the last below the first.  Then each rank runs
sharded_gemm_op at 2048 x 18944 x 3584 (512 rows a card, phase 8's up
product) in f32 and bf16 through the emitted GEMM, held to gemm_op on
its own rows bit for bit and its rhs gradient's all-reduce to the four
one-card gradients' sum, and timed beside its bound, gemm_op, the
library call and the all-reduce.  Then the same launcher command with
--checkpoint-dir (each rank writing only its own pieces of the state)
is preempted: SIGTERM to one rank after step 4, every rank stopping
after the same step and saving once; run again, it resumes and trains
to step 8, its losses with the first run's held to the straight run's
(bit-equal, or within 1e-5 where the first half already differs from
run to run).  The checkpoints go to a directory of their own under the
temporary directory (TMPDIR), removed when the part ends; it fails,
with the numbers, where that file system cannot hold two checkpoints of
the whole model (91.4 GB each): point TMPDIR at a memory-backed
directory of the caller's own where the disk is too small.  Each rank
prints its seconds, bytes and host memory growth to save and to
restore, the file system's free space and write rate, and its card's
name and power limit.  The deepseek-v2 parts follow
([moe] lines).  Then serving on four cards ([serve] lines): qwen1.5-32b's
memory reckoned from meta shapes first (the whole model's f32 params,
140.8 GB, fit no card; Model.init(mesh=)'s peak a card, which fails the
part with its numbers where it does not fit), then one torchrun of four
NCCL ranks on a (1, 4) mesh (launch.mesh.make_host_mesh), each this
script again (--serve-rank): (a) two layers at full width, f32: Engine
(4 prompts of 128 tokens, 32 greedy) captured and eager on the mesh
against one card without a mesh (sampled logits 1e-5 of their largest
magnitude, the same tokens, captured bit-equal to eager); (b) the whole
model, f32, params drawn on the mesh: Engine, the captured decode step
against the eager one (bit-equal; ms a step beside the weight-bytes
bound, idle share, host launch calls, the collectives a step by kind),
decode_attention at a card's shape, ContinuousEngine on phase 6b's
stream under a wall clock (TTFT, TPOT, tokens/s); every rank's tokens
and streams equal, 64 decode_attention launches a step; then the whole
model in bf16 on one card, teacher-forced on the mesh's tokens, against
the logits the mesh sampled from (phase 6a's gate).  It prints no result
line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import math
import os
import pathlib
import re
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
# the CUDA runtime and driver calls by which the host puts work on the
# card: what a captured decode step cuts from ~2,000 to a few
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
              "cudaMemsetAsync")

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
# ops.matmul(backend="cuda_auto") on these products (phase 8b), at the
# schedule and tiles the cost-model search picks for them
AUTO_PRODUCTS = ("up", "down")
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
# the recurrent and MoE families (phase 6d) at their published widths:
# (arch, depth or None for all layers, dtypes, decode_attention launches
# a decode step).  deepseek-v2 and kimi-k2 do not fit the card at any
# precision: two layers, the dense prefix and one MoE layer with all its
# experts.  Only kimi-k2's attention (global GQA) reaches the kernel;
# recurrentgemma's is windowed (2048), deepseek's latent (MLA), mamba2 has
# none.  kimi-k2 needs ~40 GB in bf16 and ~80 in f32: bf16 only.
FAMILY_RUNS = (("mamba2-130m", None, ("float32", "bfloat16"), 0),
               ("recurrentgemma-2b", None, ("float32", "bfloat16"), 0),
               ("deepseek-v2-236b", 2, ("float32", "bfloat16"), 0),
               ("kimi-k2-1t", 2, ("bfloat16",), 2))
# run through ContinuousEngine on the launcher's stream (f32), whose
# greedy streams must be SerialSlotEngine's and the eager engine's
FAMILY_CONTINUOUS = ("mamba2-130m", "recurrentgemma-2b")
# decode_attention's per-row valid lengths at kimi-k2's decode shapes
KIMI_VALID = [129, 145, 152, 161]
# the stub-frontend models (phase 6e), whole, f32 and bf16, and their
# decode_attention shapes (KV groups, heads a group, head dim): whisper's
# decoder attends KV 8 = H 8 heads of 64, pixtral's 8 groups of 4 heads
# of 128; pixtral also prefills PIXTRAL_LONG tokens at B=1, so all 1,024
# stub patches land (the serving prompts hold 128)
FRONTEND_RUNS = ("whisper-base", "pixtral-12b")
FRONTEND_DECODE = {"whisper-base": (8, 1, 64), "pixtral-12b": (8, 4, 128)}
PIXTRAL_LONG = 1152
# training (phase 13): minicpm-2b whole, f32, through the launcher; then
# at full width cut to TRAIN_CUT layers, the equality checks and a
# TRAIN_SMALL (batch, seq) run on the card against the CPU
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "minicpm-2b", 8, 8, 256
TRAIN_CUT, TRAIN_SMALL = 2, (2, 64)
# the distribution layer (phase 14) on the 1-rank (1, 1) NCCL mesh:
# sharded_gemm_op at qwen2-7b's up product; the MoE at the capacity factor
# of tests/test_perf_paths.py's shardmap test, at which neither path drops
# a token; failures injected at the first attempt of these steps
DIST_GEMM = (BATCH * PROMPT, 18944, 3584)
DIST_MOE_CF = 8.0
DIST_FAIL, DIST_FAIL_EVERY, DIST_FAIL_STEPS = (3, 5), 2, 6
# phase 14g, host only: DIST_RANKS gloo CPU ranks on this machine's torch,
# DIST_RANK_STEPS SGD steps of each reduced config on a (2, 2) mesh (the
# MoE's at the capacity factor above, 8 experts), the launcher's host
# mesh (DIST_RANKS ranks under torchrun), and sharded_gemm_op at
# (m, n, k), each against the same run without a mesh in this process:
# losses within DIST_RANK_TOL relative, params, outputs and gradients
# within it of each tensor's largest magnitude
DIST_RANKS, DIST_RANK_MESH = 4, (2, 2)
DIST_RANK_ARCHS = ("qwen2-7b", "deepseek-v2-236b")
DIST_RANK_STEPS, DIST_RANK_LR, DIST_RANK_TOL = 3, 0.3, 1e-6
DIST_RANK_GEMM = (64, 96, 128)
DIST_RANK_LAUNCH = ["--arch", "qwen2-7b", "--reduced", "--steps", "3",
                    "--seq-len", "16", "--global-batch", "4"]
DIST_RANK_TIMEOUT = 300
# --launcher-cards N: qwen2-7b whole (7.616 G params; its f32 AdamW state,
# 121.8 GB, fits no one card) through the launcher's own torchrun command
# on N NCCL ranks, a card each, with remat full (else every gathered
# layer weight is kept for the backward); its first loss held to a
# forward of the same seed's params on one card within CARDS_TOL
# relative.  AdamW's first step at a 1-step warmup raises the loss of
# this model at random init, and at the launcher's default peak rate,
# 3e-3, it stays above the first (12.51 at step 1, 23.16 at step 2, 15.68
# at step 8): CARDS_LR.  One card's run at full width cut to 2 layers
# rises the same at both rates (test_torch_mesh_ranks.py's
# test_launcher_recipe_on_four_cards_matches_one_card).  Then the
# crossbar: sharded_gemm_op at CARDS_GEMM on
# the (N, 1) mesh, 2048 / 4 = 512 rows a card, phase 8's up product
CARDS_ARCH, CARDS_STEPS, CARDS_SEQ, CARDS_BATCH = "qwen2-7b", 8, 256, 8
CARDS_LR = 1e-4
CARDS_LAUNCH = ["--arch", CARDS_ARCH, "--mesh", "host", "--remat", "full",
                "--steps", str(CARDS_STEPS), "--seq-len", str(CARDS_SEQ),
                "--global-batch", str(CARDS_BATCH), "--lr", str(CARDS_LR)]
CARDS_TOL = 1e-5
# and first, the launcher's reduced comparison on the same cards: every
# step of DIST_RANK_LAUNCH (AdamW, cosine) against one card at
# DIST_RANK_TOL, as 14g runs it and with remat full
CARDS_REDUCED = [DIST_RANK_LAUNCH, DIST_RANK_LAUNCH + ["--remat", "full"]]
CARDS_GEMM = (2048, 18944, 3584)
CARDS_TIMEOUT = 900
# then the checkpointed run (cards_checkpoint): CARDS_LAUNCH plus
# --checkpoint-dir in a directory of its own under TMPDIR, SIGTERM to one
# rank once rank 0 has logged step CARDS_PREEMPT_AFTER (--log-every 1),
# every rank stopping after the same step and saving its own pieces;
# then the same command again, which resumes and trains to CARDS_STEPS.
# The two halves' losses are held to the straight run's: bit-equal, or,
# where the first half (a repeat of the straight run) already differs
# (NCCL's sums from run to run), within CARDS_TOL.  One checkpoint of the
# whole model is 91.4 GB (params, m, v in f32) and the resumed run writes
# a second: the part fails where TMPDIR's file system cannot hold two.
CARDS_PREEMPT_AFTER = 4
# then deepseek-v2-236b at full width (MOE_ARCH: d 5120, 128 MLA heads,
# 160 experts top-6 and 2 shared of ff 1536, vocab 102,400), params of
# seed 0 drawn on every card (Model.init(mesh=)), one torchrun of 4 NCCL
# ranks for each mesh of MOE_MESHES, each part against the same work on
# one card (every rank's own, after its mesh run).  On a mesh with more
# than one data shard the expert-parallel path sizes each expert's slots
# from the shard's tokens (the reference's arithmetic), so the one-card
# run of (a), (c) and (d) takes that capacity too (ShardedMoE): at the
# whole batch's capacity other pairs drop, also at capacity factor 8 on
# the pipeline's Zipf batches, where one token can be a quarter of them.
# (a) the MoE layer, f32, MOE_TOKENS tokens at the config's capacity
#     factor: output, aux loss, the input's and every param's gradient
#     within MOE_TOL of its largest magnitude; on (2, 2) against the layer
#     on each data shard's rows apart (its capacity), with the whole
#     batch's aux loss; tokens re-routed at near-ties held apart;
# (b) serving, (1, 4) only: MOE_SERVE_LAYERS layers at DIST_MOE_CF, f32
#     and bf16, a BATCH x PROMPT prefill (the expert-parallel path), then
#     MOE_DECODE greedy decode steps (the dense path): the logits through
#     routed_compare at phase 6d's gates; each decode step's ms and its
#     collectives by kind and mesh axis, none carrying an expert weight;
# (c) MOE_TRAIN_STEPS steps of plain SGD (no momentum) at MOE_TRAIN_LR of
#     the MOE_TRAIN_LAYERS cut (params and gradients, 44.2 GB, fit one
#     card; AdamW's state would not) on the launcher's batches, at the
#     config's capacity factor: losses within MOE_TOL relative, params
#     within MOE_TOL of each leaf's largest magnitude;
# (d) the MOE_STATE_LAYERS cut (153.1 GB of f32 AdamW state, 38.3 GB a
#     card) with the launcher's recipe (CARDS_LR, cosine, warmup 1, remat
#     full), CARDS_STEPS steps of CARDS_BATCH x CARDS_SEQ: losses finite
#     and equal on every rank, the first within MOE_TOL relative of one
#     card's forward (and printed beside its forward at the whole batch's
#     capacity); a profiled step and one more whose collectives are
#     counted by kind and axis
MOE_ARCH = "deepseek-v2-236b"
MOE_MESHES = ((1, 4), (2, 2))
MOE_TOKENS = (8, 256)
MOE_TOL = 1e-5
MOE_SERVE_LAYERS, MOE_DECODE = 2, 8
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_LR = 2, 3, 0.1
MOE_STATE_LAYERS = 3
# a stuck collective ends the rank job after this many seconds
MOE_GROUP_TIMEOUT = 300
# serving on a mesh (phase 14h; the [serve] part of --launcher-cards):
# SERVE_ARCH at full width (64 layers, d_model 5120, 40 query and 40 KV
# heads, 10 a card on SERVE_MESH, d_ff 27392, vocab 152064, QKV bias),
# BATCH prompts of PROMPT tokens, GEN generated, greedy; f32.
# 14h: SERVE_LAYERS layers on the 1-rank (1, 1) NCCL mesh, ContinuousEngine
#     on phase 6b's stream against the same engine without a mesh, the
#     captured batched step bit-equal to the eager one on the mesh;
# (a) SERVE_LAYERS layers on SERVE_MESH: Engine's sampled logits within
#     SERVE_TOL of their largest magnitude of one card's, its tokens one
#     card's, captured bit-equal to eager on the mesh;
# (b) the whole model on SERVE_MESH (140.8 GB of f32 params, which no card
#     holds; 35.2 GB a card), params from Model.init(mesh=): Engine, the
#     captured step against the eager one (bit-equal, timed beside the
#     weight-bytes bound), ContinuousEngine on phase 6b's stream under a
#     wall clock; the Engine's logits teacher-forced on its own tokens
#     against the whole model in bf16 on one card (70.4 GB), at phase 6a's
#     gate (TOL_BF16_LOGITS of their largest magnitude)
SERVE_ARCH = "qwen1.5-32b"
SERVE_LAYERS = 2
SERVE_MESH = (1, 4)
SERVE_TOL = 1e-5
SERVE_SLOT_REQUESTS = 8  # requests of (a)'s slot engines, the stream's first
SERVE_MARGIN_GB = 4.0   # beside a reckoned peak: caches, activations
SERVE_TIMEOUT = 1200
# the raising entry point (phase 15): three configs whose blocks cover
# every raisable block kind, each with its raised blocks and its blocked
# ones with their first unraisable ATen op (docs/RAISING.md's rows, the
# jax primitive named as its ATen op), and the plan rows the reference's
# serve.compiled.plan_blocks gives on TPU_V5E: (block, status, schedule,
# modelled cycles, CUDA emission where the reference has its Pallas one)
RAISED = {"qwen2_7b": (("rmsnorm", "mlp", "head", "attn_softmax"),
                       {"rope": "aten.slice.Tensor"}),
          "mamba2_130m": (("rmsnorm", "head", "ssd_core"), {}),
          "recurrentgemma_2b": (("rmsnorm", "mlp", "head", "attn_softmax",
                                 "rglru_core"),
                                {"rope": "aten.slice.Tensor"})}
_KG = "autotuned:tpu_mxu_kgrid"
PLAN_ROWS = {
    "qwen2_7b": (("rmsnorm", "compiled", "tpu_mxu", 1641, True),
                 ("mlp", "compiled", _KG, 8544, True),
                 ("head", "compiled", _KG, 4054, True),
                 ("attn_softmax", "compiled", _KG, 1034, False),
                 ("rope", "fallback", None, None, False)),
    "mamba2_130m": (("rmsnorm", "compiled", "tpu_mxu", 1641, True),
                    ("head", "compiled", _KG, 4054, True),
                    ("ssd_core", "compiled", "nested", 11472, True)),
    "recurrentgemma_2b": (("rmsnorm", "compiled", "tpu_mxu", 1641, True),
                          ("mlp", "compiled", _KG, 15843, True),
                          ("head", "compiled", _KG, 4054, True),
                          ("attn_softmax", "compiled", _KG, 1034, False),
                          ("rope", "fallback", None, None, False),
                          ("rglru_core", "compiled", "tpu_mxu", 6274, True))}
# phase 15b: qwen2-7b's MLP block over phase 8's 4 x 128 tokens, held to
# apply_mlp on the card and to run_ref at the emitted GEMM's f32 bound
RAISED_MLP = (BATCH, PROMPT)
# kernel names of the products in a profile (cuBLAS, cuBLASLt, CUTLASS)
PRODUCT_KERNELS = ("gemm", "gemv", "cutlass", "nvjet", "splitK")
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


def engine_step(eng, toks, extra_embeds=None):
    """A decode step of ``Engine`` ``eng`` after a prefill of ``toks``'
    prompts (with a stub frontend's ``extra_embeds``), as a callable (each
    call decodes one more position)."""
    cache = eng.model.cache_init(BATCH, PROMPT + GEN + 1)
    logits, cache = eng.prefill(eng.params, cache, toks[:, :PROMPT],
                                extra_embeds)
    state = {"tok": logits.argmax(-1, keepdim=True), "cache": cache}

    def step():
        logits, state["cache"] = eng.decode(eng.params, state["cache"],
                                            state["tok"])
        state["tok"] = logits.argmax(-1, keepdim=True)
    return step


def profile_steps(step, steps: int = 4):
    """Device time per call of ``step``, from torch.profiler's kernel times
    over a few calls, the wall time per call of that same window (the
    profiler slows the host, so it is longer than an unprofiled step), the
    largest kernels (ms per step, launches per step, name) and the host's
    launch calls per step (``HOST_CALLS`` the profiler saw: kernel and
    graph launches, asynchronous copies and fills).  Returns (busy ms per
    step or None where the profiler records no device time, window ms per
    step, rows, host calls per step)."""
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
    rows, calls = [], 0
    for e in prof.key_averages():
        # device-side events only: the CPU operators that launched them
        # report the same device time again
        if e.device_type == DeviceType.CPU:
            calls += e.count if e.key in HOST_CALLS else 0
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return (busy if busy > 0 else None), window, rows, calls / steps


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


_MM_F32 = {}


def mm_f32_refusal(dtype):
    """None when ``torch.mm(a, b, out_dtype=torch.float32)`` (aten::mm.dtype:
    f16 or bf16 operands, f32 accumulation, an f32 output) runs on the
    card for ``dtype`` operands; else why it does not, once a dtype."""
    if dtype not in _MM_F32:
        x = torch.ones((16, 16), dtype=dtype, device="cuda")
        try:
            y = torch.mm(x, x, out_dtype=torch.float32)
            _MM_F32[dtype] = (None if y.dtype == torch.float32 and
                              bool((y == 16).all()) else
                              f"gave {y.dtype}, {y.flatten()[0].item()}")
        except (TypeError, RuntimeError, NotImplementedError) as e:
            _MM_F32[dtype] = f"{type(e).__name__}: {e}"
    return _MM_F32[dtype]


def gemm_library(plan, a, b):
    """One PyTorch call that computes what the emitted GEMM of ``plan``
    computes on ``a``, ``b``: ``torch.mm(..., out_dtype=torch.float32)``
    for f16 / bf16 operands with an f32 output (compile_gemm's products),
    else ``torch.matmul``.  Returns (name, callable or None, what to print
    when there is none)."""
    low = plan.dtypes[plan.matmul.lhs.buffer.name] in ("float16", "bfloat16")
    if not (low and plan.dtypes[plan.out_buffer] == "float32"):
        return "torch.matmul", lambda: torch.matmul(a, b), None
    why = mm_f32_refusal(a.dtype)
    if why is not None:
        return ("torch.mm(out_dtype=float32)", None,
                f"torch.mm(out_dtype=float32): none on this torch ({why})")
    return ("torch.mm(out_dtype=float32)",
            lambda: torch.mm(a, b, out_dtype=torch.float32), None)


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
         "bound_ms": bound, "bound_by": bound_by}
    r["library_ms"], lib = library_times(plan, a[0], a[1], got, flush)
    print(f"[timing] {name}, cold L2: kernel {r['ms']:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}), gemm_plain {r['plain_ms']:.3f} ms, "
          f"{lib}; card {smi}")
    return r


def library_times(plan, a, b, got, flush):
    """The library time of an emitted GEMM's row (``gemm_library``) and
    the text to print: for f16 / bf16 operands with an f32 output,
    ``torch.mm(out_dtype=float32)`` (or why there is none, and then no
    library time: ``torch.matmul`` computes another function) beside
    ``torch.matmul`` (whose output is in the operands' type), with the
    first's largest difference from the kernel's output."""
    lib_name, lib, why = gemm_library(plan, a, b)
    matmul_ms = time_ms(lambda: torch.matmul(a, b), flush, iters=20)
    if lib_name == "torch.matmul":
        return matmul_ms, f"torch.matmul {matmul_ms:.3f} ms"
    if lib is None:
        return None, f"{why}; torch.matmul {matmul_ms:.3f} ms"
    diff = (lib() - got.float()).abs().max().item()
    ms = time_ms(lib, flush, iters=20)
    return ms, (f"{lib_name} {ms:.3f} ms (max |diff| {diff:.3e} vs the "
                f"kernel), torch.matmul ({a.dtype} output) "
                f"{matmul_ms:.3f} ms")


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


def compile_autos(dev):
    """Phase 8b's kernels: qwen2-7b's MLP products through
    ``ops.matmul(backend="cuda_auto")``'s compiler (``gemm._build_auto``:
    the cost-model search's schedule and tiles, priced on the TPU_V5E
    machine model), f32 and bf16."""
    from repro_torch.core.autotune import best_schedule
    from repro_torch.kernels import gemm
    out = []
    for prod in AUTO_PRODUCTS:
        m, n, k = MLP[prod]
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            ck = gemm._build_auto(m, n, k, dtype)
            name = f"stagecc_gemm cuda_auto {prod} {dtype}"
            check(ck.run_cuda is not None, f"{name}: no CUDA emission")
            print(f"[compile] {name}: M={m} N={n} K={k}, searched "
                  f"{best_schedule(m, n, k)}: schedule {ck.schedule}, tiles "
                  f"{ck.run_cuda.plan.tiles}, {ck.cycles.total:,} cycles "
                  f"modelled on TPU_V5E (a machine model, not a time), "
                  f"compiled in {time.perf_counter() - t0:.2f}s")
            out.append((prod, name, ck))
    return out


def auto_phase(autos, dev, flush, smi):
    """Phase 8b: ``ops.matmul(backend="cuda_auto")`` on qwen2-7b's up and
    down products, f32 and bf16, with the counts reset: each one launch on
    the route ``_gemm_route`` picks for the searched tiles, held to phase
    8's gates and timed beside its bound, gemm_plain and the library calls
    (``library_times``).  Returns the JSON rows."""
    from repro_torch.kernels import gemm, ops
    cg = gemm.cuda_gemm
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {prod: [torch.randn(s, generator=gen, device=dev)
                   for s in ((m, k), (k, n))]
            for prod, (m, n, k) in MLP.items() if prod in AUTO_PRODUCTS}
    rows = []
    for g in autos:
        prod, name, ck = g
        a = [x.to(getattr(torch, name.split()[-1])) for x in data[prod]]
        cg.launches = cg.wgmma_launches = cg.ffma_launches = 0
        got = ops.matmul(*a, backend="cuda_auto")
        torch.cuda.synchronize()
        path = route_of(cg, (0, 0))
        why = ck.run_cuda.route(*a)[1]
        print(f"[auto] {name}: cuda_gemm launches {cg.launches}, route "
              f"{path} ({why}); tiles {ck.run_cuda.plan.tiles}")
        check(cg.launches == 1, f"{name}: {cg.launches} launches")
        check(path == ("wgmma" if "bfloat16" in name else "ffma"),
              f"{name}: route {path}")
        rows.append(gemm_row(g, a, got, 1, path, flush, smi))
        del got
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
    busy, window, rows, _ = profile_steps(step, steps)
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


def wall_ms(step, steps: int = 8) -> float:
    """Host wall ms per call of ``step`` over ``steps`` calls that end in
    one synchronise, after one call to warm up."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def event_ms(step) -> float:
    """Device ms between CUDA events around one call of ``step``, with
    the card idle before it: the step's device time plus any gap the
    host leaves between its launches."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_vs_eager(label, model, params, cache, tok, bound_ms, tol):
    """The decode step from one state (``cache`` with its lengths, an int
    or per-row, and the next tokens ``tok``; on a mesh under its
    ``axis_rules``, the logits gathered) eagerly (``model.apply``) and
    captured (``serve.graphs.DecodeGraph``, as the engines replay it),
    each on its own copy of the cache, greedy tokens fed back: first their
    logits over four steps side by side (bit-equal expected; held to
    ``tol(scale)``, the gate of the dtype, and the greedy tokens must be
    the same), then per path the wall ms a step, the device's busy ms (the
    profiler; a captured step's also from CUDA events around one replay)
    and idle share, and the host's launch calls a step.  Returns the rows
    of both paths.  On a mesh the NCCL kernels wait for the other ranks
    inside their device time, so there busy counts the compute kernels
    only (``step_split``), the NCCL kernels' ms printed beside it."""
    from repro_torch.distributed.sharding import full
    from repro_torch.serve.graphs import DecodeGraph
    ce, cg = clone(cache), clone(cache)
    graph = DecodeGraph(model, params, cg, tok.shape[0], PROMPT + GEN + 1)
    st = {"eager": tok.to(torch.int32), "captured": tok.to(torch.int32)}

    def eager():
        logits, _ = model.apply(params, st["eager"], cache=ce)
        logits = full(logits[:, -1])        # gathered on a mesh, as captured
        st["eager"] = logits.argmax(-1, keepdim=True).to(torch.int32)
        return logits

    def captured():
        logits = graph(st["captured"], cg["len"])
        cg["len"] = cg["len"] + 1
        st["captured"] = logits.argmax(-1, keepdim=True).to(torch.int32)
        return logits

    worst, scale, same = 0.0, 0.0, True
    with torch.no_grad():
        for _ in range(4):
            a, b = eager().float(), captured().float()
            worst = max(worst, (a - b).abs().max().item())
            scale = max(scale, a.abs().max().item())
            same &= torch.equal(st["eager"], st["captured"])
    print(f"[graphs] {label}: captured vs eager step over 4 steps from one "
          f"state: logits max_abs_diff {worst:.3e} "
          f"({'bit-equal' if worst == 0 else 'NOT bit-equal'}; limit "
          f"{tol(scale):.3g}), greedy tokens "
          f"{'identical' if same else 'DIFFERENT'}")
    check(same, f"{label}: captured and eager steps chose other tokens")
    check(worst <= tol(scale), f"{label}: captured step off by {worst}")
    rows = {}
    with torch.no_grad():
        for name, step in (("eager", eager), ("captured", captured)):
            ms = wall_ms(step)
            busy, window, krows, calls = profile_steps(step, 3)
            ev = event_ms(step)
            split = step_split(krows)
            how = "profiler"
            if split["nccl"]:
                busy = split["products_ms"] + split["other_ms"]
                how = (f"profiler, compute kernels; NCCL kernels "
                       f"{split['nccl_ms']:.2f} ms apart, waits included")
            if busy is None and name == "captured":
                busy, how = ev, "CUDA events around one replay"
            check(busy is not None, f"{label} {name}: no device time")
            rows[name] = {"ms": ms, "busy": busy, "events": ev,
                          "calls": calls, "nccl_ms": split["nccl_ms"],
                          "kernels": sum(r[1] for r in krows)}
            print(f"[graphs] {label} {name} step: {ms:.2f} ms wall a step; "
                  f"device busy {busy:.2f} ms ({how}; {ev:.2f} ms between "
                  f"events around one step), idle share "
                  f"{1 - busy / ms:.1%}; {calls:.0f} host launch "
                  f"calls a step, {rows[name]['kernels']} kernels a step on "
                  f"the device; weight-bytes bound {bound_ms:.2f} ms")
    print(f"[graphs] {label}: captured step {rows['captured']['ms']:.2f} ms "
          f"against eager {rows['eager']['ms']:.2f} ms wall "
          f"({rows['eager']['ms'] / rows['captured']['ms']:.2f}x); host "
          f"launch calls {rows['captured']['calls']:.0f} against "
          f"{rows['eager']['calls']:.0f}")
    return rows


def engines_agree(label, model, params, prompts, captured_eng,
                  extra_embeds=None):
    """The captured ``Engine``'s greedy streams and warm decode time
    against an eager ``Engine``'s (``cuda_graphs=False``) on the same
    prompts (and a stub frontend's ``extra_embeds``), in the same call;
    the streams must be identical.  Returns the eager engine's warm
    stats."""
    from repro_torch.serve.engine import Engine, EngineConfig, \
        throughput_stats
    eager = Engine(model, params, EngineConfig(max_len=PROMPT + GEN + 1,
                                               cuda_graphs=False))
    ee = dict(extra_embeds=extra_embeds)
    throughput_stats(eager, prompts, GEN, **ee)
    warm = throughput_stats(eager, prompts, GEN, **ee)
    got = captured_eng.generate(prompts, GEN, **ee)
    want = eager.generate(prompts, GEN, **ee)
    same = int(sum(np.array_equal(g, w) for g, w in zip(got, want)))
    print(f"[{label}] eager Engine (cuda_graphs=False), warm rerun: decode "
          f"{warm['decode_tok_per_s']:.1f} tok/s "
          f"({warm['decode_s'] / GEN * 1e3:.2f} ms/step); greedy streams "
          f"of the captured Engine: {same} of {len(want)} rows identical "
          f"to the eager Engine's")
    check(same == len(want), f"{label}: captured Engine streams differ")
    return warm


def prefilled(model, params, toks, extra_embeds=None):
    """A cache of the serving depth holding ``toks``' first PROMPT tokens
    (one length for every row; with a stub frontend's ``extra_embeds``;
    made on the active mesh, if any), and the next tokens."""
    from repro_torch.distributed.sharding import current_mesh
    cache = model.cache_init(BATCH, PROMPT + GEN + 1, mesh=current_mesh())
    with torch.no_grad():
        model.apply(params, toks[:, :PROMPT], extra_embeds=extra_embeds,
                    cache=cache)
    return cache, toks[:, PROMPT:PROMPT + 1]


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
    print(f"[bf16] warm rerun (captured decode steps): prefill "
          f"{warm['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {warm['decode_tok_per_s']:.1f} tok/s "
          f"({step_ms:.2f} ms/step; weight-bytes bound {bound:.2f} ms), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    eager_warm = engines_agree("bf16", model, params, prompts, eng)
    graph_vs_eager("bfloat16 Engine", model, params,
                   *prefilled(model, params, toks), bound,
                   lambda scale: TOL_BF16_LOGITS * scale)
    with torch.no_grad():
        serving_profile("bf16 eager decode step", engine_step(eng, toks), 4,
                        bound, eager_warm["decode_s"] / GEN * 1e3)
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


def same_streams(label, got, eager, model, params):
    """The continuous engine's greedy streams from captured steps
    (``got``) against its eager ones (``eager``, which must be the same
    bit for bit), and against the serial B=1 engine's on the same stream,
    captured (B=1 graphs, one a slot) and eager (which must agree with
    each other).  Returns how many of ``got`` the serial engine
    reproduces."""
    from repro_torch.serve.engine import SerialSlotEngine
    serial = {g: SerialSlotEngine(model, params, slots=BATCH,
                                  max_len=PROMPT + GEN + 1,
                                  cuda_graphs=g).serve(
                                      continuous_stream(model.cfg))
              for g in (True, False)}
    n = len(serial[True])
    agree = {what: sum(np.array_equal(a[r], b[r]) for r in serial[True])
             for what, (a, b) in {
                 "continuous": (got, eager),
                 "serial": (serial[True], serial[False]),
                 "vs serial": (got, serial[True])}.items()}
    print(f"[continuous] {label}: greedy streams from captured steps: "
          f"{agree['continuous']} of {n} bit-identical to the eager "
          f"ContinuousEngine's; SerialSlotEngine captured vs eager "
          f"{agree['serial']} of {n}; continuous vs SerialSlotEngine (B=1 "
          f"steps) {agree['vs serial']} of {n}")
    check(agree["continuous"] == n and agree["serial"] == n,
          f"{label}: captured streams differ from eager ones: {agree}")
    return agree["vs serial"]


def continuous_run(model, params, cuda_graphs, plan=None):
    """The launcher's --continuous stream through a ContinuousEngine with
    a wall clock, submitting under backpressure as the launcher does; the
    engine keeps ``plan`` (a compile plan) as a record.  Returns (engine,
    metrics snapshot, decode_attention launches)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.metrics import ServeMetrics, WallClock
    metrics = ServeMetrics(WallClock(), slots=BATCH)
    eng = ContinuousEngine(model, params, slots=BATCH,
                           max_len=PROMPT + GEN + 1, metrics=metrics,
                           cuda_graphs=cuda_graphs, plan=plan)
    da.decode_attention.launches = 0
    for r in continuous_stream(model.cfg):
        while not eng.submit(r):
            eng.step()
    eng.drain()
    return eng, metrics.snapshot(), da.decode_attention.launches


def continuous_phase(cfg, bmodel, bparams, dev, plan):
    """Phase 6b: serve the load generator's stream through
    ``launch.serve --continuous`` (f32, the launcher's default: captured
    batched steps), then the bf16 model of phase 6a through
    ContinuousEngine on the same stream; each again with eager steps
    (``cuda_graphs=False``) in the same call.  Every request completes,
    decode_attention launches once a layer per batched step (counted at
    each replay), the captured streams are the eager ones and the serial
    engine's are compared, one batched step matches B=1 steps of its
    slots, and the batched step is timed captured and eager.  The bf16
    engine carries ``plan`` (phase 15c: qwen2_7b's compile plan), which it
    keeps and does not run.  Returns the launches of each captured run."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    da.decode_attention.launches = 0
    res = serve.main(["--arch", ARCH, "--continuous", "--slots", str(BATCH),
                      "--requests", str(CONT_REQUESTS), "--rate",
                      str(CONT_RATE), "--prompt-len", str(PROMPT), "--gen",
                      str(GEN)])
    launches = {"float32": da.decode_attention.launches}
    eng = res.pop("engine")
    snapshot_line("float32 (launch.serve --continuous, captured steps)", res)
    check(res["requests"]["completed"] == CONT_REQUESTS,
          f"{res['requests']['completed']} of {CONT_REQUESTS} completed")
    print(f"[continuous] float32: decode_attention launches "
          f"{launches['float32']} = {cfg.num_layers} layers x {eng.steps} "
          f"batched steps")
    check(launches["float32"] == cfg.num_layers * eng.steps,
          f"continuous: {launches['float32']} launches, {eng.steps} steps")
    runs = {"float32": (eng.model, eng.params, dict(eng.results),
                        lambda s: TOL_BACKENDS)}
    del eng, res
    beng, snap, launches["bfloat16"] = continuous_run(bmodel, bparams, True,
                                                      plan=plan)
    snapshot_line("bfloat16 (ContinuousEngine, captured steps)", snap)
    print(f"[raise] 15c: the bf16 ContinuousEngine carries the compile "
          f"plan (engine.plan is plan: {beng.plan is plan}); its streams "
          f"are checked below\n{plan.describe()}")
    check(beng.plan is plan, "the engine does not keep its plan")
    check(snap["requests"]["completed"] == CONT_REQUESTS,
          f"bf16: {snap['requests']['completed']} of {CONT_REQUESTS}")
    check(launches["bfloat16"] == cfg.num_layers * beng.steps,
          f"bf16 continuous: {launches['bfloat16']} launches, "
          f"{beng.steps} steps")
    print(f"[continuous] bfloat16: decode_attention launches "
          f"{launches['bfloat16']} = {cfg.num_layers} layers x "
          f"{beng.steps} batched steps")
    runs["bfloat16"] = (bmodel, bparams, dict(beng.results),
                        lambda s: TOL_BF16_LOGITS * s)
    del beng
    for label, (model, params, results, tol) in runs.items():
        eager, esnap, _ = continuous_run(model, params, False)
        snapshot_line(f"{label} eager (ContinuousEngine, "
                      f"cuda_graphs=False)", esnap)
        same_streams(label, results, eager.results, model, params)
        del eager
        batched_vs_single(model, params, tol, label)
        step_time(label, model, params, tol)
        if label == "float32":
            del model, params
            runs[label] = None
            torch.cuda.empty_cache()
    return launches


def step_time(label, model, params, tol, steps: int = 8):
    """The continuous engine's batched step with all four slots occupied
    (per-row lengths): captured against eager from the same state
    (``graph_vs_eager``); and the eager batched step beside the same rows'
    uniform-length eager step (Engine's eager path: one int length,
    nothing uploaded), wall ms per step over ``steps`` steps that end in
    one synchronise, in the same call."""
    from repro_torch.models.transformer import copy_rows
    from repro_torch.serve.continuous import ContinuousEngine, Request
    eng = ContinuousEngine(model, params, slots=BATCH,
                           max_len=PROMPT + GEN + 1, cuda_graphs=False)
    rng = np.random.default_rng(4)
    for i in range(BATCH):
        eng.submit(Request(i, rng.integers(0, model.cfg.vocab_size,
                                           (PROMPT,)).astype(np.int32), GEN))
    eng.step()
    size = 4 if model.pdtype == torch.float32 else 2
    graph_vs_eager(f"{label} continuous batched step", model, params,
                   eng._cache, eng._tok,
                   model.param_count() * size / HBM_BYTES_PER_S * 1e3, tol)
    uniform = model.cache_init(BATCH, eng.depth)
    toks = []
    for s in range(BATCH):
        one, tok = eng.slot_state(s)
        copy_rows(uniform, s, one, 0)
        uniform["len"] = one["len"]
        toks.append(tok)
    toks = torch.cat(toks)
    with torch.no_grad():
        ms = wall_ms(eng.decode_step, steps)
        uni = wall_ms(lambda: model.apply(params, toks, cache=uniform), steps)
    print(f"[continuous] {label} eager batched step, 4 slots at "
          f"{PROMPT + 2}-{PROMPT + 2 + steps} cached positions: {ms:.2f} "
          f"ms/step wall; the same rows at one length through Engine's "
          f"eager path: {uni:.2f} ms/step")


# ---- phase 6d: the recurrent and MoE families --------------------------


class RouterLog:
    """While active, records the router logits of every MoE layer call
    (``models.moe.apply_moe``), computed as the layer computes them
    (the same product on the same shapes), as (B, S, E) float32."""

    def __enter__(self):
        from repro_torch.distributed.sharding import full
        from repro_torch.models import layers, moe
        self.calls, self._moe = [], moe
        self._orig = orig = moe.apply_moe

        def apply(p, x, cfg):
            B, S, d = x.shape
            h = layers.rmsnorm(x, p["norm"], cfg.norm_eps).reshape(B * S, d)
            # a DTensor's logits (phase 14c) are gathered whole
            self.calls.append(full((h @ p["router"]).float()).reshape(
                B, S, -1))
            return orig(p, x, cfg)
        moe.apply_moe = apply
        return self

    def __exit__(self, *exc):
        self._moe.apply_moe = self._orig

    def per_layer(self, layers: int):
        """The logged calls as one (B, S, E) tensor per MoE layer, each
        call's positions appended along S (a prefill, then decode
        steps)."""
        return [torch.cat(self.calls[i::layers], dim=1)
                for i in range(layers)]


def route_flips(ra, rb, top_k):
    """Two runs' router logits ``ra``, ``rb`` (..., E): where their top-K
    sets differ, and where such a flip is explained by the runs' rounding:
    the gap between the K-th and (K+1)-th logits (in either run) is at
    most twice the largest difference of that token's router logits."""
    sa = torch.sort(torch.softmax(ra, -1), dim=-1, descending=True,
                    stable=True)[1]
    sb = torch.sort(torch.softmax(rb, -1), dim=-1, descending=True,
                    stable=True)[1]
    flip = (sa[..., :top_k].sort(-1)[0] != sb[..., :top_k].sort(-1)[0]
            ).any(-1)
    delta = (ra - rb).abs().amax(-1)

    def gap(r, order):
        return (r.gather(-1, order[..., top_k - 1:top_k])
                - r.gather(-1, order[..., top_k:top_k + 1]))[..., 0]
    near = torch.minimum(gap(ra, sa), gap(rb, sb)) <= 2 * delta
    return flip, near


def routed_compare(label, a, b, routes_a, routes_b, top_k, limit_of):
    """Logits ``a`` against ``b`` (B, S, V), position by position, where
    an MoE model's two runs may route a token to other experts: the
    roundings of two computations of one function (bf16 products whose
    kernels depend on the row count) move a router logit by a few ulps,
    and where the K-th and (K+1)-th logits of a token lie closer than
    that the top-K set flips, which changes that position's logits by
    O(1).  The router logits of the two runs must agree within
    ``limit_of(their largest magnitude)``, and a flip is accepted only
    where that difference explains it: the gap between the K-th and
    (K+1)-th logits (in either run) is at most twice the largest
    difference of the token's router logits between the runs.  Every
    position whose routing agrees in every MoE layer must be within
    ``limit_of(the logits' largest magnitude)``.  ``routes_*``: per MoE
    layer, (B, S, E) router logits.  Returns (max error over agreeing
    positions, flips, positions)."""
    err = (a.float() - b.float()).abs().amax(-1)                  # (B, S)
    limit = limit_of(b.float().abs().max().item())
    flipped = torch.zeros_like(err, dtype=torch.bool)
    unexplained, router = 0, 0.0
    for ra, rb in zip(routes_a, routes_b):
        moved = (ra - rb).abs().max().item()
        router = max(router, moved)
        check(moved <= limit_of(rb.abs().max().item()),
              f"{label}: router logits differ by {moved}")
        flip, near = route_flips(ra, rb, top_k)
        unexplained += int((flip & ~near).sum())
        flipped |= flip
    worst = err[~flipped].max().item() if (~flipped).any() else 0.0
    n = int(flipped.sum())
    print(f"[family] {label}: router logits max_abs_diff {router:.3e}; "
          f"{n} of {err.numel()} positions routed to other experts by the "
          f"two runs (each at a near-tie of the router, {unexplained} not);"
          f" max_abs_diff {worst:.3e} over the others (limit {limit:.3g})"
          + (
              f"; at the re-routed positions up to "
              f"{err[flipped].max().item():.3e}" if n else ""))
    check(unexplained == 0, f"{label}: {unexplained} re-routed positions "
          f"where the router was not at a near-tie")
    check(worst <= limit, f"{label}: logits off by {worst}")
    return worst, n, err.numel()


def family_teacher(label, model, params, toks, f32):
    """Prefill + 4 decode steps against one full forward on the same
    params.  An MoE layer's capacity grows with the tokens of a call, so
    the three calls would drop different tokens: the check runs with
    capacity for every token (capacity_factor = experts / top_k, as
    tests/test_decode_consistency.py raises it), which the serving runs
    do not, and holds re-routed positions apart (``routed_compare``).
    f32 within TOL_TEACHER, bf16 within TOL_BF16_LOGITS of the logits'
    largest magnitude.  Returns (error, limit)."""
    import dataclasses
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layer_kinds
    cfg = model.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    teacher = Model(cfg, model.run, model.device)
    with torch.no_grad(), RouterLog() as full_log:
        full, _ = teacher.apply(params, toks)
    with torch.no_grad(), RouterLog() as cached_log:
        cache = teacher.cache_init(BATCH, PROMPT + GEN + 1)
        pre, _ = teacher.apply(params, toks[:, :PROMPT], cache=cache)
        steps = [pre]
        for t in range(PROMPT, PROMPT + 4):
            lg, _ = teacher.apply(params, toks[:, t:t + 1], cache=cache)
            steps.append(lg)
    check(tuple(full.shape) == (BATCH, PROMPT + 4, cfg.padded_vocab),
          f"{label}: logits shape {tuple(full.shape)}")
    check(bool(torch.isfinite(full).all()), f"{label}: non-finite logits")
    limit_of = ((lambda scale: TOL_TEACHER) if f32 else
                (lambda scale: TOL_BF16_LOGITS * scale))
    moes = layer_kinds(cfg).count("moe")
    err, _, _ = routed_compare(
        f"{label} prefill {PROMPT} + 4 decode steps vs full forward (logits"
        f" max |x| {full.float().abs().max().item():.2f})",
        torch.cat(steps, dim=1), full, cached_log.per_layer(moes),
        full_log.per_layer(moes), cfg.moe.top_k if cfg.moe else 0,
        limit_of)
    return err, limit_of(full.float().abs().max().item())


def family_run(arch, depth, dtype, per_step, dev):
    """One family model at full width (all layers, or ``depth`` of them)
    in ``dtype``, weights from the launcher's seed, serving the launcher's
    prompts through ``Engine`` on captured decode steps: decode_attention's
    launches (``per_step`` a step, counted through the replays), prefill
    and decode rates, ms per step beside the weight-bytes bound, peak
    memory; the eager Engine's streams; the captured step against the
    eager one from one state (bit-equal logits; device busy and idle
    share); a profiled eager step; prefill + decode against a full
    forward; for a model on the kernel, the decode logits with the kernels
    against the plain versions; for FAMILY_CONTINUOUS in f32, the
    continuous engine on the launcher's stream against the serial one.
    Returns a summary dict."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.engine import (Engine, EngineConfig,
                                          throughput_stats)
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    f32 = dtype == "float32"
    label = f"{arch} {dtype}" + (f" {depth} layers" if depth else "")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, RunConfig(param_dtype=dtype, cache_dtype=dtype), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n = model.param_count()
    bound = n * (4 if f32 else 2) / HBM_BYTES_PER_S * 1e3
    eng = Engine(model, params, EngineConfig(max_len=PROMPT + GEN + 1))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    da.decode_attention.launches = 0
    res = throughput_stats(eng, prompts, GEN)
    launches, steps = da.decode_attention.launches, res["decode_steps"]
    print(f"[family] {label}: {cfg.num_layers} layers d_model {cfg.d_model}"
          f", {n:,} params; decode_attention launches {launches} = "
          f"{per_step} a step x {steps} decode steps")
    check(steps == GEN, f"{label}: {steps} decode steps, expected {GEN}")
    check(launches == per_step * steps,
          f"{label}: decode_attention launched {launches} times, expected "
          f"{per_step} x {steps}")
    warm = throughput_stats(eng, prompts, GEN)
    step_ms = warm["decode_s"] / GEN * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[family] {label} warm rerun (captured decode steps): prefill "
          f"{warm['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{warm['decode_tok_per_s']:.1f} tok/s ({step_ms:.3f} ms/step; "
          f"weight-bytes bound {bound:.3f} ms, {step_ms / bound:.2f}x it), "
          f"peak memory {peak:.1f} GiB")
    eager_warm = engines_agree(f"family {label}", model, params, prompts, eng)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + 4)).astype(np.int64)).to(dev)
    rows = graph_vs_eager(label, model, params,
                          *prefilled(model, params, toks), bound,
                          lambda scale: 0.0)
    with torch.no_grad():
        serving_profile(f"{label} eager decode step", engine_step(eng, toks),
                        4, bound, eager_warm["decode_s"] / GEN * 1e3)
    del eng
    teacher = family_teacher(label, model, params, toks, f32)
    out = {"label": label, "params": n, "launches": launches,
           "prefill_tok_per_s": warm["prefill_tok_per_s"],
           "decode_tok_per_s": warm["decode_tok_per_s"], "ms": step_ms,
           "bound_ms": bound, "peak_gib": peak,
           "captured_busy_ms": rows["captured"]["busy"],
           "captured_idle": max(0.0, 1 - rows["captured"]["busy"] /
                                rows["captured"]["ms"]),
           "teacher": teacher}
    if per_step:
        from repro_torch.models.transformer import layer_kinds
        plain = Model(cfg, RunConfig(backend="torch", param_dtype=dtype,
                                     cache_dtype=dtype), dev)
        with torch.no_grad():
            cache = model.cache_init(BATCH, PROMPT + GEN + 1)
            model.apply(params, toks[:, :PROMPT], cache=cache)
            twin = clone(cache)
            with RouterLog() as got_log:
                got, _ = model.apply(params, toks[:, PROMPT:PROMPT + 1],
                                     cache=cache)
            with RouterLog() as want_log:
                want, _ = plain.apply(params, toks[:, PROMPT:PROMPT + 1],
                                      cache=twin)
        scale = want.float().abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
        moes = layer_kinds(cfg).count("moe")
        routed_compare(f"{label} decode logits, cuda vs torch (logits max "
                       f"|x| {scale:.2f})", got, want,
                       got_log.per_layer(moes), want_log.per_layer(moes),
                       cfg.moe.top_k,
                       (lambda s: TOL_BACKENDS) if f32 else
                       (lambda s: TOL_BF16_LOGITS * s))
        del cache, twin
    if arch in FAMILY_CONTINUOUS and f32:
        ceng, snap, _ = continuous_run(model, params, True)
        snapshot_line(f"{label} (ContinuousEngine, captured steps)", snap)
        check(snap["requests"]["completed"] == CONT_REQUESTS,
              f"{label}: {snap['requests']['completed']} of "
              f"{CONT_REQUESTS} completed")
        eager, esnap, _ = continuous_run(model, params, False)
        snapshot_line(f"{label} eager (ContinuousEngine, "
                      f"cuda_graphs=False)", esnap)
        agree = same_streams(label, ceng.results, eager.results, model,
                             params)
        check(agree == CONT_REQUESTS,
              f"{label}: {agree} of {CONT_REQUESTS} continuous streams are "
              f"SerialSlotEngine's")
        out["continuous_tok_per_s"] = snap["tokens_per_s"]
        del ceng, eager
    del model, params
    torch.cuda.empty_cache()
    return out


def family_phase(dev, flush, smi):
    """Phase 6d: every run of FAMILY_RUNS (``family_run``), one model at a
    time; then decode_attention's row at kimi-k2's decode shapes with the
    launches of its run.  Returns the JSON rows."""
    from repro_torch.kernels import decode_attention as da
    runs = [family_run(arch, depth, dtype, per_step, dev)
            for arch, depth, dtypes, per_step in FAMILY_RUNS
            for dtype in dtypes]
    print("[family] summary: run | ms/step | bound ms | x bound | decode "
          "tok/s | prefill tok/s | captured idle | peak GiB")
    for r in runs:
        print(f"[family]   {r['label']} | {r['ms']:.3f} | "
              f"{r['bound_ms']:.3f} | {r['ms'] / r['bound_ms']:.2f} | "
              f"{r['decode_tok_per_s']:.1f} | {r['prefill_tok_per_s']:.1f} |"
              f" {r['captured_idle']:.1%} | {r['peak_gib']:.1f}; card {smi}")
    kimi = next(r for r in runs if r["label"].startswith("kimi-k2"))
    B, KV, rep, hd, smax = BATCH, 8, 8, 128, PROMPT + GEN + 1
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd))).to(
        dev, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal((2, B, smax, KV, hd))).to(
        dev, torch.bfloat16)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    valid = torch.tensor(KIMI_VALID, dtype=torch.int32, device=dev)
    err = (da.decode_attention(q, k, v, valid).float()
           - da.decode_attention_ref(q, k, v, valid).float()
           ).abs().max().item()
    print(f"[kernel] decode_attention bfloat16 at kimi-k2's decode shapes "
          f"(KV 8, rep 8) valid {KIMI_VALID}: max_abs_err {err:.3e} "
          f"(limit {TOL_BF16:g})")
    check(err <= TOL_BF16, f"decode_attention at kimi-k2's shapes: {err}")
    return [decode_row("decode_attention [kimi-k2 bf16 serving]",
                       (q, k, v, valid), 256, kimi["launches"], err, flush,
                       smi, lib_tol=TOL_BF16)]


# ---- phase 6e: the stub frontends, whisper-base and pixtral-12b --------


def frontend_teacher(label, model, params, toks, ee, f32):
    """Prefill + 4 decode steps against one full forward, both with the
    stub frontend's ``ee`` (the full forward with the patches the prefill
    placed); f32 within TOL_TEACHER, bf16 within
    TOL_BF16_LOGITS of the logits' largest magnitude.  Returns (error,
    limit)."""
    cfg = model.cfg
    # decode steps add no patches: the full forward gets the patches the
    # prefill placed (the first PROMPT), not patches over the decoded
    # positions too (whisper's frames feed the encoder either way)
    full_ee = ee[:, :PROMPT] if cfg.frontend == "image_patches" else ee
    with torch.no_grad():
        full, _ = model.apply(params, toks, extra_embeds=full_ee)
        cache = model.cache_init(BATCH, PROMPT + GEN + 1)
        pre, _ = model.apply(params, toks[:, :PROMPT], extra_embeds=ee,
                             cache=cache)
        errs = [(pre.float() - full[:, :PROMPT].float()).abs().max().item()]
        for t in range(PROMPT, PROMPT + 4):
            lg, _ = model.apply(params, toks[:, t:t + 1], cache=cache)
            errs.append((lg[:, 0].float() - full[:, t].float()).abs().max()
                        .item())
    check(tuple(full.shape) == (BATCH, PROMPT + 4, cfg.padded_vocab),
          f"{label}: logits shape {tuple(full.shape)}")
    check(bool(torch.isfinite(full).all()), f"{label}: non-finite logits")
    scale = full.float().abs().max().item()
    limit = TOL_TEACHER if f32 else TOL_BF16_LOGITS * scale
    print(f"[frontend] {label}: prefill {PROMPT} + 4 decode steps vs full "
          f"forward, with the stub embeddings: max_abs_diff {max(errs):.3e} "
          f"(limit {limit:.3g}; logits max |x| {scale:.2f})")
    check(max(errs) <= limit, f"{label}: decode drift {errs}")
    return max(errs), limit


def decode_read_params(model):
    """The params a decode step reads: all but the encoder's (the prefill
    ran it) and, of a learned position table, the one row that every
    sequence of the batch is at (an untied embedding table is counted
    whole, as the other phases' bounds count it)."""
    tree = model.param_shapes()
    n = sum(t.numel() for k, t in _flat(tree)
            if not k.startswith(("encoder/", "pos_embed")))
    return n + (tree["pos_embed"].shape[1] if "pos_embed" in tree else 0)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def frontend_run(arch, dtype, dev):
    """One stub-frontend model at full width in ``dtype``, weights from the
    launcher's seed, serving the launcher's prompts with its stub
    embeddings (``launch.serve.stub_embeds``) through ``Engine`` on
    captured decode steps (f32 through ``launch.serve.main`` itself):
    decode_attention's launches (one a decoder layer a step), rates, ms
    per step beside the bytes bound, peak memory; the eager Engine's
    streams; the captured step against the eager one (bit-equal logits,
    idle share); a profiled eager step; prefill + decode against a full
    forward; the decode logits with the kernel against the plain
    versions; for pixtral-12b one B=1 prefill of PIXTRAL_LONG tokens, so
    that every patch lands, against its full forward.  Returns a summary
    dict."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.engine import (Engine, EngineConfig,
                                          throughput_stats)
    from repro_torch.configs.base import get_config
    f32 = dtype == "float32"
    label = f"{arch} {dtype}"
    cfg = get_config(arch)
    # the launcher's prompts and stub embeddings
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    ee = serve.stub_embeds(cfg, BATCH, dev)
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention.launches = 0
    if f32:
        res = serve.main(["--arch", arch, "--batch", str(BATCH),
                          "--prompt-len", str(PROMPT), "--gen", str(GEN)])
        eng = res["engine"]
        model, params = eng.model, eng.params
    else:
        model = Model(cfg, RunConfig(max_seq=PROMPT + GEN + 1, **BF16_RUN),
                      dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        eng = Engine(model, params, EngineConfig(max_len=PROMPT + GEN + 1))
        res = throughput_stats(eng, prompts, GEN, extra_embeds=ee)
    launches, steps = da.decode_attention.launches, res["decode_steps"]
    n = model.param_count()
    read = decode_read_params(model)
    el = 4 if f32 else 2
    cross = (cfg.num_layers * 2 * BATCH * cfg.encoder.context * cfg.num_heads
             * cfg.resolved_head_dim if cfg.encoder is not None else 0)
    bound = (read + cross) * el / HBM_BYTES_PER_S * 1e3
    print(f"[frontend] {label}: {cfg.num_layers} decoder layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}"
          + (f", encoder {cfg.encoder.num_layers} layers over "
             f"{cfg.encoder.context} stub frames" if cfg.encoder else
             f", {cfg.frontend_len} stub patches") +
          f"; {n:,} params; decode_attention launches {launches} = "
          f"{cfg.num_layers} layers x {steps} decode steps")
    check(steps == GEN, f"{label}: {steps} decode steps, expected {GEN}")
    check(launches == cfg.num_layers * steps,
          f"{label}: decode_attention launched {launches} times, expected "
          f"{cfg.num_layers} x {steps}")
    warm = throughput_stats(eng, prompts, GEN, extra_embeds=ee)
    step_ms = warm["decode_s"] / GEN * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[frontend] {label} warm rerun (captured decode steps): prefill "
          f"{warm['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{warm['decode_tok_per_s']:.1f} tok/s ({step_ms:.3f} ms/step; "
          f"bound {bound:.3f} ms = {read:,} params a step reads"
          + (f" (of {n:,})" if read != n else "")
          + (f" + {cross:,} cross K/V elements" if cross else "") +
          f" x {el} bytes at 3.35 TB/s, {step_ms / bound:.2f}x it), peak "
          f"memory {peak:.1f} GiB")
    eager_warm = engines_agree(f"frontend {label}", model, params, prompts,
                               eng, extra_embeds=ee)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + 4)).astype(np.int64)).to(dev)
    rows = graph_vs_eager(label, model, params,
                          *prefilled(model, params, toks, ee), bound,
                          lambda scale: 0.0)
    with torch.no_grad():
        serving_profile(f"{label} eager decode step",
                        engine_step(eng, toks, ee), 4, bound,
                        eager_warm["decode_s"] / GEN * 1e3)
    del eng
    teacher = frontend_teacher(label, model, params, toks, ee, f32)
    plain = Model(cfg, RunConfig(backend="torch", max_seq=model.run.max_seq,
                                 param_dtype=dtype, cache_dtype=dtype), dev)
    with torch.no_grad():
        cache, nxt = prefilled(model, params, toks, ee)
        twin = clone(cache)
        got, _ = model.apply(params, nxt, cache=cache)
        want, _ = plain.apply(params, nxt, cache=twin)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    limit = TOL_BACKENDS if f32 else TOL_BF16_LOGITS * scale
    print(f"[backends] {label} decode logits, cuda vs torch: max_abs_diff "
          f"{err:.3e} (limit {limit:.3g}; logits max |x| {scale:.2f})")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    check(err <= limit, f"{label}: backends differ by {err}")
    del cache, twin, got, want
    if cfg.frontend == "image_patches":
        long_prefill(label, model, params, f32, dev)
    out = {"label": label, "arch": arch, "dtype": dtype, "params": n,
           "launches": launches,
           "prefill_tok_per_s": warm["prefill_tok_per_s"],
           "decode_tok_per_s": warm["decode_tok_per_s"], "ms": step_ms,
           "bound_ms": bound, "peak_gib": peak,
           "captured_idle": max(0.0, 1 - rows["captured"]["busy"] /
                                rows["captured"]["ms"]),
           "teacher": teacher}
    del model, params, plain, res
    torch.cuda.empty_cache()
    return out


def long_prefill(label, model, params, f32, dev):
    """One B=1 prefill of PIXTRAL_LONG tokens with all frontend_len stub
    patches in place, against one full forward of the same tokens (last
    position's logits)."""
    from repro_torch.launch import serve
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, PIXTRAL_LONG)).astype(np.int64)).to(dev)
    ee = serve.stub_embeds(cfg, 1, dev)
    with torch.no_grad():
        cache = model.cache_init(1, PIXTRAL_LONG + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre, _ = model.apply(params, toks, extra_embeds=ee, cache=cache)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        full, _ = model.apply(params, toks, extra_embeds=ee)
    scale = full[:, -1].float().abs().max().item()
    err = (pre[:, -1].float() - full[:, -1].float()).abs().max().item()
    limit = TOL_TEACHER if f32 else TOL_BF16_LOGITS * scale
    print(f"[frontend] {label} B=1 prefill of {PIXTRAL_LONG} tokens, all "
          f"{cfg.frontend_len} patches in place: {dt * 1e3:.1f} ms "
          f"({PIXTRAL_LONG / dt:.1f} tok/s); last position vs one full "
          f"forward max_abs_diff {err:.3e} (limit {limit:.3g})")
    check(cache["len"] == PIXTRAL_LONG, f"{label}: cache len {cache['len']}")
    check(bool(torch.isfinite(pre).all()), f"{label}: non-finite logits")
    check(err <= limit, f"{label}: long prefill off by {err}")


def frontend_phase(dev, flush, smi):
    """Phase 6e: every run of FRONTEND_RUNS (``frontend_run``), one model
    at a time; then decode_attention at whisper-base's and pixtral-12b's
    decode shapes, f32 and bf16, held to the plain version and timed, with
    the launches of their runs.  Returns the JSON rows."""
    from repro_torch.kernels import decode_attention as da
    runs = [frontend_run(arch, dtype, dev) for arch in FRONTEND_RUNS
            for dtype in ("float32", "bfloat16")]
    print("[frontend] summary: run | ms/step | bound ms | x bound | decode "
          "tok/s | prefill tok/s | captured idle | peak GiB")
    for r in runs:
        print(f"[frontend]   {r['label']} | {r['ms']:.3f} | "
              f"{r['bound_ms']:.3f} | {r['ms'] / r['bound_ms']:.2f} | "
              f"{r['decode_tok_per_s']:.1f} | {r['prefill_tok_per_s']:.1f} |"
              f" {r['captured_idle']:.1%} | {r['peak_gib']:.1f}; card {smi}")
    rows = []
    for r in runs:
        KV, rep, hd = FRONTEND_DECODE[r["arch"]]
        dtype = getattr(torch, r["dtype"])
        rng = np.random.default_rng(7)
        smax = PROMPT + GEN + 1
        q = torch.from_numpy(rng.standard_normal((BATCH, KV, rep, hd))).to(
            dev, dtype)
        cache = torch.from_numpy(rng.standard_normal(
            (2, BATCH, smax, KV, hd))).to(dev, dtype)
        k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        valid = torch.tensor([0, 1, 129, 161], dtype=torch.int32,
                             device=dev)
        err = (da.decode_attention(q, k, v, valid).float()
               - da.decode_attention_ref(q, k, v, valid).float()
               ).abs().max().item()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        print(f"[kernel] decode_attention {r['dtype']} at {r['arch']}'s "
              f"decode shapes (KV {KV}, rep {rep}, hd {hd}) valid "
              f"{valid.tolist()}: max_abs_err {err:.3e} (limit {tol:g})")
        check(err <= tol, f"decode_attention at {r['label']}: {err}")
        rows.append(decode_row(
            f"decode_attention [{r['label']} serving]", (q, k, v, valid),
            161, r["launches"], err, flush, smi,
            lib_tol=TOL_LIBRARY if dtype == torch.float32 else TOL_BF16))
    return rows


# ---- phase 13: training, minicpm-2b whole ------------------------------


def recorded_grads(model, params, batch, microbatches=1):
    """(loss, gradient leaves) of one train step of ``model`` on ``batch``
    (``microbatches`` slices), through ``make_train_step`` with an
    optimizer that only records the gradients it is given."""
    from repro_torch.optim.optimizer import Optimizer, OptState, tree_leaves
    from repro_torch.train.step import (TrainConfig, TrainState, new_rng,
                                        make_train_step)
    seen = {}

    def update(grads, state, p):
        seen["grads"] = tree_leaves(grads)
        return p, state, {}
    rec = Optimizer(init=lambda p: OptState(torch.zeros((), dtype=torch.int32),
                                            {}, ()), update=update)
    fn = make_train_step(model, rec, TrainConfig(microbatches))
    _, metrics = fn(TrainState(params, rec.init(params), new_rng(0, 1)), batch)
    return metrics["loss"].item(), seen["grads"]


def grads_agree(label, a, b, tol):
    """Two (loss, gradient leaves) within ``tol`` relative: the loss, and
    each leaf's largest difference against its largest magnitude."""
    (la, ga), (lb, gb) = a, b
    loss_err = abs(la - lb) / abs(la)
    worst = max((x - y).abs().max().item() / max(x.abs().max().item(), 1e-30)
                for x, y in zip(ga, gb))
    print(f"[train] {label}: loss {la:.6f} vs {lb:.6f} (relative "
          f"{loss_err:.2e}); gradients, worst leaf's max |diff| / max |g| "
          f"{worst:.2e} over {len(ga)} leaves (limit {tol:g})")
    check(loss_err <= tol and worst <= tol, f"{label}: off by "
          f"{loss_err} / {worst}")


def train_losses(model, opt, state, pipe, steps, start=0):
    """Run ``steps`` train steps from ``state`` on the pipeline's batches
    ``start``..; returns (state, losses)."""
    from repro_torch.train.step import make_train_step
    fn = make_train_step(model, opt)
    dev = model.device
    losses = []
    for i in range(start, start + steps):
        state, metrics = fn(state, pipe.torch_batch(i, dev))
        losses.append(metrics["loss"].item())
    return state, losses


def train_phase(dev, smi):
    """Phase 13: minicpm-2b whole, f32, through ``launch.train.main``
    (TRAIN_STEPS steps of global batch TRAIN_BATCH x TRAIN_SEQ, the
    launcher's WSD schedule and AdamW, remat full): finite losses, the last
    below the first; step ms, tokens/s, peak memory, model FLOPs a step
    against the f32 peak.  Then at full width cut to TRAIN_CUT layers:
    microbatches 2 against the full batch, remat none / full / dots,
    save + restore + 2 steps against an uninterrupted run (bit-equal
    losses), and the first three losses against the port's own CPU run
    from the same params and batches."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim import schedule as sched
    from repro_torch.optim.optimizer import adamw
    from repro_torch.train.step import (TrainState, new_rng, init_state,
                                        make_train_step)

    torch.cuda.reset_peak_memory_stats()
    res = train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                      "--seq-len", str(TRAIN_SEQ), "--global-batch",
                      str(TRAIN_BATCH), "--remat", "full"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = res["model"].cfg
    n = res["model"].param_count()
    hist = res["trainer"].metrics_history
    losses = [h["loss"] for h in hist]
    ms = [h["step_time_s"] * 1e3 for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = sum(ms[1:]) / len(ms[1:])
    flops = (6 * n * tokens + 12 * cfg.num_layers * cfg.num_heads
             * cfg.resolved_head_dim * TRAIN_SEQ * tokens)
    print(f"[train] {cfg.name}: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads} hd {cfg.resolved_head_dim} "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab_size} tied, {n:,} params, f32, "
          f"remat full, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, WSD peak 3e-3, AdamW")
    print(f"[train] losses: {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"[train] step ms: {', '.join(f'{x:.1f}' for x in ms)} (the first "
          f"builds the allocator's pools); steps 2-{TRAIN_STEPS}: "
          f"{warm:.1f} ms, {tokens / warm * 1e3:.1f} tokens/s; peak memory "
          f"{peak:.1f} GiB; model FLOPs a step {flops / 1e12:.2f} T (6 x "
          f"params x tokens + 12 x layers x heads x hd x seq x tokens; "
          f"remat's recompute not counted) = {flops / (warm / 1e3) / 1e12:.1f}"
          f" TFLOP/s, {flops / (warm / 1e3) / F32_FLOP_PER_S:.1%} of the "
          f"67 TFLOP/s f32 peak (TF32 off); card {smi}")
    check(len(losses) == TRAIN_STEPS, f"train: {len(losses)} steps")
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss rose {losses}")
    out = {"losses": losses, "ms": warm, "peak_gib": peak, "params": n,
           "tflops": flops / 1e12}
    # where a step's time goes: one more step of the launcher's state,
    # profiled
    model = res["model"]
    fn = make_train_step(model, adamw(sched.make(
        "wsd", peak=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS),
        weight_decay=0.01))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=0))
    state = {"s": res["state"]}
    batch = pipe.torch_batch(TRAIN_STEPS, dev)

    def step():
        state["s"], metrics = fn(state["s"], batch)
        metrics["loss"].item()
    busy, window, krows, _ = profile_steps(step, 1)
    if busy is None:
        print("[train] profiled step: device time not measured (the "
              "profiler recorded no device time)")
    else:
        products = sum(ms for ms, _, name in krows if any(
            k in name for k in PRODUCT_KERNELS))
        print(f"[train] profiled step: device busy {busy:.1f} ms of "
              f"{window:.1f} ms wall (idle share {1 - busy / window:.1%}); "
              f"products (cuBLAS / CUTLASS GEMMs) {products:.1f} ms, the "
              f"rest {busy - products:.1f} ms over "
              f"{sum(r[1] for r in krows)} kernels")
        for ms, k, name in krows[:10]:
            print(f"[train]   {ms:9.2f} ms  {k:5d} launches  {name[:90]}")
        out["idle"] = 1 - busy / window
    del res, hist, state, fn
    torch.cuda.empty_cache()

    cut = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_CUT)

    def model_of(remat="none", device=dev):
        return Model(cut, RunConfig(max_seq=TRAIN_SEQ, remat=remat), device)

    params = model_of().init(torch.Generator(device=dev).manual_seed(0))
    pipe = Pipeline(DataConfig(vocab_size=cut.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=0))
    batch = pipe.torch_batch(0, dev)
    base = recorded_grads(model_of(), params, batch)
    grads_agree(f"{TRAIN_CUT} layers, microbatches 2 vs the full batch",
                base, recorded_grads(model_of(), params, batch, 2), 1e-5)
    for remat in ("full", "dots"):
        grads_agree(f"{TRAIN_CUT} layers, remat {remat} vs none", base,
                    recorded_grads(model_of(remat), params, batch), 1e-6)
    del base, params
    torch.cuda.empty_cache()

    model = model_of()
    opt = adamw(sched.make("wsd", peak=3e-3, warmup_steps=1, total_steps=4),
                weight_decay=0.01)
    _, straight = train_losses(
        model, opt, init_state(model, opt,
                               torch.Generator(device=dev).manual_seed(0)),
        pipe, 4)
    torch.cuda.empty_cache()
    state, first = train_losses(
        model, opt, init_state(model, opt,
                               torch.Generator(device=dev).manual_seed(0)),
        pipe, 2)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, state)
        del state
        torch.cuda.empty_cache()
        fresh = init_state(model, opt,
                           torch.Generator(device=dev).manual_seed(1))
        state, extra = ckpt.restore(d, target=fresh)
    _, rest = train_losses(model, opt, state, pipe, 2, start=extra["step"])
    resumed = first + rest
    print(f"[train] {TRAIN_CUT} layers: 4 steps straight "
          f"{[f'{x:.6f}' for x in straight]}; 2 + save, restore into a "
          f"fresh state, 2: {[f'{x:.6f}' for x in resumed]} "
          f"({'bit-equal' if resumed == straight else 'NOT bit-equal'})")
    check(resumed == straight, f"train: resumed losses {resumed} against "
          f"{straight}")
    del state, fresh
    torch.cuda.empty_cache()

    # card against CPU: the same params (drawn on the card) and batches
    small = Pipeline(DataConfig(vocab_size=cut.vocab_size,
                                seq_len=TRAIN_SMALL[1],
                                global_batch=TRAIN_SMALL[0], seed=0))
    runs = {}
    for device in (dev, torch.device("cpu")):
        drawn = model_of().init(torch.Generator(device=dev).manual_seed(0))
        params = _to(drawn, device)
        del drawn
        state = TrainState(params, opt.init(params), new_rng(0, 1))
        _, runs[device.type] = train_losses(model_of(device=device), opt,
                                            state, small, 3)
        del state, params
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    print(f"[train] {TRAIN_CUT} layers, batch {TRAIN_SMALL[0]} x "
          f"{TRAIN_SMALL[1]}: card losses "
          f"{[f'{x:.6f}' for x in runs['cuda']]}, CPU "
          f"{[f'{x:.6f}' for x in runs['cpu']]}: relative {rel:.2e} "
          f"(limit 1e-4)")
    check(rel <= 1e-4, f"train: card against CPU {rel}")
    torch.cuda.empty_cache()
    return out


# ---- phase 14: the distribution layer on a (1, 1) NCCL mesh -------------


def dist_gemm_products(m, n, k):
    """The emitted GEMMs a rank of sharded_gemm_op runs for its (m, n, k)
    rows (forward and both backward products, f32 and bf16), compiled
    ahead so that they are built at once: phase 14b's at DIST_GEMM, built
    in phase 2 with the rest; --launcher-cards' a card's rows."""
    from repro_torch.core import integrate
    return [integrate._compiled(a, b, c, "tpu_mxu", "cuda", dt)
            for dt in ("float32", "bfloat16")
            for a, b, c in ((m, n, k), (m, k, n), (k, n, m))]


def dist_train(dev, smi, p13):
    """14a: minicpm-2b whole through ``launch.train.main(--mesh host)``
    with phase 13's settings, on the 1-rank NCCL (1, 1) mesh with DTensor
    params, moments and batches: the losses against phase 13's, ms a step,
    tokens/s, the model-FLOP share, peak memory and a profiled step's idle
    share beside phase 13's.  Returns the mesh."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed.sharding import axis_rules, sharding_for
    from repro_torch.launch import train
    from repro_torch.optim import schedule as sched
    from repro_torch.optim.optimizer import adamw, tree_leaves
    from repro_torch.train.step import make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                      "--seq-len", str(TRAIN_SEQ), "--global-batch",
                      str(TRAIN_BATCH), "--remat", "full", "--mesh", "host"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    mesh, model = res["mesh"], res["model"]
    leaf = tree_leaves(res["state"].params)[0]
    hist = res["trainer"].metrics_history
    losses = [h["loss"] for h in hist]
    ms = [h["step_time_s"] * 1e3 for h in hist]
    warm = sum(ms[1:]) / len(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, p13["losses"]))
    same = losses == p13["losses"]
    print(f"[dist] 14a {TRAIN_ARCH} whole through launch.train --mesh host:"
          f" mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"({torch.distributed.get_backend()}, "
          f"{torch.distributed.get_world_size()} rank), params as DTensors "
          f"{type(leaf).__name__} {tuple(leaf.placements)}; phase 13's "
          f"settings: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, f32, WSD peak 3e-3, remat full, seed 0; {wall:.1f} s "
          f"in all")
    print(f"[dist] 14a losses: {', '.join(f'{x:.6f}' for x in losses)}; "
          f"against phase 13's: {'bit-equal' if same else 'NOT bit-equal'},"
          f" worst relative {rel:.2e} (limit 1e-6)")
    check(len(losses) == TRAIN_STEPS and rel <= 1e-6,
          f"14a: losses {losses} against phase 13's {p13['losses']}")
    flops = p13["tflops"] * 1e12
    print(f"[dist] 14a step ms: {', '.join(f'{x:.1f}' for x in ms)} (the "
          f"first propagates every op's shardings once); steps 2-"
          f"{TRAIN_STEPS}: {warm:.1f} ms ({p13['ms']:.1f} in phase 13), "
          f"{tokens / warm * 1e3:.1f} tokens/s ("
          f"{tokens / p13['ms'] * 1e3:.1f}), {flops / (warm / 1e3) / 1e12:.1f}"
          f" TFLOP/s = {flops / (warm / 1e3) / F32_FLOP_PER_S:.1%} of the 67 "
          f"TFLOP/s f32 peak ({flops / (p13['ms'] / 1e3) / F32_FLOP_PER_S:.1%}"
          f"); peak memory {peak:.1f} GiB ({p13['peak_gib']:.1f}); card {smi}")
    check(peak <= p13["peak_gib"] + 2.0, f"14a: peak {peak:.1f} GiB against "
          f"phase 13's {p13['peak_gib']:.1f} + 2")

    fn = make_train_step(model, adamw(sched.make(
        "wsd", peak=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS),
        weight_decay=0.01))
    pipe = Pipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                               seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               seed=0))
    state = {"s": res["state"]}
    with axis_rules(mesh):
        batch = pipe.torch_batch(TRAIN_STEPS, dev, sharding_for(
            "batch -", (TRAIN_BATCH, TRAIN_SEQ), mesh))

        def step():
            state["s"], metrics = fn(state["s"], batch)
            metrics["loss"].item()
        busy, window, krows, calls = profile_steps(step, 1)
    if busy is None:
        print("[dist] 14a profiled step: device time not measured (the "
              "profiler recorded no device time)")
    else:
        idle = 1 - busy / window
        print(f"[dist] 14a profiled step: device busy {busy:.1f} ms of "
              f"{window:.1f} ms wall, idle share {idle:.1%} (phase 13: "
              f"{p13.get('idle', float('nan')):.1%}); "
              f"{sum(r[1] for r in krows)} kernels, {calls:.0f} host launch "
              f"calls; card {smi}")
    del res, state, fn, batch
    torch.cuda.empty_cache()
    return mesh


def dist_gemm(mesh, dev, flush, smi):
    """14b: sharded_gemm_op at qwen2-7b's up product on the (1, 1) mesh,
    backend "cuda", f32 and bf16: one forward and backward with the
    counts reset (3 launches of the emitted GEMM), the output and both
    gradients bit-equal to gemm_op's; then ms a call against gemm_op's,
    the plain version, the library calls (``library_times``) and row 1's
    bound.  Returns the JSON rows."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core import backend_cuda, integrate
    from repro_torch.kernels import gemm
    m, n, k = DIST_GEMM
    cg = gemm.cuda_gemm
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        gen = torch.Generator(device=dev).manual_seed(0)
        a, b, w = (torch.randn(s, generator=gen, device=dev)
                   for s in ((m, k), (k, n), (m, n)))
        a, b = a.to(dtype), b.to(dtype)
        op = integrate.sharded_gemm_op(mesh, m, n, k, backend="cuda")
        ref = integrate.gemm_op(m, n, k, backend="cuda")
        da = distribute_tensor(a, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        db = distribute_tensor(b, mesh, [Replicate(), Replicate()],
                               src_data_rank=None)
        dw = distribute_tensor(w, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        ga, gb = da.detach().requires_grad_(), db.detach().requires_grad_()
        cg.launches = cg.wgmma_launches = cg.ffma_launches = 0
        out = op(ga, gb)
        (out * dw).sum().backward()
        torch.cuda.synchronize()
        launches = cg.launches
        path = route_of(cg, (0, 0))
        ra, rb = a.clone().requires_grad_(), b.clone().requires_grad_()
        want = ref(ra, rb)
        (want * w).sum().backward()
        same = (torch.equal(out.full_tensor(), want)
                and torch.equal(ga.grad.full_tensor(), ra.grad)
                and torch.equal(gb.grad.full_tensor(), rb.grad))
        plan = integrate._compiled(m, n, k, "tpu_mxu", "cuda", dt).plan
        plain = backend_cuda.gemm_plain(plan, a, b)
        err = (out.full_tensor().float() - plain.float()).abs().max().item()
        print(f"[dist] 14b sharded_gemm_op {m}x{n}x{k} {dt} on the (1, 1) "
              f"mesh: out {tuple(out.placements)}; forward + backward "
              f"launched the emitted GEMM {launches} times ({path} route); "
              f"output and both gradients "
              f"{'bit-equal' if same else 'NOT bit-equal'} to gemm_op's; "
              f"max_abs_err {err:.3e} vs gemm_plain")
        check(launches == 3, f"14b {dt}: {launches} launches, expected 3")
        check(same, f"14b {dt}: sharded_gemm_op differs from gemm_op")
        with torch.no_grad():
            bound, bound_by = gemm_bound(plan, m, n, k)
            r = {"name": f"sharded_gemm_op up {dt} (1, 1) mesh [{path}]",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" +
                 GEMM_SOURCE[path],
                 "replaces": "src/repro/core/backend_pallas.py:229",
                 "launches": launches, "max_abs_err": err,
                 "ms": time_ms(lambda: op(da, db), flush, iters=20),
                 "plain_ms": time_ms(
                     lambda: backend_cuda.gemm_plain(plan, a, b), flush,
                     iters=20),
                 "bound_ms": bound, "bound_by": bound_by}
            r["library_ms"], lib = library_times(plan, a, b, want.detach(),
                                                flush)
            ref_ms = time_ms(lambda: ref(a, b), flush, iters=20)
        print(f"[timing] {r['name']}, cold L2: {r['ms']:.3f} ms a call "
              f"(gemm_op {ref_ms:.3f} ms; the DTensor / local_map wrapper "
              f"{r['ms'] - ref_ms:+.3f}), bound {bound:.3f} ms ({bound_by}),"
              f" gemm_plain {r['plain_ms']:.3f} ms, {lib}; card {smi}")
        rows.append(r)
        del a, b, w, da, db, dw, ga, gb, ra, rb, out, want, plain
    torch.cuda.empty_cache()
    return rows


def dist_moe(mesh, dev, smi):
    """14c: deepseek-v2-236b at full width cut to 2 layers (the dense
    prefix and one MoE layer with all 160 experts), params as DTensors on
    the (1, 1) mesh, a prefill of BATCH x PROMPT tokens into a DTensor
    cache with set_moe_impl("shardmap") against "gspmd", f32 and bf16, at
    capacity factor DIST_MOE_CF (neither path drops a token): the logits
    held to phase 6d's gates, re-routed near-tie positions held apart
    (``routed_compare``)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  full, sharding_for)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    cfg = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DIST_MOE_CF))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64)).to(dev)
    for dtype in ("float32", "bfloat16"):
        f32 = dtype == "float32"
        model = Model(cfg, RunConfig(param_dtype=dtype, cache_dtype=dtype),
                      dev)
        logits, routes, ms = {}, {}, {}
        with axis_rules(mesh), torch.no_grad():
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                mesh=mesh)
            dtoks = distribute(toks, sharding_for("batch -", toks.shape,
                                                  mesh))
            for impl in ("shardmap", "gspmd"):
                moe.set_moe_impl(impl)
                try:
                    check(moe._can_shardmap(cfg, BATCH * PROMPT)
                          == (impl == "shardmap"),
                          f"14c: {impl} not taken")
                    cache = model.cache_init(BATCH, PROMPT, mesh=mesh)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with RouterLog() as log:
                        lg, cache = model.apply(params, dtoks, cache=cache)
                    logits[impl] = full(lg)
                    torch.cuda.synchronize()
                    ms[impl] = (time.perf_counter() - t0) * 1e3
                    routes[impl] = log.per_layer(1)
                    check(cache["len"] == PROMPT, f"14c: cache len "
                          f"{cache['len']}")
                finally:
                    moe.set_moe_impl("auto")
                del cache, lg
        del params
        got = logits["shardmap"]
        check(tuple(got.shape) == (BATCH, PROMPT, cfg.padded_vocab) and
              bool(torch.isfinite(got).all()), "14c: logits")
        limit_of = ((lambda scale: TOL_TEACHER) if f32 else
                    (lambda scale: TOL_BF16_LOGITS * scale))
        print(f"[dist] 14c deepseek-v2-236b 2 layers {dtype}, capacity "
              f"factor {DIST_MOE_CF:g} (no token dropped on either path), "
              f"prefill {BATCH} x {PROMPT} on the (1, 1) mesh: shardmap "
              f"{ms['shardmap']:.1f} ms, gspmd {ms['gspmd']:.1f} ms (one "
              f"call each, first of its kind); card {smi}")
        routed_compare(f"14c deepseek-v2 2L {dtype} shardmap vs gspmd "
                       f"(logits max |x| "
                       f"{logits['gspmd'].abs().max().item():.2f})",
                       got, logits["gspmd"], routes["shardmap"],
                       routes["gspmd"], cfg.moe.top_k, limit_of)
        del logits, routes
        torch.cuda.empty_cache()


def dist_compress(mesh, dev, smi):
    """14d: error_feedback_update and make_compressed_allreduce(mesh,
    "data") over one gradient-shaped tree of minicpm-2b (every param's
    shape, N(0, 1e-3) values and a N(0, 1e-5) residual from seed 0) on the
    card (1-rank NCCL): ms a tree each; then leaf by leaf the same
    functions on CPU copies, the reduction over a 1-rank gloo group:
    bit-equal."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import compression as C
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import tree_leaves
    shapes = Model(get_config(TRAIN_ARCH), device="meta").param_shapes()
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen, device=dev).mul_(scale)
                for k, v in tree.items()}
    grads, res = draw(shapes, 1e-3), draw(shapes, 1e-5)
    n = sum(t.numel() for t in tree_leaves(grads))
    reduce_tree = C.make_compressed_allreduce(mesh, "data")
    times = {}
    for name, fn in (("error_feedback_update",
                      lambda: C.error_feedback_update(grads, res)),
                     ("compressed all-reduce", lambda: reduce_tree(grads))):
        fn()                                    # warm: allocator, NCCL
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end)
        del out
    gq, r2 = C.error_feedback_update(grads, res)
    red = reduce_tree(gq)
    cpu_mesh = DeviceMesh.from_group(
        torch.distributed.new_group([0], backend="gloo"), "cpu",
        mesh_dim_names=("data",))
    cpu_reduce = C.make_compressed_allreduce(cpu_mesh, "data")
    bad = []
    for path, g, r, q, rr, rd in zip(
            _paths(grads), tree_leaves(grads), tree_leaves(res),
            tree_leaves(gq), tree_leaves(r2), tree_leaves(red)):
        cq, c2 = C.error_feedback_update(g.cpu(), r.cpu())
        cr = cpu_reduce(cq)
        if not (torch.equal(q.cpu(), cq) and torch.equal(rr.cpu(), c2)
                and torch.equal(rd.cpu(), cr)):
            bad.append(path)
        del cq, c2, cr
    gb = n * 4 / 1e9
    print(f"[dist] 14d minicpm-2b gradient-shaped tree ({n:,} f32 values, "
          f"{gb:.1f} GB, {len(tree_leaves(grads))} leaves) on the card: "
          f"error_feedback_update {times['error_feedback_update']:.1f} ms, "
          f"make_compressed_allreduce(mesh, 'data') "
          f"{times['compressed all-reduce']:.1f} ms a tree (1-rank NCCL: "
          f"the int8 payload summed in int32, the count, the MAX scale); "
          f"against the same functions on CPU copies (gloo): "
          f"{'bit-equal' if not bad else 'differs at ' + str(bad)}; "
          f"card {smi}")
    check(not bad, f"14d: card differs from CPU at {bad}")
    del grads, res, gq, r2, red
    torch.cuda.empty_cache()


def _paths(tree, prefix=""):
    """Key paths of a nested dict's leaves, sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + k + "/")
        else:
            yield prefix + k


def dist_failover(mesh, dev, smi):
    """14e: FailoverRunner on minicpm-2b at full width cut to TRAIN_CUT
    layers, state as DTensors on the (1, 1) mesh: a RuntimeError injected
    at the first attempt of each step in DIST_FAIL, a checkpoint every
    DIST_FAIL_EVERY steps, DIST_FAIL_STEPS steps: the final params
    bit-equal to an uninterrupted run's, failures and replayed steps as
    the reference's state machine gives them (a failed step restores the
    last checkpoint and replays the steps since)."""
    import dataclasses
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed.fault_tolerance import (FailoverConfig,
                                                         FailoverRunner)
    from repro_torch.distributed.sharding import axis_rules, full, \
        sharding_for
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim import schedule as sched
    from repro_torch.optim.optimizer import adamw, tree_leaves
    from repro_torch.train.step import init_state_sharded, make_train_step
    cut = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_CUT)
    model = Model(cut, RunConfig(max_seq=TRAIN_SEQ), dev)
    opt = adamw(sched.make("wsd", peak=3e-3, warmup_steps=1,
                           total_steps=DIST_FAIL_STEPS), weight_decay=0.01)
    step = make_train_step(model, opt)
    pipe = Pipeline(DataConfig(vocab_size=cut.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=0))
    t0 = time.perf_counter()
    with axis_rules(mesh):
        sh = sharding_for("batch -", (TRAIN_BATCH, TRAIN_SEQ), mesh)

        def fresh():
            return init_state_sharded(
                model, opt, torch.Generator(device=dev).manual_seed(0), mesh)
        ref = fresh()
        for i in range(DIST_FAIL_STEPS):
            ref, _ = step(ref, pipe.torch_batch(i, dev, sh))
        want = [full(x).cpu() for x in tree_leaves(ref.params)]
        del ref
        torch.cuda.empty_cache()

        at, failed = {"step": None}, set()

        def batch_fn(i):
            at["step"] = i
            return pipe.torch_batch(i, dev, sh)

        def flaky(state, batch):
            i = at["step"]
            if i in DIST_FAIL and i not in failed:
                failed.add(i)
                raise RuntimeError(f"injected chip failure at step {i}")
            return step(state, batch)
        logs = []
        with tempfile.TemporaryDirectory() as d:
            runner = FailoverRunner(
                FailoverConfig(checkpoint_dir=d,
                               checkpoint_every=DIST_FAIL_EVERY),
                flaky, batch_fn, log_fn=logs.append)
            final, end = runner.run(fresh(), 0, DIST_FAIL_STEPS)
        got = [full(x).cpu() for x in tree_leaves(final.params)]
    expect = sum(s - s // DIST_FAIL_EVERY * DIST_FAIL_EVERY
                 for s in DIST_FAIL)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"[dist] 14e FailoverRunner, {TRAIN_ARCH} {TRAIN_CUT} layers on "
          f"the (1, 1) mesh, {DIST_FAIL_STEPS} steps, a checkpoint every "
          f"{DIST_FAIL_EVERY}, failures injected at steps {DIST_FAIL}: ended"
          f" at step {end}, {runner.failures} failures, "
          f"{runner.replayed_steps} replayed steps (the state machine's: "
          f"{expect}); final params "
          f"{'bit-equal' if same else 'NOT bit-equal'} to the uninterrupted"
          f" run's; {time.perf_counter() - t0:.1f} s; card {smi}")
    for line in logs:
        print(f"[dist]   {line}")
    check(end == DIST_FAIL_STEPS and runner.failures == len(DIST_FAIL)
          and runner.replayed_steps == expect and same,
          f"14e: end {end}, failures {runner.failures}, replayed "
          f"{runner.replayed_steps}, bit-equal {same}")
    del final, got, want
    torch.cuda.empty_cache()


def dist_dryrun():
    """14f: launch.dryrun in this process on a fake process group (host
    only, meta DTensors: nothing allocated): qwen2-7b train_4k on 16 x 16,
    and kimi-k2-1t train_4k's state bytes per device on 16 x 16 and
    2 x 16 x 16 against the reference's pspec arithmetic's ranges."""
    from repro_torch.launch import dryrun
    rec = dryrun.dryrun_cell("qwen2-7b", "train_4k", False)
    r, c = rec["roofline"], rec["collectives"]
    print(f"[dist] 14f dry run qwen2-7b train_4k on the 16 x 16 fake group "
          f"(host only, meta tensors, plain attention; trace "
          f"{rec['trace_s']} s): per device {r['flops_per_device']:.4g} FLOP, "
          f"{r['hbm_bytes_per_device']:.4g} bytes, collectives "
          f"{c['counts']} = {c['total_bytes']:.4g} bytes on the wire; state "
          f"{rec['state_bytes_per_device']:,} bytes a device")
    print(f"[dist] 14f priced on {r['peaks']} (a model, not a timing): "
          f"compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
          f"collective {r['collective_s']:.4f} s a step; bottleneck "
          f"{r['bottleneck']}, useful FLOP ratio {r['useful_ratio']:.3f}")
    check(r["flops_per_device"] > 0 and c["total_bytes"] > 0,
          "14f: empty trace")
    one, two = (dryrun.state_bytes("kimi-k2-1t", mp) for mp in (False, True))
    print(f"[dist] 14f kimi-k2-1t train_4k state: {one:,} bytes a device on "
          f"16 x 16 (15-17.5 GB), {two:,} on 2 x 16 x 16 (under 10 GB)")
    check(15e9 < one < 17.5e9 and two < 10e9, f"14f: kimi {one} / {two}")
    torch.distributed.destroy_process_group()


def rank_cfg(arch):
    """14g's reduced config of ``arch``: deepseek-v2's MoE with 8 experts
    at DIST_MOE_CF, at which no path drops a token."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    cfg = reduced(get_config(arch))
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DIST_MOE_CF, num_experts=8))


def rank_steps(cfg, params, batches, mesh=None):
    """DIST_RANK_STEPS SGD steps of ``cfg`` from numpy ``params``, one a
    numpy batch, on ``mesh`` (DTensor params, moments and batches placed
    by their logical axes) or with none: the losses, the final params as
    numpy, and whether the MoE took the expert-parallel path."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  sharding_for, tree_map_axes)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import sgd
    from repro_torch.train.step import TrainState, make_train_step, new_rng
    model = Model(cfg, RunConfig(max_seq=64), device="cpu")
    opt = sgd(lambda s: torch.tensor(DIST_RANK_LR))

    def place(axes, a):
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
        return t if mesh is None else distribute(t, sharding_for(
            axes, a.shape, mesh))

    with axis_rules(mesh):
        state = tree_map_axes(place, model.param_axes(), params)
        state = TrainState(state, opt.init(state), new_rng(0, 1))
        fn = make_train_step(model, opt)
        losses = []
        for b in batches:
            state, metrics = fn(state, {k: place("batch -", v)
                                        for k, v in b.items()})
            losses.append(float(metrics["loss"]))
        tokens = batches[0]["tokens"].size
        ep = cfg.moe is not None and moe._can_shardmap(cfg, tokens)
        return {"losses": losses, "params": tree_numpy(state.params),
                "ep": ep}


def rank_gemm(a, b, w, mesh=None):
    """sharded_gemm_op at DIST_RANK_GEMM on ``mesh`` (the lhs and ``w``
    Shard(0) over data, the rhs replicated), or gemm_op with none: the
    output and both gradients as numpy."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core import integrate
    m, n, k = DIST_RANK_GEMM
    a, b, w = (torch.from_numpy(x) for x in (a, b, w))
    if mesh is not None:
        rows, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
        a, w = (distribute_tensor(x, mesh, rows, src_data_rank=None)
                for x in (a, w))
        b = distribute_tensor(b, mesh, rep, src_data_rank=None)
        op = integrate.sharded_gemm_op(mesh, m, n, k)
    else:
        op = integrate.gemm_op(m, n, k)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = op(a, b)
    (out * w).sum().backward()
    whole = [x.full_tensor() if mesh is not None else x
             for x in (out.detach(), a.grad, b.grad)]
    return dict(zip(("out", "ga", "gb"), (x.numpy() for x in whole)))


def mesh_rank(rank, world, tmp):
    """14g's body in each gloo CPU rank (``chip_smoke.py --mesh-rank RANK
    TMP``, a FileStore under ``tmp``): the training of each
    DIST_RANK_ARCHS config and the sharded GEMM on a DIST_RANK_MESH mesh;
    each rank's results and seconds pickled under ``tmp``.  Its stdout
    goes to a file there."""
    import datetime
    import pickle
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    sys.stdout = open(os.path.join(tmp, f"stdout{rank}.txt"), "w")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT))
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            p = pickle.load(f)
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(DIST_RANK_MESH),
                          mesh_dim_names=("data", "model"))
        out = {}
        for arch in DIST_RANK_ARCHS:
            t = time.perf_counter()
            out[arch] = rank_steps(rank_cfg(arch), p[arch]["params"],
                                   p[arch]["batches"], mesh)
            out[arch]["s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["gemm"] = rank_gemm(*p["gemm"], mesh)
        out["gemm"]["s"] = time.perf_counter() - t
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def worst_share(got, want, tol):
    """The worst leaf's largest difference over ``tol`` times its own
    largest magnitude (1 is the bound), over two trees of numpy arrays."""
    if isinstance(want, dict):
        return max(worst_share(got[k], want[k], tol) for k in want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / (tol * scale)


def torchrun(ranks, logs, args, cpu=False, env=None):
    """``args`` (a module's or this script's) in ``ranks`` processes
    under torchrun, each rank's output in files under ``logs``: gloo CPU
    ranks with no card visible for ``cpu``, else NCCL ranks with a card
    each; ``env`` adds to the environment.  Returns torchrun's
    process."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT / "src"), os.environ.get("PYTHONPATH")))))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "--log-dir", logs, "--redirects",
         "3", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_launcher(ranks, device, logs, args=DIST_RANK_LAUNCH):
    """``launch.train --mesh host`` (``args``) in ``ranks`` processes
    under torchrun (``torchrun``)."""
    return torchrun(ranks, logs, ["-m", "repro_torch.launch.train",
                                  *args, "--device", device,
                                  "--mesh", "host"], cpu=device == "cpu")


def rank_outputs(proc, ranks, logs, deadline, what):
    """Wait for ``torchrun``'s process until ``deadline`` (else
    ``subprocess.TimeoutExpired``): each rank's standard output, in rank
    order; fails, printing the ranks' errors, unless all ``ranks`` ended
    well."""
    out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
    files = sorted(pathlib.Path(logs).glob("**/attempt_0/*/stdout.log"),
                   key=lambda f: int(f.parent.name))
    if proc.returncode or len(files) != ranks:
        for f in pathlib.Path(logs).glob("**/stderr.log"):
            out += f"\n{f}:\n{f.read_text()[-2000:]}"
        print(out[-8000:], file=sys.stderr)
        check(False, f"{what}: torchrun exit {proc.returncode}, "
                     f"{len(files)} of {ranks} ranks' output")
    return [f.read_text() for f in files]


def launcher_result(proc, ranks, logs, deadline):
    """Each rank's mesh and losses from its ``[train]`` lines
    (``rank_outputs``), in rank order."""
    got = []
    for r, text in enumerate(rank_outputs(proc, ranks, logs, deadline,
                                          "launcher")):
        mesh = re.search(r"^\[train\] arch=.* mesh=host (\(.*?\))", text,
                         re.M)
        losses = re.search(r"^\[train\] losses: (.*)$", text, re.M)
        check(bool(mesh and losses),
              f"launcher: rank {r} printed no mesh or losses")
        got.append((mesh.group(1), [float(x) for x in
                                    losses.group(1).split()]))
    return got


def plain_launch(device, args=DIST_RANK_LAUNCH):
    """The losses of ``args`` without a mesh, in this process."""
    from repro_torch.launch import train
    res = train.main(args + ["--device", device])
    return [h["loss"] for h in res["trainer"].metrics_history]


def launcher_check(head, got, want, seconds, args=DIST_RANK_LAUNCH):
    """Print and hold ``launcher_result``'s ranks to ``plain_launch``:
    every rank on the (ranks, 1) host mesh, its losses within
    DIST_RANK_TOL relative of the run without a mesh."""
    rel = max((abs(a - b) / abs(b) for _, losses in got
               for a, b in zip(losses, want)), default=math.inf)
    meshes = sorted({m for m, _ in got})
    print(f"{head}: torchrun of launch.train "
          f"{' '.join(args)} --mesh host ({len(got)} "
          f"ranks): mesh {', '.join(meshes)}, losses "
          f"{fmt_losses(got[0][1])} against {fmt_losses(want)} without a "
          f"mesh (worst relative difference {rel:.2e}, bound "
          f"{DIST_RANK_TOL:g}); {seconds:.1f} s")
    check(meshes == [f"({len(got)}, 1)"]
          and all(len(losses) == len(want) > 0 for _, losses in got)
          and rel <= DIST_RANK_TOL, f"launcher: {meshes}, {rel:.2e}")


def stop(proc):
    """End ``proc`` if it still runs (torchrun stops its ranks on
    SIGTERM)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def card_of(index):
    """Card ``index``'s name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()


def cards_config():
    """CARDS_ARCH's config, whole."""
    from repro_torch.configs.base import get_config
    return get_config(CARDS_ARCH)


def cards_batch(step, dev, sharding=None):
    """The launcher's batch of step ``step`` for CARDS_LAUNCH (its
    pipeline, seed 0)."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    return Pipeline(DataConfig(
        vocab_size=cards_config().vocab_size, seq_len=CARDS_SEQ,
        global_batch=CARDS_BATCH, seed=0)).torch_batch(step, dev, sharding)


def one_card_loss(dev):
    """``Model.loss`` of CARDS_LAUNCH's model on one card: a forward of
    the params of its seed (30.5 GB in f32; their gradients and moments
    would not fit) on the batch of its first step."""
    from repro_torch.models.model import Model, RunConfig
    model = Model(cards_config(), RunConfig(max_seq=CARDS_SEQ), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        loss = model.loss(params, cards_batch(0, dev))[0].item()
    del params
    torch.cuda.empty_cache()
    return loss


def returned_partials(res):
    """The leaves whose gradient ``torch.autograd.grad`` returns
    ``Partial`` (whole-size on a rank until the train step reduces it),
    with their bytes on this rank: one more loss and backward of the
    launcher's final state on its next batch."""
    from repro_torch.distributed.sharding import (axis_rules,
                                                  replicate_plain, shard,
                                                  sharding_for)
    from repro_torch.optim.optimizer import tree_leaves
    model, mesh, params = res["model"], res["mesh"], res["state"].params
    leaves = tree_leaves(params)
    with axis_rules(mesh), torch.enable_grad(), replicate_plain(leaves[0]):
        batch = cards_batch(len(res["trainer"].metrics_history),
                            model.device, sharding_for(
                                "batch -", (CARDS_BATCH, CARDS_SEQ), mesh))
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(shard(loss), leaves)
    out = {name: [str(tuple(g.placements)),
                  g.to_local().numel() * g.element_size()]
           for name, g in zip(_paths(params), grads)
           if any(pl.is_partial() for pl in g.placements)}
    for p in leaves:
        p.requires_grad_(False)
    return out


def cards_gemm(mesh, dtype, flush):
    """The crossbar on this rank's card: sharded_gemm_op at CARDS_GEMM
    (the lhs row-sharded over ``data``, the rhs replicated; backend
    "cuda"), one forward and backward with the counts reset, its rows and
    both local gradients held bit for bit to ``gemm_op`` on this card's
    rows alone, the rhs gradient's all-reduce over ``data`` to the sum of
    every rank's one-card gradient in rank order (two sums of the same
    terms in two orders, each rounding ranks - 1 times: within 2 (ranks -
    1) u of the sum of their magnitudes, u the unit roundoff of the type,
    2^-24 for f32, 2^-8 for bf16); then ms a
    call, gemm_op's and the library's on the same rows, and the
    all-reduce's.  Returns the record."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core import integrate
    from repro_torch.kernels import gemm
    m, n, k = CARDS_GEMM
    dev = flush.device
    world, r = mesh.size(0), mesh.get_local_rank("data")
    rows = m // world
    dt = str(dtype)[6:]
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b, w = (torch.randn(s, generator=gen, device=dev)
               for s in ((m, k), (k, n), (m, n)))
    a, b = a.to(dtype), b.to(dtype)
    op = integrate.sharded_gemm_op(mesh, m, n, k, backend="cuda")
    split, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
    da, db, dw = (distribute_tensor(x, mesh, pl, src_data_rank=None)
                  for x, pl in ((a, split), (b, rep), (w, split)))
    ga, gb = da.detach().requires_grad_(), db.detach().requires_grad_()
    cg = gemm.cuda_gemm
    cg.launches = cg.wgmma_launches = cg.ffma_launches = 0
    out = op(ga, gb)
    (out * dw).sum().backward()
    torch.cuda.synchronize()
    launches = [cg.launches, cg.wgmma_launches, cg.ffma_launches]
    path = route_of(cg, (0, 0))
    mine = slice(r * rows, (r + 1) * rows)
    ref = integrate.gemm_op(rows, n, k, backend="cuda")
    ra, rb = a[mine].clone().requires_grad_(), b.clone().requires_grad_()
    want = ref(ra, rb)
    (want * w[mine]).sum().backward()
    same = [torch.equal(out.to_local(), want),
            torch.equal(ga.grad.to_local(), ra.grad),
            torch.equal(gb.grad.to_local(), rb.grad)]
    parts = [torch.empty_like(rb.grad) for _ in range(world)]
    dist.all_gather(parts, rb.grad, group=mesh.get_group("data"))
    total = sum(x.float() for x in parts)
    scale = sum(x.float().abs() for x in parts)

    def all_reduce():
        t = gb.grad.redistribute(mesh, rep).to_local()
        return t.wait() if hasattr(t, "wait") else t
    summed = all_reduce().float()
    u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    diff = (summed - total).abs()
    reduce_share = (diff / (2 * (world - 1) * u * scale).clamp_min(1e-30)
                    ).max().item()
    plan = integrate._compiled(rows, n, k, "tpu_mxu", "cuda", dt).plan
    bound, bound_by = gemm_bound(plan, rows, n, k)
    a_rows = a[mine].contiguous()
    with torch.no_grad():
        rec = {"dtype": dt, "route": path, "launches": launches,
               "bit_equal": same, "reduce_share": reduce_share,
               "reduce_max_diff": diff.max().item(),
               "ms": time_ms(lambda: op(da, db), flush, iters=20),
               "gemm_op_ms": time_ms(lambda: ref(a_rows, b), flush,
                                     iters=20),
               "bound_ms": bound, "bound_by": bound_by,
               "all_reduce_ms": time_ms(all_reduce, flush, iters=20),
               "all_reduce_mb": gb.grad.to_local().numel()
               * gb.grad.element_size() / 1e6}
        rec["library_ms"], rec["library"] = library_times(
            plan, a_rows, b, want.detach(), flush)
    check(launches[0] == 3, f"crossbar {dt}: {launches[0]} launches, "
          f"expected 3")
    check(path == ("ffma" if dtype == torch.float32 else "wgmma"),
          f"crossbar {dt}: the {path} route")
    check(all(same), f"crossbar {dt}: rows / gradients against gemm_op "
          f"{same}")
    check(reduce_share <= 1, f"crossbar {dt}: all-reduce at "
          f"{reduce_share:.3g} of its bound")
    return rec


def cards_profile(res):
    """Where one more train step of the launcher's state goes on this
    card (torch.profiler): the profiled window's wall ms, the products'
    ms (cuBLAS / CUTLASS kernels) and the other compute kernels' (one
    stream: their sum is that stream's busy time), the NCCL kernels' ms
    (summed: they run on their own streams, overlap the compute and
    include each wait for the other ranks), and kernels a step."""
    from repro_torch.distributed.sharding import axis_rules, sharding_for
    model, mesh = res["model"], res["mesh"]
    fn = res["trainer"].train_step
    state = {"s": res["state"]}
    with axis_rules(mesh):
        batch = cards_batch(CARDS_STEPS, model.device, sharding_for(
            "batch -", (CARDS_BATCH, CARDS_SEQ), mesh))

        def step():
            state["s"], metrics = fn(state["s"], batch)
            metrics["loss"].item()
        busy, window, rows, _ = profile_steps(step, 1)
    res["state"] = state["s"]
    if busy is None:
        return None
    return dict(step_split(rows), window_ms=window,
                top=[[round(ms, 2), n, name[:80]] for ms, n, name in rows[:6]])


def step_split(rows):
    """A profiled step's device rows (``profile_steps``) split into the
    products (PRODUCT_KERNELS), the NCCL kernels by kind (the <Kind> of
    their ``ncclDevKernel_<Kind>`` names; they run on their own streams,
    overlap the compute and include each wait for the other ranks) and
    the other kernels, in ms, and the kernels counted.  Rows that name
    NCCL but no kernel (the ranges its calls mark on the device, over
    those same kernels) are left out."""
    out = {"products_ms": 0.0, "other_ms": 0.0, "nccl": {}, "kernels": 0}
    for ms, n, name in rows:
        if "nccl" in name.lower():
            m = re.search(r"nccl(?:DevKernel|Kernel)_([A-Za-z]+)", name)
            if m is None:
                continue
            kind = out["nccl"].setdefault(m.group(1), [0.0, 0])
            kind[0] += ms
            kind[1] += n
        elif any(k in name for k in PRODUCT_KERNELS):
            out["products_ms"] += ms
        else:
            out["other_ms"] += ms
        out["kernels"] += n
    out["nccl_ms"] = sum(v[0] for v in out["nccl"].values())
    return out


def cards_rank():
    """``--cards-rank``: one rank of ``launcher_cards`` under torchrun.
    ``launch.train.main(CARDS_LAUNCH)`` on this rank's card, then one
    more step profiled (``cards_profile``), the leaves whose gradient
    autograd returns Partial (``returned_partials``) and the crossbar
    (``cards_gemm``, f32 then bf16) on the launcher's mesh; prints its
    record as one ``[cards]`` JSON line."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    t0 = time.perf_counter()
    res = train.main(CARDS_LAUNCH)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, mesh = res["model"], res["mesh"]
    cfg, hist = model.cfg, res["trainer"].metrics_history
    rec = {"rank": dist.get_rank(), "card": card_of(local),
           "mesh": list(mesh.shape), "params": model.param_count(),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "flop_attn": 12 * cfg.num_layers * cfg.num_heads
           * cfg.resolved_head_dim, "losses": [h["loss"] for h in hist],
           "ms": [h["step_time_s"] * 1e3 for h in hist], "peak_gib": peak,
           "wall_s": wall}
    rec["profile"] = cards_profile(res)
    rec["partial"] = returned_partials(res)
    del res, hist
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                        device=torch.device("cuda", local))
    rec["gemm"] = [cards_gemm(mesh, dtype, flush)
                   for dtype in (torch.float32, torch.bfloat16)]
    print("[cards] " + json.dumps(rec))
    dist.destroy_process_group()


def reduced_launches(cards):
    """The launcher's comparison on ``cards`` cards: reduced qwen2-7b
    through ``launch.train --mesh host`` (CARDS_REDUCED: as 14g runs it,
    and with remat full) on ``cards`` NCCL ranks, both at once, every
    step's loss held to the same command without a mesh on the first
    card (``launcher_check``)."""
    import tempfile
    head = (f"[dist] NCCL on {cards} cards ({card_of(0)}, torch "
            f"{torch.__version__}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))})")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        logs = [os.path.join(tmp, str(i)) for i in range(len(CARDS_REDUCED))]
        procs = [start_launcher(cards, "cuda", log, args)
                 for log, args in zip(logs, CARDS_REDUCED)]
        try:
            want = [plain_launch("cuda", args) for args in CARDS_REDUCED]
            got = [launcher_result(proc, cards, log,
                                   time.monotonic() + DIST_RANK_TIMEOUT)
                   for proc, log in zip(procs, logs)]
        finally:
            for proc in procs:
                stop(proc)
        for g, w, args in zip(got, want, CARDS_REDUCED):
            launcher_check(head, g, w, time.perf_counter() - t, args)


def state_bytes():
    """The bytes of CARDS_LAUNCH's train state (params, AdamW's m and v
    in f32, its step and the rng) reckoned from meta shapes."""
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import adamw, tree_leaves
    from repro_torch.train.step import state_shapes
    model = Model(cards_config(), RunConfig(max_seq=CARDS_SEQ), "meta")
    return sum(t.numel() * t.element_size() for t in
               tree_leaves(state_shapes(model, adamw(lambda s: 1e-4))))


def disk_rate(directory, nbytes=2 ** 31):
    """Free bytes on ``directory``'s disk, and its write rate: ``nbytes``
    written to a new file of a unique name there and fsync'd, in bytes/s
    (the file removed)."""
    import shutil
    import tempfile
    free = shutil.disk_usage(directory).free
    block = np.ones(2 ** 26, np.uint8)
    fd, path = tempfile.mkstemp(dir=directory)
    t = time.perf_counter()
    with os.fdopen(fd, "wb") as f:
        for _ in range(nbytes // block.nbytes):
            f.write(block.data)
        f.flush()
        os.fsync(f.fileno())
    rate = nbytes / (time.perf_counter() - t)
    os.remove(path)
    return free, rate


def mount_of(path):
    """The mount point and file system type that hold ``path`` (the
    longest mount point of /proc/mounts above it)."""
    real, best = os.path.realpath(path), ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            mnt, fstype = line.split()[1:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return best


def host_available():
    """MemAvailable of /proc/meminfo, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def rank_pids(pid):
    """{rank: pid} of torchrun's workers: the processes whose parent is
    ``pid``, each rank read from its environment under /proc."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) != pid:
                    continue
            with open(f"/proc/{name}/environ", "rb") as f:
                env = dict(x.split(b"=", 1) for x in f.read().split(b"\0")
                           if b"=" in x)
            out[int(env[b"RANK"])] = int(name)
        except (OSError, KeyError, ValueError, IndexError):
            continue
    return out


def wait_for(found, proc, deadline):
    """``found()``'s first true value, polled every 50 ms while torchrun
    (``proc``) runs, before ``deadline``; None if it never came."""
    while time.monotonic() < deadline and proc.poll() is None:
        got = found()
        if got:
            return got
        time.sleep(0.05)
    return None


def checkpointed_launch(cards, args, logs, preempt=False):
    """torchrun of ``launch.train`` ``args`` on ``cards`` NCCL ranks
    (unbuffered output); with ``preempt``, SIGTERM to the last rank alone
    once rank 0 has logged step CARDS_PREEMPT_AFTER.  Returns each rank's
    standard output (``rank_outputs``)."""
    import signal
    proc = torchrun(cards, logs, ["-m", "repro_torch.launch.train", *args],
                    env={"PYTHONUNBUFFERED": "1"})
    deadline = time.monotonic() + CARDS_TIMEOUT
    line = f"[trainer] step {CARDS_PREEMPT_AFTER}:"

    def logged():
        return any(line in f.read_text() for f in pathlib.Path(logs).glob(
            "**/attempt_0/0/stdout.log"))
    try:
        if preempt:
            pids = wait_for(lambda: (lambda p: p if len(p) == cards
                                     else None)(rank_pids(proc.pid)),
                            proc, deadline)
            check(pids is not None and sorted(pids) == list(range(cards)),
                  f"checkpoint: torchrun's workers {pids}")
            check(wait_for(logged, proc, deadline),
                  f"checkpoint: rank 0 never logged step "
                  f"{CARDS_PREEMPT_AFTER}")
            os.kill(pids[cards - 1], signal.SIGTERM)
        return rank_outputs(proc, cards, logs, deadline, "checkpoint")
    finally:
        stop(proc)


CKPT_IO = (r"\(([\d.]+) GB {} by this process in ([\d.]+) s; peak host "
           r"memory \+([\d.]+) GB\)")


def ckpt_record(text):
    """One rank's run of ``checkpointed_launch`` from its log: losses,
    each step's ms, the step it was preempted at (None if none), its
    saves and its restore as (step, GB, s, GB of peak host memory
    growth)."""
    losses = re.search(r"^\[train\] losses: (.*)$", text, re.M)
    pre = re.search(r"^\[trainer\] preempted at step (\d+);", text, re.M)
    got = re.search(r"^\[trainer\] resumed from step (\d+) "
                    + CKPT_IO.format("read"), text, re.M)
    return {
        "losses": [float(x) for x in losses.group(1).split()]
        if losses else [],
        "ms": {int(m.group(1)): int(m.group(2)) for m in re.finditer(
            r"^\[trainer\] step (\d+): loss=\S+ lr=\S+ (\d+)ms$", text,
            re.M)},
        "preempted": int(pre.group(1)) if pre else None,
        "saves": [(int(m.group(1)), *map(float, m.groups()[1:]))
                  for m in re.finditer(
                      r"^\[trainer\] checkpointed step (\d+) -> \S+ "
                      + CKPT_IO.format("written"), text, re.M)],
        "restore": (int(got.group(1)), *map(float, got.groups()[1:]))
        if got else None}


def cards_checkpoint(cards, straight):
    """The launcher's checkpointed run on ``cards`` cards: CARDS_LAUNCH
    with ``--checkpoint-dir`` in a temporary directory of its own (its
    file system's free space, for a memory-backed one (tmpfs) the host's
    available memory too, and its write rate measured first; the part
    fails where they cannot hold two checkpoints), preempted by SIGTERM
    to one rank after step CARDS_PREEMPT_AFTER, then the same command
    again, resuming to CARDS_STEPS.  Held to: every rank stopped after the same step and
    saved once; that checkpoint committed, then the resumed run's; the
    bytes written by all ranks summing to the state's; each rank reading
    about its share and its host memory growing by less; the two halves'
    losses equal to ``straight`` (the whole model's, rank 0 of
    ``cards_rank``) bit for bit, or within CARDS_TOL where the first half
    already differs.  Prints each rank's seconds, bytes and host growth
    to save and restore, with its card's name and power limit."""
    import tempfile
    from repro_torch.checkpoint.checkpointer import all_steps
    nbytes = state_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        mnt, fstype = mount_of(tmp)
        free, rate = disk_rate(tmp)
        avail = host_available()
        room = free if fstype != "tmpfs" else min(free, avail)
        print(f"[ckpt] {card_of(0)}: {tmp} on {mnt} ({fstype}"
              f"{', memory' if fstype == 'tmpfs' else ''}): "
              f"{free / 1e9:.1f} GB free, {rate / 1e9:.3f} GB/s written (one"
              f" 2 GiB file, fsync'd); host memory {avail / 1e9:.1f} GB "
              f"available; one checkpoint of {CARDS_ARCH} whole is "
              f"{nbytes / 1e9:.2f} GB and a resumed run writes a second; "
              f"the parent's writer (every rank gathering every leaf) would "
              f"hold {cards} x {nbytes / 1e9:.1f} = "
              f"{cards * nbytes / 1e9:.1f} GB on the host: not run")
        check(room >= 2.1 * nbytes, f"checkpoint: room for "
              f"{room / 1e9:.1f} GB under {tmp} ({fstype}), two checkpoints "
              f"need {2 * nbytes / 1e9:.1f}: set TMPDIR to a larger "
              f"directory")
        t = time.perf_counter()
        ck = os.path.join(tmp, "ck")
        run = CARDS_LAUNCH + ["--checkpoint-dir", ck, "--log-every", "1"]
        first = [ckpt_record(x) for x in checkpointed_launch(
            cards, run, os.path.join(tmp, "first"), preempt=True)]
        committed = [sorted(all_steps(ck)), sorted(os.listdir(ck))]
        second = [ckpt_record(x) for x in checkpointed_launch(
            cards, run, os.path.join(tmp, "second"))]
        committed.append(sorted(all_steps(ck)))
        seconds = time.perf_counter() - t
    at = first[0]["preempted"]
    share = nbytes / cards
    none = (None, 0.0, 0.0, 0.0)
    for r, (a, b) in enumerate(zip(first, second)):
        sa, ga, ta, ha = (a["saves"] or [none])[0]
        ra, rg, rt, rh = b["restore"] or none
        sb, gb_, tb, hb = (b["saves"] or [none])[-1]
        print(f"[ckpt] rank {r} ({card_of(r)}): {CARDS_ARCH} whole, "
              f"mesh ({cards}, 1); first run preempted at step {a['preempted']}"
              f" (SIGTERM to rank {cards - 1} alone after step "
              f"{CARDS_PREEMPT_AFTER} was logged); saved step {sa}: {ga:.3f}"
              f" GB written in {ta:.2f} s ({ga / max(ta, 1e-9):.3f} GB/s), "
              f"peak host memory +{ha:.3f} GB; resumed from step {ra}: "
              f"{rg:.3f} GB read in {rt:.2f} s (warm: just written), peak "
              f"host memory +{rh:.3f} GB; saved step {sb}: {gb_:.3f} GB in "
              f"{tb:.2f} s, +{hb:.3f} GB; the rank's share of the state "
              f"{share / 1e9:.3f} GB; step ms " + ", ".join(
                  f"{k}: {v}" for k, v in sorted({**a["ms"], **b["ms"]}
                                                 .items())))
    halves = first[0]["losses"] + second[0]["losses"]
    equal = halves == straight
    rel = max((abs(x - y) / abs(y) for x, y in zip(halves, straight)),
              default=math.inf)
    repeat = max((abs(x - y) / abs(y)
                  for x, y in zip(first[0]["losses"], straight)), default=0)
    written = sum(a["saves"][0][1] for a in first if a["saves"])
    print(f"[ckpt] {cards} ranks, {seconds:.1f} s for the two runs: "
          f"preempted at step "
          f"{at}, resumed to {CARDS_STEPS}: losses {fmt_losses(halves)} "
          f"against the straight run's {fmt_losses(straight)}: bit-equal "
          f"{equal} (worst relative {rel:.2e}; the first half, a repeat of "
          f"the straight run, {repeat:.2e}); all ranks wrote {written:.3f}"
          f" GB, the state is {nbytes / 1e9:.3f} GB; steps committed "
          f"after the first run {committed[0]} ({committed[1]}), after the "
          f"second {committed[2]}")
    check(at is not None and CARDS_PREEMPT_AFTER <= at < CARDS_STEPS
          and all(a["preempted"] == at for a in first),
          f"checkpoint: ranks stopped at {[a['preempted'] for a in first]}")
    check(all([s[0] for s in a["saves"]] == [at] for a in first)
          and committed[0] == [at] and committed[1] == [f"step_{at:08d}"],
          f"checkpoint: first run's saves {[a['saves'] for a in first]}, "
          f"{committed[:2]}")
    check(all(b["restore"] and b["restore"][0] == at
              and [s[0] for s in b["saves"]] == [CARDS_STEPS]
              for b in second) and committed[2] == [at, CARDS_STEPS],
          f"checkpoint: resumed runs {[(b['restore'], b['saves']) for b in second]}")
    check(abs(written - nbytes / 1e9) <= 1e-3 * cards,
          f"checkpoint: {written:.3f} GB written, state "
          f"{nbytes / 1e9:.3f} GB")
    check(all(b["restore"][1] <= 1.05 * share / 1e9 + 1e-3 for b in second),
          "checkpoint: a rank read more than its share")
    check(all(a["saves"][0][3] < share / 1e9 and b["restore"][3]
              < share / 1e9 for a, b in zip(first, second)),
          "checkpoint: host memory grew by a rank's share or more")
    check(len(first[0]["losses"]) == at
          and len(halves) == CARDS_STEPS
          and all(math.isfinite(x) for x in halves)
          and all(a["losses"] == first[0]["losses"] for a in first)
          and all(b["losses"] == second[0]["losses"] for b in second),
          f"checkpoint: losses {[a['losses'] for a in first]}, "
          f"{[b['losses'] for b in second]}")
    check(equal or (repeat > 0 and rel <= CARDS_TOL),
          f"checkpoint: resumed losses {rel:.2e} from the straight run's "
          f"(the repeat's own {repeat:.2e})")


def launcher_cards(cards):
    """``--launcher-cards``: first the launcher's reduced comparison on
    ``cards`` cards (``reduced_launches``); then qwen2-7b whole through
    the launcher's torchrun command (CARDS_LAUNCH) on ``cards`` NCCL
    ranks, a card each, each rank this script again (``--cards-rank``).
    Held to: every loss finite, the last below the first, rank 0's first
    within CARDS_TOL relative of ``one_card_loss`` (run first, alone on
    the first card), every rank's losses equal to rank 0's; then the
    crossbar's checks (``cards_gemm``).  Prints each rank's mesh, losses,
    ms a step,
    tokens/s, model-FLOP share of ``cards`` x the f32 peak, peak GiB and
    crossbar times, with its card's name and power limit.  Then the same
    command checkpointed, preempted and resumed, held to that straight
    run (``cards_checkpoint``)."""
    import tempfile
    check(torch.cuda.device_count() >= cards,
          f"cards: {torch.cuda.device_count()} cards, {cards} asked for")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    # the crossbar's emitted GEMMs, built once here, not by every rank
    srcs = [fn.source for fn in dist_gemm_products(
        CARDS_GEMM[0] // cards, *CARDS_GEMM[1:])]
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(_build.load_source, srcs))
    reduced_launches(cards)
    dev = torch.device("cuda", 0)
    want = one_card_loss(dev)
    print(f"[cards] {card_of(0)}, torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}: one card's "
          f"forward of {CARDS_ARCH}'s seed-0 params on the first "
          f"batch: loss {want:.6f}; the crossbar's sources built "
          f"({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        proc = torchrun(cards, tmp, [str(ROOT / "chip_smoke.py"),
                                     "--cards-rank"])
        try:
            texts = rank_outputs(proc, cards, tmp,
                                 time.monotonic() + CARDS_TIMEOUT, "cards")
        finally:
            stop(proc)
        seconds = time.perf_counter() - t
    recs = []
    for r, text in enumerate(texts):
        line = re.search(r"^\[cards\] (\{.*\})$", text, re.M)
        check(bool(line), f"cards: rank {r} printed no record")
        recs.append(json.loads(line.group(1)))
    seq, tokens = CARDS_SEQ, CARDS_BATCH * CARDS_SEQ
    first = recs[0]["losses"]
    for rec in recs:
        warm = sum(rec["ms"][1:]) / len(rec["ms"][1:])
        flops = 6 * rec["params"] * tokens + rec["flop_attn"] * seq * tokens
        print(f"[cards] rank {rec['rank']} ({rec['card']}): {CARDS_ARCH}"
              f" whole, {rec['layers']} layers d_model {rec['d_model']}, "
              f"{rec['params']:,} params, f32 AdamW, remat full, mesh "
              f"{tuple(rec['mesh'])}; losses {fmt_losses(rec['losses'])}; "
              f"step ms {', '.join(f'{x:.1f}' for x in rec['ms'])}; steps "
              f"2-{len(rec['ms'])}: {warm:.1f} ms, "
              f"{tokens / warm * 1e3:.1f} tokens/s, {flops / 1e12:.2f} TFLOP"
              f" a step = {flops / (warm / 1e3) / 1e12:.1f} TFLOP/s, "
              f"{flops / (warm / 1e3) / (cards * F32_FLOP_PER_S):.1%} of "
              f"{cards} x 67 TFLOP/s; peak {rec['peak_gib']:.1f} GiB; "
              f"launcher {rec['wall_s']:.1f} s; gradients autograd returns "
              f"Partial: " + (", ".join(
                  f"{k} {v[0]} {v[1] / 1e6:.3f} MB"
                  for k, v in rec["partial"].items()) or "none"))
        pr = rec["profile"]
        if pr is None:
            print(f"[cards] rank {rec['rank']}: profiled step: device time "
                  f"not measured (the profiler recorded no device time)")
        else:
            compute = pr["products_ms"] + pr["other_ms"]
            print(f"[cards] rank {rec['rank']} ({rec['card']}): profiled "
                  f"step, {pr['window_ms']:.1f} ms wall: compute kernels "
                  f"{compute:.1f} ms (products {pr['products_ms']:.1f}, the "
                  f"rest {pr['other_ms']:.1f}; the compute stream idle "
                  f"{1 - compute / pr['window_ms']:.1%}), NCCL kernels "
                  f"{pr['nccl_ms']:.1f} ms summed (overlapping, waits "
                  f"included: " + ", ".join(
                      f"{k} {v[0]:.1f} ms x{v[1]}"
                      for k, v in pr["nccl"].items())
                  + f"); {pr['kernels']} kernels; largest: "
                  + "; ".join(
                      f"{ms} ms x{n} {name}" for ms, n, name in pr["top"]))
        for g in rec["gemm"]:
            print(f"[cards] rank {rec['rank']} ({rec['card']}): crossbar "
                  f"sharded_gemm_op {'x'.join(map(str, CARDS_GEMM))} "
                  f"{g['dtype']}, {CARDS_GEMM[0] // cards} rows a card: "
                  f"launches {g['launches'][0]} ({g['route']} route; wgmma"
                  f" {g['launches'][1]}, ffma {g['launches'][2]}); rows and "
                  f"local gradients bit-equal to gemm_op on this card "
                  f"{g['bit_equal']}; the rhs gradient's all-reduce over "
                  f"data against the four one-card gradients summed in rank "
                  f"order: max diff {g['reduce_max_diff']:.3e}, "
                  f"{g['reduce_share']:.3g} of its bound; {g['ms']:.3f} ms a"
                  f" call (gemm_op {g['gemm_op_ms']:.3f}), bound "
                  f"{g['bound_ms']:.3f} ms ({g['bound_by']}), {g['library']}"
                  f"; all-reduce of {g['all_reduce_mb']:.1f} MB "
                  f"{g['all_reduce_ms']:.3f} ms")
    rel = abs(first[0] - want) / abs(want)
    print(f"[cards] {cards} ranks in {seconds:.1f} s: rank 0's first loss "
          f"{first[0]:.6f} against one card's forward {want:.6f}: relative "
          f"{rel:.2e} (bound {CARDS_TOL:g}); every rank's losses equal to "
          f"rank 0's: {all(rec['losses'] == first for rec in recs)}")
    check(len(first) == CARDS_STEPS
          and all(math.isfinite(x) for x in first), f"cards: losses {first}")
    check(first[-1] < first[0], f"cards: loss rose {first}")
    check(rel <= CARDS_TOL, f"cards: first loss {rel:.2e} from one card's")
    check(all(rec["losses"] == first for rec in recs),
          "cards: ranks' losses differ")
    check(all(rec["mesh"] == [cards, 1] for rec in recs),
          f"cards: meshes {[rec['mesh'] for rec in recs]}")
    cards_checkpoint(cards, first)


def moe_cfg(layers=None, cf=None, reduced=False):
    """MOE_ARCH at full width cut to ``layers`` layers (whole when None),
    at capacity factor ``cf`` (the config's own when None); with
    ``reduced``, the family's reduced config with 16 experts instead
    (small enough for gloo CPU ranks, and still on the dense path at a
    decode step of BATCH rows)."""
    import dataclasses
    from repro_torch.configs import base
    cfg = base.get_config(MOE_ARCH)
    if reduced:
        cfg = base.reduced(cfg, layers=layers or 2)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=16))
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    """Return what the dropped tensors held to the card, before a part's
    run on one card."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def seeded(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def expert_weight_of(cfg):
    """Whether a tensor of a given shape is a piece of one of ``cfg``'s
    expert weights or of its gradient: its last two dims a piece of
    d_model by a piece of expert_ff, either way round, each cut at most
    four ways."""
    d, f = cfg.d_model, cfg.moe.expert_ff
    pieces = {(d // a, f // b) for a in (1, 2, 4) for b in (1, 2, 4)}

    def test(shape):
        return len(shape) >= 3 and (tuple(shape[-2:]) in pieces
                                    or tuple(shape[-2:])[::-1] in pieces)
    return test


class Collectives:
    """While active, counts the collectives this rank makes below DTensor
    (the functional collectives and DTensor's own all-to-all,
    ``shard_dim_alltoall``, seen by a dispatch mode) by kind and mesh axis:
    calls and the bytes of their local inputs; and the calls whose tensor
    ``watch(shape)`` picks."""

    def __init__(self, mesh, watch=lambda shape: False):
        import torch.distributed as dist
        self.axis = {tuple(dist.get_process_group_ranks(mesh.get_group(n))):
                     n for n in mesh.mesh_dim_names}
        self.watch, self.counts, self.watched = watch, {}, []

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                names = [a.name for a in func._schema.arguments]
                if (func.namespace in ("_c10d_functional", "_dtensor")
                        and "group_name" in names):
                    vals = dict(zip(names, args), **kwargs)
                    pg = vals["group_name"]
                    if isinstance(pg, str):
                        pg = _resolve_process_group(pg)
                    axis = rec.axis.get(
                        tuple(dist.get_process_group_ranks(pg)), "world")
                    kind = func.overloadpacket.__name__
                    ts = args[0] if isinstance(args[0], (list, tuple)) \
                        else [args[0]]
                    n = rec.counts.setdefault((kind, axis), [0, 0])
                    n[0] += 1
                    n[1] += sum(t.numel() * t.element_size() for t in ts)
                    rec.watched += [[kind, axis, list(t.shape)] for t in ts
                                    if rec.watch(tuple(t.shape))]
                return func(*args, **kwargs)
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def rows(self):
        """[kind, axis, calls, bytes], in kind and axis order."""
        return [[k, a, n, b] for (k, a), (n, b) in sorted(self.counts.items())]


def fmt_calls(rows):
    return "; ".join(f"{k} over {a} x{n} {b / 1e6:.3f} MB"
                     for k, a, n, b in rows) or "none"


def local_share(mesh, got, want, mask=None):
    """The largest difference between a DTensor ``got`` (or its (local
    piece, placements)) and the whole tensor ``want`` (each rank comparing
    its own piece, ``mask`` zeroing the differences it picks), over
    ``want``'s largest magnitude, the same on every rank (an all-reduce of
    the maximum)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    local, pl = (got.to_local(), got.placements) if hasattr(
        got, "to_local") else got
    mine = distribute_tensor(want.detach(), mesh, tuple(pl),
                             src_data_rank=None).to_local()
    diff = (local.detach().to(mine.device).float() - mine.float()).abs()
    if mask is not None:
        diff = torch.where(mask(diff), torch.zeros_like(diff), diff)
    worst = diff.max().reshape(1) if diff.numel() else torch.zeros(
        1, device=diff.device)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return worst.item() / max(want.detach().abs().max().item(), 1e-30)


def drops_of(top_idx, n_experts, capacity, shards):
    """(token, expert) pairs past their expert's ``capacity`` when each of
    ``shards`` row blocks of ``top_idx`` fills its own slots."""
    T = top_idx.shape[0]
    out = 0
    for r in range(shards):
        rows = top_idx[r * T // shards:(r + 1) * T // shards].reshape(-1)
        counts = torch.zeros(n_experts, dtype=torch.int64,
                             device=rows.device).scatter_add_(
            0, rows, torch.ones_like(rows))
        out += int((counts - capacity).clamp_min(0).sum())
    return out


def moe_layer_part(mesh, dev, cfg, tokens):
    """(a) The MoE layer on the mesh, f32: x and the output weights wy
    from seed 1, params of seed 0 drawn on the card (``init_moe``'s Maker
    with the mesh); the output, the aux loss and the gradients of
    (y * wy).sum() + aux against the same layer on one card: on the whole
    batch, or with more than one data shard on each shard's rows apart
    (each at its own capacity, as the expert-parallel path computes it)
    with the whole batch's aux loss.  Tokens whose top-K set differs
    between the two runs' router logits are held apart: their rows of the
    output and the input's gradient, and the experts they reach in the
    expert weights' gradients; the router's, the norm's and the shared
    experts' gradients are then printed, not held."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  full, mesh_shape,
                                                  sharding_for)
    from repro_torch.models import moe
    from repro_torch.models.layers import Maker, rmsnorm
    B, S = tokens
    T, d, E, K = B * S, cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    shards = mesh_shape(mesh)["data"]
    gen = seeded(dev, 1)
    x = torch.randn((B, S, d), generator=gen, device=dev)
    wy = torch.randn((B, S, d), generator=gen, device=dev)

    def router(p, xx):
        h = rmsnorm(xx, p["norm"], cfg.norm_eps).reshape(-1, d)
        return full((h @ p["router"]).float())

    rec = {"tokens": T, "shards": shards}
    with axis_rules(mesh):
        p = moe.init_moe(cfg, Maker("init", generator=seeded(dev),
                                    device=dev, mesh=mesh))
        names = sorted(p)
        dx = distribute(x, sharding_for("batch - -", x.shape, mesh))
        leaves = [dx.requires_grad_(True)] + [p[k].requires_grad_(True)
                                              for k in names]
        sync(dev)
        t0 = time.perf_counter()
        y, aux = moe.apply_moe(p, dx, cfg)
        grads = torch.autograd.grad(
            (y * distribute(wy, sharding_for("batch - -", wy.shape, mesh))
             ).sum() + aux, leaves)
        sync(dev)
        rec["s"] = time.perf_counter() - t0
        rec["ep"] = moe._can_shardmap(cfg, T)
        got_y, got_dx = full(y).detach(), full(grads[0]).detach()
        got_aux = float(full(aux))
        got = {k: g.redistribute(mesh, p[k].placements)
               for k, g in zip(names, grads[1:])}
        with torch.no_grad():
            r_mesh = router(p, dx.detach())
        del y, aux, grads, leaves, dx, p
    free(dev)
    p1 = moe.init_moe(cfg, Maker("init", generator=seeded(dev), device=dev))
    xs = x.clone().requires_grad_(True)
    leaves = [xs] + [p1[k].requires_grad_(True) for k in names]
    rows = B // shards
    if shards == 1:
        y1, aux1 = moe.apply_moe(p1, xs, cfg)
    else:
        y1 = torch.cat([moe.apply_moe(p1, xs[r * rows:(r + 1) * rows],
                                      cfg)[0] for r in range(shards)])
        aux1 = moe.apply_moe(p1, xs, cfg)[1]
    want = torch.autograd.grad((y1 * wy).sum() + aux1, leaves)
    with torch.no_grad():
        r_one = router(p1, x)
    flip, near = route_flips(r_mesh, r_one, K)
    top_mesh = torch.topk(r_mesh, K, dim=-1).indices
    top_one = torch.topk(r_one, K, dim=-1).indices
    reached = torch.zeros(E, dtype=torch.bool, device=dev)
    reached[torch.cat([top_mesh[flip], top_one[flip]]).reshape(-1)] = True
    alike = ~flip

    def share(a, b):
        a, b = a.reshape(T, -1).float(), b.reshape(T, -1).float()
        diff = (a - b).abs().amax(-1)[alike]
        return (diff.max().item() if diff.numel() else 0.0) / max(
            b.abs().max().item(), 1e-30)
    cap = moe.capacity(cfg, T // shards)
    rec.update({
        "flips": int(flip.sum()), "unexplained": int((flip & ~near).sum()),
        "router_diff": (r_mesh - r_one).abs().max().item(),
        "reached": int(reached.sum()), "capacity": cap,
        "drops": drops_of(top_mesh, E, cap, shards),
        "y": share(got_y, y1.detach()), "dx": share(got_dx, want[0]),
        "aux": abs(got_aux - aux1.item()) / abs(aux1.item()),
        "aux_value": got_aux, "grads": {}})
    experts = ("w_gate", "w_up", "w_down")
    for k, w in zip(names, want[1:]):
        mask = None
        if k in experts and rec["flips"]:
            def mask(diff, lo=mesh.get_local_rank("model")):
                n = diff.shape[0]
                mine = reached[lo * n:(lo + 1) * n] if n < E else reached
                return mine.reshape((n,) + (1,) * (diff.dim() - 1)
                                    ).expand_as(diff)
        rec["grads"][k] = [local_share(mesh, got[k], w, mask),
                           k in experts or not rec["flips"]]
    return rec


def moe_serve_part(mesh, dev, cfg, batch, prompt, decode):
    """(b) Serving on the mesh, f32 and bf16: a ``batch`` x ``prompt``
    prefill of seed 1's tokens into a DTensor cache (``Model.cache_init(
    mesh=)``),
    then ``decode`` greedy steps; the logits against the same steps on
    one card (fed the mesh's tokens) through ``routed_compare``; each
    decode step timed again from the prefilled state, and once more with
    its collectives counted (``Collectives``, expert weights watched)."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  full, sharding_for)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.models.transformer import layer_kinds
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int64)).to(dev)
    depth, moes = prompt + decode + 1, layer_kinds(cfg).count("moe")
    watch = expert_weight_of(cfg)
    out = {"prefill_ep": None, "decode_dense": None}
    for dtype in ("float32", "bfloat16"):
        run = RunConfig(param_dtype=dtype, cache_dtype=dtype)
        model = Model(cfg, run, dev)
        rec = out[dtype] = {}
        with axis_rules(mesh), torch.no_grad():
            params = model.init(seeded(dev), mesh=mesh)

            def place(t):
                return distribute(t, sharding_for("batch -", t.shape, mesh))
            out["prefill_ep"] = moe._can_shardmap(cfg, batch * prompt)
            out["decode_dense"] = not moe._can_shardmap(cfg, batch)
            cache = model.cache_init(batch, depth, mesh=mesh)
            sync(dev)
            t0 = time.perf_counter()
            with RouterLog() as log:
                lg, cache = model.apply(params, place(toks), cache=cache)
                logits = [full(lg)]
                sync(dev)
                rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                start = clone(cache)
                fed = []
                for _ in range(decode):
                    fed.append(logits[-1][:, -1:].argmax(-1))
                    lg, cache = model.apply(params, place(fed[-1]),
                                            cache=cache)
                    logits.append(full(lg))
            routes = log.per_layer(moes)
            rec["ms"], rec["calls"], rec["watched"] = [], [], []
            cache = clone(start)
            for tok in fed:
                sync(dev)
                t = time.perf_counter()
                _, cache = model.apply(params, place(tok), cache=cache)
                sync(dev)
                rec["ms"].append((time.perf_counter() - t) * 1e3)
            cache = clone(start)
            for tok in fed:
                with Collectives(mesh, watch) as calls:
                    _, cache = model.apply(params, place(tok), cache=cache)
                rec["calls"].append(calls.rows())
                rec["watched"].append(calls.watched)
            del params, cache, start, lg
        got = torch.cat(logits, dim=1)
        del logits
        free(dev)
        one = Model(cfg, run, dev)
        with torch.no_grad():
            p1 = one.init(seeded(dev))
            c1 = one.cache_init(batch, depth)
            with RouterLog() as log1:
                lg, c1 = one.apply(p1, toks, cache=c1)
                ones = [lg]
                for tok in fed:
                    lg, c1 = one.apply(p1, tok, cache=c1)
                    ones.append(lg)
            del p1, c1
        want = torch.cat(ones, dim=1)
        f32 = dtype == "float32"
        limit_of = ((lambda scale: TOL_TEACHER) if f32 else
                    (lambda scale: TOL_BF16_LOGITS * scale))
        rec["err"], rec["flips"], rec["positions"] = routed_compare(
            f"cards {MOE_ARCH} {cfg.num_layers}L {dtype} on "
            f"{tuple(mesh.shape)}, prefill {batch} x {prompt} + {decode} "
            f"decode steps vs one card (logits max |x| "
            f"{want.float().abs().max().item():.2f})", got, want, routes,
            log1.per_layer(moes), cfg.moe.top_k, limit_of)
        del got, want, ones
        free(dev)
    return out


def plain_sgd(lr):
    """SGD without momentum at a constant ``lr``, in place: no state but
    the step count.  The port's ``sgd`` keeps a momentum buffer the size
    of the params, which beside the params and their gradients does not
    fit one card at deepseek-v2's full width cut to 2 layers (3 x 22.1
    GB)."""
    from repro_torch.optim.optimizer import (OptState, Optimizer,
                                             tree_leaves, tree_map)

    def init(params):
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=tree_leaves(params)[0].device),
                        m=(), v=())

    @torch.no_grad()
    def update(grads, state, params):
        rate = torch.tensor(lr, device=state.step.device)
        tree_map(lambda p, g: p.sub_(rate * g), params, grads)
        state.step.add_(1)
        return params, state, {"lr": rate}
    return Optimizer(init=init, update=update)


class ShardedMoE:
    """While active, ``models.moe.apply_moe`` on one card runs on each of
    ``shards`` row blocks of the batch apart, each at the capacity of its
    own tokens, with the aux loss of the whole batch: the arithmetic of
    the expert-parallel path on a mesh with ``shards`` data shards (the
    reference's ``_shardmap_moe``), which drops other tokens than one
    capacity over the whole batch does.  Records each call's dropped
    (token, expert) pairs at the blocks' capacity and at the whole
    batch's, from the layer's own routing."""

    def __init__(self, shards):
        self.shards, self.drops = shards, []

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models.layers import rmsnorm
        self._moe, self._orig = moe, moe.apply_moe
        orig, n = moe.apply_moe, self.shards

        def apply(p, x, cfg):
            B, S, d = x.shape
            with torch.no_grad():
                h = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(B * S, d)
                top = moe._top_k(torch.softmax((h @ p["router"]).float(),
                                               -1), cfg.moe.top_k)[1]
            E = cfg.moe.num_experts
            self.drops.append([
                drops_of(top, E, moe.capacity(cfg, B * S // n), n),
                drops_of(top, E, moe.capacity(cfg, B * S), 1)])
            if n == 1:
                return orig(p, x, cfg)
            rows = B // n
            y = torch.cat([orig(p, x[r * rows:(r + 1) * rows], cfg)[0]
                           for r in range(n)])
            return y, orig(p, x, cfg)[1]
        moe.apply_moe = apply
        return self

    def __exit__(self, *exc):
        self._moe.apply_moe = self._orig


def moe_train_part(mesh, dev, cfg, batches, lr):
    """(c) Steps of plain SGD at ``lr`` (``plain_sgd``) on the mesh, one a
    numpy batch of ``batches``, from the params of seed 0 drawn on the
    card, against the same steps on one card with the mesh's per-shard
    capacity (``ShardedMoE``): the losses, and each param's largest
    difference over its largest magnitude (``local_share``); and the
    pairs the first step drops at that capacity and at the whole
    batch's."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  mesh_shape, sharding_for)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import TrainState, make_train_step, new_rng

    def leaf(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree
    seq = batches[0]["tokens"].shape[1]
    model = Model(cfg, RunConfig(max_seq=seq), dev)
    opt = plain_sgd(lr)
    rec = {"ep": None, "losses": [], "plain_losses": []}
    sync(dev)
    t0 = time.perf_counter()
    with axis_rules(mesh):
        params = model.init(seeded(dev), mesh=mesh)
        state = TrainState(params, opt.init(params), new_rng(0, 1))
        fn = make_train_step(model, opt)
        for b in batches:
            state, met = fn(state, {k: distribute(
                torch.from_numpy(v).to(dev), sharding_for(
                    ("batch",) + ("-",) * (v.ndim - 1), v.shape, mesh))
                for k, v in b.items()})
            rec["losses"].append(float(met["loss"]))
        rec["ep"] = moe._can_shardmap(cfg, batches[0]["tokens"].size)
        # each rank's pieces wait on the host: one card's run needs the room
        got = {k: (leaf(state.params, k).to_local().cpu(),
                   leaf(state.params, k).placements)
               for k in _paths(state.params)}
        del state, fn, params
    rec["s"] = time.perf_counter() - t0
    free(dev)
    one = Model(cfg, RunConfig(max_seq=seq), dev)
    p1 = one.init(seeded(dev))
    st = TrainState(p1, opt.init(p1), new_rng(0, 1))
    fn = make_train_step(one, opt)
    with ShardedMoE(mesh_shape(mesh)["data"]) as split:
        for b in batches:
            st, met = fn(st, {k: torch.from_numpy(v).to(dev)
                              for k, v in b.items()})
            rec["plain_losses"].append(met["loss"].item())
    rec["drops"] = split.drops[0]
    want = st.params
    del st, fn, p1
    rec["shares"] = {k: local_share(mesh, got[k], leaf(want, k))
                     for k in _paths(want)}
    return rec


def moe_state_part(mesh, dev, cfg, batch, seq, steps):
    """(d) The launcher's recipe (``launch/train.py``: AdamW with weight
    decay 0.01, the cosine schedule of a ``steps``-step run at peak
    CARDS_LR with warmup max(steps // 20, 1), remat full, the pipeline's
    ``batch`` x ``seq`` batches of seed 0, ``Trainer``) on the mesh, the
    state built as DTensors (``init_state_sharded``): losses, ms a step,
    peak GiB; one more step profiled (products, NCCL kernels by kind, the
    rest, the compute stream's idle share) and one whose collectives are
    counted by kind and axis; then one card's forward of the same params
    on the first batch, at the mesh's per-shard capacity (``ShardedMoE``)
    and at the whole batch's."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed.sharding import (axis_rules, mesh_shape,
                                                  sharding_for)
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.optim import schedule as sched
    from repro_torch.optim.optimizer import adamw, tree_leaves
    from repro_torch.train.step import (TrainConfig, init_state_sharded,
                                        make_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = Model(cfg, RunConfig(max_seq=seq, remat="full"), dev)
    lr = sched.make("cosine", peak=CARDS_LR,
                    warmup_steps=max(steps // 20, 1), total_steps=steps)
    opt = adamw(lr, weight_decay=0.01)
    step_fn = make_train_step(model, opt, TrainConfig(microbatches=1))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=0))
    trainer = Trainer(TrainerConfig(total_steps=steps), step_fn, pipe)
    m, a = cfg.moe, cfg.mla
    active = model.param_count() - layer_kinds(cfg).count("moe") * (
        m.num_experts - m.top_k) * 3 * cfg.d_model * m.expert_ff
    rec = {"params": model.param_count(), "active": active,
           "batch": batch, "seq": seq, "steps": steps,
           "flop_attn": 6 * cfg.num_layers * cfg.num_heads * (
               a.qk_nope_dim + a.qk_rope_dim + a.v_dim),
           "ranks": dist.get_world_size()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with axis_rules(mesh):
        sharding = sharding_for("batch -", (batch, seq), mesh)
        state = init_state_sharded(model, opt, seeded(dev), mesh)
        # params, gradients, m and v: four f32 copies of each param's piece
        rec["state_gb"] = 4 * sum(t.to_local().numel() * t.element_size()
                                  for t in tree_leaves(state.params)) / 1e9
        state = {"s": trainer.run(state, sharding=sharding)}
        rec["wall_s"] = time.perf_counter() - t0
        hist = trainer.metrics_history
        rec["losses"] = [h["loss"] for h in hist]
        rec["ms"] = [h["step_time_s"] * 1e3 for h in hist]
        rec["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None)

        def step_on(k):
            b = pipe.torch_batch(k, dev, sharding)

            def step():
                state["s"], met = step_fn(state["s"], b)
                met["loss"].item()
            return step
        rec["profile"] = None
        if dev.type == "cuda":
            busy, window, rows, _ = profile_steps(step_on(steps), 1)
            if busy is not None:
                rec["profile"] = dict(step_split(rows), window_ms=window)
        with Collectives(mesh) as calls:
            step_on(steps + 1)()
        rec["calls"] = calls.rows()
        del state, trainer
    free(dev)
    one = Model(cfg, RunConfig(max_seq=seq), dev)
    with torch.no_grad():
        p1 = one.init(seeded(dev))
        first = pipe.torch_batch(0, dev)
        with ShardedMoE(mesh_shape(mesh)["data"]) as split:
            rec["one_card_loss"] = one.loss(p1, first)[0].item()
        rec["drops"] = split.drops[0]
        rec["whole_batch_loss"] = one.loss(p1, first)[0].item()
        del p1
    return rec


MOE_PARTS = ("layer", "serve", "train", "state")


def moe_parts(mesh, dev, parts=MOE_PARTS, reduced=False, layer_tokens=None,
              batch=None, serve=None, steps=CARDS_STEPS):
    """The parts of the four-card deepseek-v2 run on this rank's ``mesh``
    (``serve`` on (1, model) only): each part's record, or its error
    (printed with its traceback, so the other parts still run).  Sizes
    default to MOE_TOKENS, CARDS_BATCH x CARDS_SEQ and BATCH x PROMPT +
    MOE_DECODE; ``reduced`` runs the family's reduced config (CPU
    ranks)."""
    import traceback
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed.sharding import mesh_shape
    layer_tokens = layer_tokens or MOE_TOKENS
    b, s = batch or (CARDS_BATCH, CARDS_SEQ)
    serve = serve or (BATCH, PROMPT, MOE_DECODE)
    data = mesh_shape(mesh)["data"]
    out = {"mesh": list(mesh.shape), "card": (
        card_of(dev.index) if dev.type == "cuda" else "gloo CPU")}

    def cfg(layers=None, cf=None):
        return moe_cfg(layers, cf, reduced)

    def batches():
        base = cfg(MOE_TRAIN_LAYERS)
        pipe = Pipeline(DataConfig(vocab_size=base.vocab_size, seq_len=s,
                                   global_batch=b, seed=0))
        return [pipe.batch(k) for k in range(MOE_TRAIN_STEPS)]
    jobs = {
        "layer": lambda: moe_layer_part(mesh, dev, cfg(), layer_tokens),
        "serve": lambda: moe_serve_part(
            mesh, dev, cfg(MOE_SERVE_LAYERS, DIST_MOE_CF), *serve),
        "train": lambda: moe_train_part(
            mesh, dev, cfg(MOE_TRAIN_LAYERS), batches(), MOE_TRAIN_LR),
        "state": lambda: moe_state_part(mesh, dev, cfg(MOE_STATE_LAYERS),
                                        b, s, steps)}
    for part in parts:
        if part == "serve" and data != 1:
            continue
        t = time.perf_counter()
        try:
            out[part] = jobs[part]()
        except Exception as e:          # reported, the other parts run on
            traceback.print_exc(file=sys.stdout)
            out[part] = {"error": f"{type(e).__name__}: {e}"[:2000]}
        out[part]["part_s"] = time.perf_counter() - t
        free(dev)
    return out


def moe_rank(data, model, parts):
    """``--moe-rank DATA MODEL [PART ...]``: one NCCL rank under torchrun
    (this rank's card) of ``moe_parts`` on a (DATA, MODEL) mesh; prints
    its record as one ``[moe]`` JSON line."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    sys.path.insert(0, str(ROOT / "src"))
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "nccl", device_id=dev,
        timeout=datetime.timedelta(seconds=MOE_GROUP_TIMEOUT))
    try:
        mesh = DeviceMesh("cuda", torch.arange(data * model).reshape(
            data, model), mesh_dim_names=("data", "model"))
        rec = moe_parts(mesh, dev, parts or MOE_PARTS)
        rec["rank"] = dist.get_rank()
        print("[moe] " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def moe_cards(cards):
    """The deepseek-v2 parts of ``--launcher-cards`` (MOE_ARCH at full
    width; see MOE_MESHES): one torchrun of ``cards`` NCCL ranks for each
    mesh, each rank this script again (``--moe-rank``); prints each part's
    lines from rank 0's record (every rank's where they may differ) and
    holds them (``moe_report``)."""
    import tempfile
    check(cards == 4, f"moe: the meshes {MOE_MESHES} need 4 cards, not "
          f"{cards}")
    t0 = time.perf_counter()
    failed = []
    for data, model in MOE_MESHES:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            proc = torchrun(cards, tmp, [str(ROOT / "chip_smoke.py"),
                                         "--moe-rank", str(data), str(model)])
            try:
                texts = rank_outputs(proc, cards, tmp,
                                     time.monotonic() + CARDS_TIMEOUT,
                                     f"moe ({data}, {model})")
            finally:
                stop(proc)
            seconds = time.perf_counter() - t
        recs = []
        for r, text in enumerate(texts):
            line = re.search(r"^\[moe\] (\{.*\})$", text, re.M)
            if line is None:
                print(text[-6000:], file=sys.stderr)
            check(bool(line), f"moe: rank {r} printed no record")
            recs.append(json.loads(line.group(1)))
        # rank 0's own lines (routed_compare's) and any rank's traceback
        for line in texts[0].splitlines():
            if line.startswith("[family] cards"):
                print(line.replace("[family]", "[moe]", 1))
        for r, text in enumerate(texts):
            if "Traceback" in text:
                print(f"[moe] rank {r}:\n{text[text.index('Traceback'):]}"
                      [:4000], file=sys.stderr)
        try:
            moe_report(recs, (data, model), seconds)
        except RuntimeError as e:
            failed.append(str(e))
    print(f"[moe] {MOE_ARCH} on {cards} cards: {time.perf_counter() - t0:.1f}"
          f" s")
    check(not failed, " | ".join(failed))


def moe_report(recs, mesh, seconds):
    """Print and hold the records of one mesh's ranks (``moe_parts``),
    every part's before the first failure is raised."""
    head = f"[moe] {MOE_ARCH} on {mesh} ({recs[0].get('card', 'CPU')})"
    print(f"{head}: {len(recs)} ranks in {seconds:.1f} s (" + ", ".join(
        f"{p} {recs[0][p]['part_s']:.1f} s" for p in MOE_PARTS
        if p in recs[0]) + ")")
    reports = {"layer": lambda: moe_layer_report(head, [r["layer"] for r
                                                      in recs], mesh),
               "serve": lambda: moe_serve_report(head, recs[0]["serve"]),
               "train": lambda: moe_train_report(head, [r["train"] for r
                                                      in recs], mesh),
               "state": lambda: moe_state_report(head, [r["state"] for r
                                                      in recs], mesh)}
    failed = []
    for p in MOE_PARTS:
        if p not in recs[0]:
            continue
        errors = [f"rank {i}: {r[p]['error']}" for i, r in enumerate(recs)
                  if "error" in r[p]]
        try:
            check(not errors, f"moe {mesh} {p}: {errors[:1]}")
            reports[p]()
        except RuntimeError as e:
            print(f"{head} {p}: {e}")
            failed.append(str(e))
    check(not failed, "; ".join(failed))


def moe_layer_report(head, recs, mesh):
    r = recs[0]
    worst = {k: max(x["grads"][k][0] for x in recs) for k in r["grads"]}
    held = [k for k, (_, h) in r["grads"].items() if h]
    print(f"{head} (a) MoE layer f32, {r['tokens']} tokens, "
          f"{'expert-parallel' if r['ep'] else 'dense'} path, capacity "
          f"{r['capacity']} a data shard ({r['shards']} shards), "
          f"{r['drops']} (token, expert) pairs dropped: one forward and "
          f"backward {r['s']:.2f} s; against one card"
          + (" on each data shard's rows apart" if r["shards"] > 1 else "")
          + f": router logits max diff {r['router_diff']:.3e}, "
          f"{r['flips']} tokens re-routed at near-ties ({r['unexplained']} "
          f"not; {r['reached']} experts they reach held apart); output "
          f"{max(x['y'] for x in recs):.3e}, input gradient "
          f"{max(x['dx'] for x in recs):.3e} of their largest magnitude, "
          f"aux loss {r['aux_value']:.6f} relative "
          f"{max(x['aux'] for x in recs):.3e}; gradients: " + ", ".join(
              f"{k} {v:.3e}" + ("" if k in held else " (not held)")
              for k, v in worst.items()) + f" (bound {MOE_TOL:g})")
    check(all(x["ep"] for x in recs), f"moe {mesh} (a): not expert-parallel")
    check(all(x["unexplained"] == 0 for x in recs),
          f"moe {mesh} (a): tokens re-routed away from a near-tie")
    check(max(max(x["y"], x["dx"], x["aux"]) for x in recs) <= MOE_TOL,
          f"moe {mesh} (a): output / input gradient / aux off")
    check(all(worst[k] <= MOE_TOL for k in held),
          f"moe {mesh} (a): gradients {worst}")


def moe_serve_report(head, rec):
    check(rec["prefill_ep"] and rec["decode_dense"],
          f"moe serve: prefill expert-parallel {rec['prefill_ep']}, decode "
          f"dense {rec['decode_dense']}")
    for dtype in ("float32", "bfloat16"):
        r = rec[dtype]
        print(f"{head} (b) serving {dtype}: prefill (expert-parallel) "
              f"{r['prefill_ms']:.1f} ms (first call); decode steps "
              f"(dense) ms " + ", ".join(f"{x:.1f}" for x in r["ms"])
              + f"; logits max diff {r['err']:.3e} over the positions "
              f"routed alike, {r['flips']} of {r['positions']} re-routed")
        for i, (calls, watched) in enumerate(zip(r["calls"], r["watched"])):
            print(f"{head} (b) {dtype} decode step {i}: {r['ms'][i]:.2f} ms;"
                  f" collectives: {fmt_calls(calls)}; expert-weight pieces "
                  f"moved: {len(watched)}")
        check(not any(r["watched"]),
              f"moe serve {dtype}: expert weights moved {r['watched'][0]}")


def moe_train_report(head, recs, mesh):
    r = recs[0]
    rel = max(abs(a - b) / abs(b) for x in recs
              for a, b in zip(x["losses"], x["plain_losses"]))
    worst = max(max(x["shares"].values()) for x in recs)
    leaf = max(r["shares"], key=r["shares"].get)
    print(f"{head} (c) {len(r['losses'])} steps of plain SGD at lr "
          f"{MOE_TRAIN_LR:g}"
          f" ({'expert-parallel' if r['ep'] else 'dense'} MoE, {r['s']:.1f}"
          f" s; the first step drops {r['drops'][0]} (token, expert) pairs "
          f"at the mesh's capacity, {r['drops'][1]} at the whole batch's)"
          f": losses {fmt_losses(r['losses'])} against one card's at the "
          f"mesh's capacity "
          f"{fmt_losses(r['plain_losses'])}: worst relative {rel:.3e}; "
          f"params: worst difference {worst:.3e} of its leaf's largest "
          f"magnitude ({leaf}) (bound {MOE_TOL:g})")
    check(all(x["ep"] for x in recs), f"moe {mesh} (c): not expert-parallel")
    check(all(math.isfinite(v) for v in r["losses"])
          and rel <= MOE_TOL and worst <= MOE_TOL,
          f"moe {mesh} (c): losses {rel:.3e}, params {worst:.3e}")


def moe_state_report(head, recs, mesh):
    r = recs[0]
    seq, tokens = r["seq"], r["batch"] * r["seq"]
    warm = sum(r["ms"][1:]) / max(len(r["ms"]) - 1, 1)
    flops = 6 * r["active"] * tokens + r["flop_attn"] * seq * tokens
    rel = abs(r["losses"][0] - r["one_card_loss"]) / abs(r["one_card_loss"])
    whole = abs(r["losses"][0] - r["whole_batch_loss"]) / abs(
        r["whole_batch_loss"])
    print(f"{head} (d) {MOE_STATE_LAYERS} layers, {r['params']:,} params "
          f"({r['active']:,} active a token), f32 AdamW state "
          f"{r['state_gb']:.1f} GB a card, remat full, {len(r['losses'])} "
          f"steps of {r['batch']} x {seq}: losses {fmt_losses(r['losses'])};"
          f" step ms " + ", ".join(f"{x:.1f}" for x in r["ms"])
          + f"; steps 2-{len(r['ms'])}: {warm:.1f} ms, "
          f"{tokens / warm * 1e3:.1f} tokens/s, {flops / 1e12:.2f} model "
          f"TFLOP a step = {flops / (warm / 1e3) / 1e12:.2f} TFLOP/s, "
          f"{flops / (warm / 1e3) / (r['ranks'] * F32_FLOP_PER_S):.2%} of "
          f"{r['ranks']} x 67 TFLOP/s; peak " + ", ".join(
              "not measured" if x["peak_gib"] is None else
              f"{x['peak_gib']:.1f}" for x in recs) + " GiB a card; "
          f"{r['wall_s']:.1f} s; first loss {r['losses'][0]:.6f} against one"
          f" card's forward at the mesh's capacity {r['one_card_loss']:.6f}:"
          f" relative {rel:.3e} (bound {MOE_TOL:g}); at the whole batch's "
          f"capacity {r['whole_batch_loss']:.6f}: relative {whole:.3e} (not "
          f"held; pairs dropped at each capacity {r['drops'][0]} / "
          f"{r['drops'][1]})")
    pr = r["profile"]
    if pr is None:
        print(f"{head} (d) profiled step: device time not measured (the "
              f"profiler recorded no device time)")
    else:
        compute = pr["products_ms"] + pr["other_ms"]
        print(f"{head} (d) profiled step, {pr['window_ms']:.1f} ms wall: "
              f"compute kernels {compute:.1f} ms (products "
              f"{pr['products_ms']:.1f}, the rest {pr['other_ms']:.1f}; the "
              f"compute stream idle {1 - compute / pr['window_ms']:.1%}), "
              f"NCCL kernels (summed, waits included) " + ", ".join(
                  f"{k} {v[0]:.1f} ms x{v[1]}" for k, v in pr["nccl"].items())
              + f"; {pr['kernels']} kernels")
    print(f"{head} (d) one more step's collectives: {fmt_calls(r['calls'])}")
    check(all(len(x["losses"]) == r["steps"] and all(
        math.isfinite(v) for v in x["losses"]) for x in recs),
        f"moe {mesh} (d): losses {r['losses']}")
    check(all(x["losses"] == r["losses"] for x in recs),
          f"moe {mesh} (d): ranks' losses differ")
    check(rel <= MOE_TOL,
          f"moe {mesh} (d): first loss {rel:.3e} from one card's")


# --------------------------------------------------------------------------
# serving on a mesh: phase 14h and the four-card [serve] part
# --------------------------------------------------------------------------


def serve_cfg(layers=None):
    """SERVE_ARCH at full width, cut to ``layers`` layers (whole when
    None)."""
    import dataclasses
    from repro_torch.configs import base
    cfg = base.get_config(SERVE_ARCH)
    return (cfg if layers is None else
            dataclasses.replace(cfg, num_layers=layers))


def serve_prompts(cfg):
    """The launcher's prompts: BATCH x PROMPT tokens of seed 0."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)


def engine_logits(model, params, prompts, cuda_graphs, steps=None,
                  max_len=None):
    """``Engine.generate`` greedy over ``prompts`` for ``steps`` tokens
    (GEN by default; under the active mesh, if any; ``max_len`` the prompt
    and the steps and one by default): (the engine, its tokens, the gathered logits it
    sampled from at the prefill and at each decode step, stacked)."""
    from repro_torch.serve.engine import Engine, EngineConfig
    steps = steps or GEN
    eng = Engine(model, params, EngineConfig(
        max_len=max_len or prompts.shape[1] + steps + 1,
        cuda_graphs=cuda_graphs))
    logits, draw = [], eng._sample

    def sample(lg, gen):
        logits.append(lg.detach().float().clone())
        return draw(lg, gen)
    eng._sample = sample
    toks = eng.generate(prompts, steps)
    # no cycle (eng -> sample -> draw -> eng) outlives the call: a dropped
    # engine frees its captured steps at once, and on a mesh they must be
    # freed before the process group ends (see serve/graphs.py)
    del eng._sample
    return eng, toks, torch.stack(logits)


def local_gb(params):
    """GB of this rank's pieces of ``params`` (DTensors' local tensors)."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.optim.optimizer import tree_leaves
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in tree_leaves(params)) / 1e9


def serve_memory(cfg, mesh_shape):
    """Reckoned from meta shapes and the resolver, f32: (GB of params
    whole, GB a card, GB a card at the peak of ``Model.init(mesh=)``):
    there each leaf is drawn whole on every card (a normal draw in slices
    of up to 1 GiB into it) before its piece is copied out, beside the
    pieces of the leaves drawn before it."""
    from repro_torch.distributed.sharding import (parse_axes, pspec_for,
                                                  spec_axes)
    from repro_torch.models.model import Model, RunConfig
    model = Model(cfg, RunConfig(), "meta")
    sizes = dict(zip(("data", "model"), mesh_shape))

    def walk(shapes, axes):                 # in the order init draws them
        for k, v in shapes.items():
            if isinstance(v, dict):
                yield from walk(v, axes[k])
            else:
                yield v, axes[k]
    whole = placed = peak = 0.0
    for t, ax in walk(model.param_shapes(), model.param_axes()):
        n = t.numel() * 4
        k = math.prod(sizes[a] for e in pspec_for(parse_axes(ax), t.shape,
                                                  sizes) for a in spec_axes(e))
        peak = max(peak, placed + n + min(n, 2 ** 30) + n / k)
        placed += n / k
        whole += n
    return whole / 1e9, placed / 1e9, peak / 1e9


def dist_serve(mesh, dev, smi):
    """14h: SERVE_ARCH at full width cut to SERVE_LAYERS layers, f32, on
    the 1-rank NCCL (1, 1) mesh, params of seed 0 drawn on it
    (``Model.init(mesh=)``): ``ContinuousEngine`` with captured batched
    steps over phase 6b's stream (4 slots), its caches made on the mesh:
    every request completes, the streams those of the same engine over the
    same seed's params without a mesh, decode_attention launched a layer
    a batched step (the first eager, the rest replays of the captured
    step, each adding its capture's launches); then the batched step
    captured against eager on the mesh from one state (``graph_vs_eager``):
    logits bit-equal.  Returns the kernel's row at this path's shape (B
    4, KV 40, rep 1, hd 128), with the launches of the stream."""
    from repro_torch.distributed.sharding import axis_rules, is_dtensor
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.continuous import ContinuousEngine, Request
    cfg = serve_cfg(SERVE_LAYERS)
    model = Model(cfg, RunConfig(), dev)
    reqs = continuous_stream(cfg)
    with axis_rules(mesh), torch.no_grad():
        params = model.init(seeded(dev), mesh=mesh)
        eng = ContinuousEngine(model, params, slots=BATCH,
                               max_len=PROMPT + GEN + 1)
        da.decode_attention.launches = 0
        got = eng.serve(reqs)
        launches, steps = da.decode_attention.launches, eng.steps
        replays = eng._step.replays
        placed = all(is_dtensor(t) for t in (eng._cache["scan"]["pos0"]
                                             ["attn"]["k"], params["embed"]))
        del eng
        # one state of four occupied slots at other lengths, as step_time
        eng = ContinuousEngine(model, params, slots=BATCH,
                               max_len=PROMPT + GEN + 1, cuda_graphs=False)
        rng = np.random.default_rng(4)
        for i in range(BATCH):
            eng.submit(Request(i, rng.integers(0, cfg.vocab_size, (
                PROMPT - 16 * i,)).astype(np.int32), GEN))
        eng.step()
        graph_vs_eager(f"14h {SERVE_ARCH} {SERVE_LAYERS}L f32 on the (1, 1) "
                       f"mesh, continuous batched step", model, params,
                       eng._cache, eng._tok,
                       model.param_count() * 4 / HBM_BYTES_PER_S * 1e3,
                       lambda scale: 0.0)
        del eng, params
    free(dev)
    with torch.no_grad():
        plain = ContinuousEngine(model, model.init(seeded(dev)), slots=BATCH,
                                 max_len=PROMPT + GEN + 1).serve(reqs)
    same = sum(np.array_equal(got[r], plain[r]) for r in plain)
    print(f"[dist] 14h {SERVE_ARCH} at full width cut to {cfg.num_layers} "
          f"layers ({model.param_count():,} params), f32, ContinuousEngine "
          f"on the (1, 1) NCCL mesh (params and caches DTensors: {placed}),"
          f" captured batched steps, phase 6b's stream: {len(got)} of "
          f"{len(reqs)} requests, streams of the engine without a mesh "
          f"{same} of {len(plain)} identical; decode_attention launches "
          f"{launches} = {cfg.num_layers} layers x {steps} batched steps "
          f"({replays} replays); card {smi}")
    check(placed, "14h: params or cache not placed on the mesh")
    check(len(got) == len(reqs) and same == len(plain),
          f"14h: {len(got)} requests, {same} streams as without a mesh")
    check(launches == cfg.num_layers * steps and replays == steps - 1,
          f"14h: {launches} launches, {steps} steps, {replays} replays")
    free(dev)
    return [serve_decode_row(f"decode_attention [14h {SERVE_ARCH} on the "
                             f"(1, 1) mesh]", cfg.num_kv_heads, launches,
                             dev, smi)]


def serve_decode_row(name, kv, launches, dev, smi):
    """decode_attention's row (``decode_row``) at a serving step's shape on
    a card: B BATCH, ``kv`` KV heads of SERVE_ARCH, rep 1, the serving
    depth, the continuous engine's per-row lengths (CONT_VALID); held to
    its plain version at TOL_F32, with the path's ``launches``."""
    from repro_torch.kernels import decode_attention as da
    hd = serve_cfg().resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(14)
    q = torch.randn((BATCH, kv, 1, hd), generator=g, device=dev)
    k, v = (torch.randn((BATCH, kv, PROMPT + GEN + 1, hd), generator=g,
                        device=dev) for _ in range(2))
    valid = torch.tensor(CONT_VALID, dtype=torch.int32, device=dev)
    err = (da.decode_attention(q, k, v, valid) -
           da.decode_attention_ref(q, k, v, valid)).abs().max().item()
    check(err <= TOL_F32, f"{name}: error {err}")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    return decode_row(name, (q, k, v, valid), 256, launches, err, flush, smi)


def slot_streams(model, params):
    """The first SERVE_SLOT_REQUESTS requests of the launcher's stream
    through ``SerialSlotEngine`` greedy and ``ContinuousEngine`` at
    temperature 0.8, captured (under the active mesh, if any): rid (a
    string) -> tokens, for each."""
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.engine import SerialSlotEngine
    reqs = continuous_stream(model.cfg)[:SERVE_SLOT_REQUESTS]
    runs = {"serial": SerialSlotEngine(model, params, slots=BATCH,
                                       max_len=PROMPT + GEN + 1).serve(reqs),
            "continuous T0.8": ContinuousEngine(
                model, params, slots=BATCH, max_len=PROMPT + GEN + 1,
                temperature=0.8, seed=3).serve(reqs)}
    return {k: {str(r): x.tolist() for r, x in v.items()}
            for k, v in runs.items()}


def serve_cut(mesh, dev, out_dir):
    """(a) on this rank: SERVE_ARCH cut to SERVE_LAYERS layers, f32, params
    of seed 0 drawn on ``mesh``: ``Engine`` (``engine_logits``) captured
    and eager on the mesh; then the same params drawn whole on this card
    and given to the engines on the mesh, which place them (as the
    reference's ``serve_bench --mesh`` gives them): ``Engine`` captured,
    ``SerialSlotEngine`` and ``ContinuousEngine`` at a temperature
    (``slot_streams``); then each on this card alone without a mesh: the
    logits' largest difference from one card's and their largest
    magnitude, captured == eager (bit), tokens and streams equal, the
    decode kernel's launches and replays on the mesh."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    cfg = serve_cfg(SERVE_LAYERS)
    model = Model(cfg, RunConfig(), dev)
    prompts = serve_prompts(cfg)
    out = {"layers": cfg.num_layers}
    with axis_rules(mesh), torch.no_grad():
        params = model.init(seeded(dev), mesh=mesh)
        n = da.decode_attention.launches
        eng, toks, got = engine_logits(model, params, prompts, True)
        out["launches"] = da.decode_attention.launches - n
        out["steps"] = eng.last_timing["decode_steps"]
        out["replays"] = next(iter(eng._steps.values())).replays
        del eng
        _, etoks, eager = engine_logits(model, params, prompts, False)
        out["captured_eq_eager"] = bool(torch.equal(got, eager)
                                        and np.array_equal(toks, etoks))
        del params, eager
    free(dev)
    with torch.no_grad():
        whole = model.init(seeded(dev))
        with axis_rules(mesh):
            _, ptoks, placed = engine_logits(model, whole, prompts, True)
            out["placed_err"] = (placed - got).abs().max().item()
            out["placed_tokens_equal"] = bool(np.array_equal(ptoks, toks))
            del placed
            out["streams"] = slot_streams(model, whole)
        free(dev)
        _, ptoks, want = engine_logits(model, whole, prompts, True)
        out["one_card_streams"] = slot_streams(model, whole)
    out["err"] = (got - want).abs().max().item()
    out["scale"] = want.abs().max().item()
    out["tokens_equal"] = bool(np.array_equal(toks, ptoks))
    out["tokens"] = toks.tolist()
    return out


def serve_whole(mesh, dev, out_dir):
    """(b) on this rank: SERVE_ARCH whole, f32, params of seed 0 drawn on
    ``mesh`` (``Model.init(mesh=)``): GB of this card's params and the
    init's peak; ``Engine`` (``engine_logits``: tokens, decode_attention
    launches, prefill and decode times; rank 0 writes its sampled logits
    to ``out_dir``/logits.npy for the one-card comparison); the captured
    step against the eager one from one prefilled state
    (``graph_vs_eager``: bit-equal logits, ms, busy, idle, host calls),
    the collectives of one eager step by kind and axis
    (``Collectives``), decode_attention at this card's shape (B 4, KV 10,
    rep 1, hd 128; ``decode_row``); ``ContinuousEngine`` on phase 6b's
    stream under a wall clock (``continuous_run``): its metrics, streams
    and launches; peak GiB."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import axis_rules, full
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    cfg = serve_cfg()
    model = Model(cfg, RunConfig(), dev)
    prompts = serve_prompts(cfg)
    smi = card_of(dev.index)
    out = {"layers": cfg.num_layers, "params": model.param_count()}
    torch.cuda.reset_peak_memory_stats(dev)
    with axis_rules(mesh), torch.no_grad():
        t = time.perf_counter()
        params = model.init(seeded(dev), mesh=mesh)
        sync(dev)
        out["init_s"] = time.perf_counter() - t
        out["params_gb"] = local_gb(params)
        out["init_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        n = da.decode_attention.launches
        eng, toks, got = engine_logits(model, params, prompts, True)
        out["launches"] = da.decode_attention.launches - n
        out["engine"] = dict(eng.last_timing)
        out["replays"] = next(iter(eng._steps.values())).replays
        out["tokens"] = toks.tolist()
        if dist.get_rank() == 0:
            np.save(os.path.join(out_dir, "logits.npy"), got.cpu().numpy())
        del eng, got
        toks1 = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (BATCH, PROMPT + 1)).astype(np.int64)).to(dev)
        cache, tok = prefilled(model, params, toks1)
        bound = out["params_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3
        out["bound_ms"] = bound
        out["graphs"] = graph_vs_eager(
            f"{SERVE_ARCH} whole f32 on {tuple(mesh.shape)}, Engine's "
            f"decode step", model, params, cache, tok, bound,
            lambda scale: 0.0)
        with Collectives(mesh) as calls:
            lg, _ = model.apply(params, tok.to(torch.int32),
                                cache=clone(cache))
            full(lg[:, -1])                 # the engines' gathered logits
        out["calls"] = calls.rows()
        del lg
        del cache
        out["kernel"] = serve_decode_row(
            f"decode_attention [{SERVE_ARCH} on {tuple(mesh.shape)}, a "
            f"card's heads]", cfg.num_kv_heads // mesh.size(1),
            out["launches"], dev, smi)
        eng, snap, launches = continuous_run(model, params, True)
        out["continuous"] = {
            "snapshot": snap, "steps": eng.steps, "launches": launches,
            "results": {str(r): x.tolist() for r, x in eng.results.items()}}
        del eng, params
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


SERVE_PARTS = {"cut": serve_cut, "whole": serve_whole}


def serve_rank(out_dir, parts):
    """``--serve-rank DIR [PART ...]``: one NCCL rank under torchrun (this
    rank's card) of the serving parts (SERVE_PARTS: ``cut`` (a),
    ``whole`` (b)) on the SERVE_MESH mesh of ``launch.mesh.
    make_host_mesh``; prints its record as one ``[serve]`` JSON line (a
    part that raises records its error, after its traceback)."""
    import datetime
    import traceback
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_host_mesh
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "nccl", device_id=dev,
        timeout=datetime.timedelta(seconds=MOE_GROUP_TIMEOUT))
    try:
        mesh = make_host_mesh(model=SERVE_MESH[1], device="cuda")
        rec = {"rank": dist.get_rank(), "card": card_of(local),
               "mesh": list(mesh.shape)}
        for part in parts or SERVE_PARTS:
            t = time.perf_counter()
            try:
                rec[part] = SERVE_PARTS[part](mesh, dev, out_dir)
            except Exception as e:          # reported, with the rank's record
                traceback.print_exc(file=sys.stdout)
                rec[part] = {"error": f"{type(e).__name__}: {e}"[:2000]}
            rec[part]["part_s"] = time.perf_counter() - t
            free(dev)
        print("[serve] " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def serve_cards(cards, parts=tuple(SERVE_PARTS)):
    """The [serve] part of ``--launcher-cards``: the whole model's memory
    reckoned first (``serve_memory``; it fails, with the numbers, where
    the init's peak does not fit a card); one torchrun of ``cards`` NCCL
    ranks, each this script again (``--serve-rank``), running ``parts``
    on SERVE_MESH; then, for (b), the whole model in bf16 on the first
    card alone, teacher-forced on the mesh's tokens, against the logits
    the mesh's Engine sampled from.  Prints each part's lines and holds
    them (``serve_report``)."""
    import tempfile
    sys.path.insert(0, str(ROOT / "src"))
    check(cards == math.prod(SERVE_MESH), f"serve: the mesh {SERVE_MESH} "
          f"needs {math.prod(SERVE_MESH)} cards, not {cards}")
    dev = torch.device("cuda", 0)
    cfg = serve_cfg()
    whole, per_card, peak = serve_memory(cfg, SERVE_MESH)
    room = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"[serve] {card_of(0)}: {SERVE_ARCH} whole, f32: {whole:.2f} GB "
          f"of params, {per_card:.2f} GB a card on {SERVE_MESH}; "
          f"Model.init(mesh=)'s peak reckoned {peak:.2f} GB a card (each "
          f"leaf drawn whole before its piece is kept), + {SERVE_MARGIN_GB:g}"
          f" GB for caches and activations, against the card's {room:.2f} "
          f"GB; one card would need {whole:.2f} GB in f32, "
          f"{whole / 2:.2f} GB in bf16")
    check("whole" not in parts or peak + SERVE_MARGIN_GB <= room,
          f"serve: the whole model's init peak {peak:.2f} GB + "
          f"{SERVE_MARGIN_GB:g} does not fit {room:.2f} GB")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        proc = torchrun(cards, tmp, [str(ROOT / "chip_smoke.py"),
                                     "--serve-rank", tmp, *parts])
        try:
            texts = rank_outputs(proc, cards, tmp,
                                 time.monotonic() + SERVE_TIMEOUT, "serve")
        finally:
            stop(proc)
        seconds = time.perf_counter() - t0
        recs = []
        for r, text in enumerate(texts):
            line = re.search(r"^\[serve\] (\{.*\})$", text, re.M)
            if line is None:
                print(text[-6000:], file=sys.stderr)
            check(bool(line), f"serve: rank {r} printed no record")
            recs.append(json.loads(line.group(1)))
        for line in texts[0].splitlines():
            if line.startswith(("[graphs]", "[timing]", "[continuous]")):
                print("[serve] rank 0 " + line)
        for r, text in enumerate(texts):
            if "Traceback" in text:
                print(f"[serve] rank {r}:\n{text[text.index('Traceback'):]}"
                      [:4000], file=sys.stderr)
        mesh_logits = (np.load(os.path.join(tmp, "logits.npy"))
                       if os.path.exists(os.path.join(tmp, "logits.npy"))
                       else None)
    serve_report(recs, mesh_logits, seconds, dev)


def serve_report(recs, mesh_logits, seconds, dev):
    """Print and hold the ranks' records (``serve_rank``), every part's
    before the first failure is raised; (b)'s logits against the whole
    model in bf16 on ``dev`` (``serve_teacher``)."""
    head = f"[serve] {SERVE_ARCH} on {SERVE_MESH}"
    print(f"{head}: {len(recs)} ranks in {seconds:.1f} s (" + ", ".join(
        f"{p} {recs[0][p]['part_s']:.1f} s" for p in SERVE_PARTS
        if p in recs[0]) + ")")
    failed = []
    for part, report in (("cut", lambda: serve_cut_report(head, recs)),
                         ("whole", lambda: serve_whole_report(
                             head, recs, mesh_logits, dev))):
        if part not in recs[0]:
            continue
        errors = [f"rank {i}: {r[part]['error']}" for i, r in enumerate(recs)
                  if "error" in r[part]]
        try:
            check(not errors, f"serve {part}: {errors[:1]}")
            report()
        except RuntimeError as e:
            print(f"{head} {part}: {e}")
            failed.append(str(e))
    check(not failed, "; ".join(failed))


def serve_cut_report(head, recs):
    """(a): every rank's logits within SERVE_TOL of one card's, its tokens
    one card's and rank 0's, captured bit-equal to eager, decode_attention
    launched a layer a step (replays of the captured step); the engines
    given whole params on the mesh within SERVE_TOL of the mesh-drawn
    ones, with the same tokens, and the slot engines' streams one card's
    and rank 0's."""
    for rec in recs:
        a = rec["cut"]
        print(f"{head} (a) rank {rec['rank']} ({rec['card']}): "
              f"{a['layers']} layers at full width, f32, Engine B "
              f"{BATCH}, {PROMPT} + {GEN} greedy: sampled logits max_abs_diff"
              f" {a['err']:.3e} from one card's (largest magnitude "
              f"{a['scale']:.2f}; bound {SERVE_TOL:g} of it = "
              f"{SERVE_TOL * a['scale']:.3e}); tokens one card's "
              f"{a['tokens_equal']}; captured bit-equal to eager on the "
              f"mesh {a['captured_eq_eager']}; decode_attention launches "
              f"{a['launches']} = {a['layers']} layers x {a['steps']} "
              f"steps ({a['replays']} replays)")
        check(a["err"] <= SERVE_TOL * a["scale"],
              f"serve (a) rank {rec['rank']}: logits {a['err']:.3e}")
        check(a["tokens_equal"] and a["tokens"] == recs[0]["cut"]["tokens"],
              f"serve (a) rank {rec['rank']}: tokens differ")
        check(a["captured_eq_eager"],
              f"serve (a) rank {rec['rank']}: captured != eager")
        check(a["launches"] == a["layers"] * a["steps"]
              and a["replays"] == a["steps"] - 1,
              f"serve (a) rank {rec['rank']}: {a['launches']} launches")
        same = {k: sum(v[r] == a["one_card_streams"][k].get(r)
                       for r in v) for k, v in a["streams"].items()}
        print(f"{head} (a) rank {rec['rank']}: the same params whole on "
              f"each card, placed by the engines: Engine's logits "
              f"max_abs_diff {a['placed_err']:.3e} from the params drawn on"
              f" the mesh (bound {SERVE_TOL:g} of {a['scale']:.2f}), tokens"
              f" the same {a['placed_tokens_equal']}; "
              + "; ".join(f"{k} over {SERVE_SLOT_REQUESTS} requests: "
                          f"{same[k]} of {len(v)} streams one card's"
                          for k, v in a["streams"].items()))
        check(a["placed_err"] <= SERVE_TOL * a["scale"]
              and a["placed_tokens_equal"],
              f"serve (a) rank {rec['rank']}: placed params off by "
              f"{a['placed_err']:.3e}")
        for k, v in a["streams"].items():
            check(len(v) == SERVE_SLOT_REQUESTS
                  and v == a["one_card_streams"][k]
                  and v == recs[0]["cut"]["streams"][k],
                  f"serve (a) rank {rec['rank']}: {k} streams differ from "
                  f"one card's or rank 0's")


def serve_whole_report(head, recs, mesh_logits, dev):
    """(b): every rank's tokens, streams and launches (a layer a step,
    inside the replayed graph), the continuous stream complete on every
    rank; the times beside the weight-bytes bound; then the teacher-forced
    logits against one card in bf16 (``serve_teacher``)."""
    b0 = recs[0]["whole"]
    layers = b0["layers"]
    for rec in recs:
        b = rec["whole"]
        steps = b["engine"]["decode_steps"]
        gr = b["graphs"]
        c = b["continuous"]
        snap = c["snapshot"]
        print(f"{head} (b) rank {rec['rank']} ({rec['card']}): "
              f"{SERVE_ARCH} whole ({b['params']:,} params), f32: "
              f"{b['params_gb']:.2f} GB of params on this card, drawn in "
              f"{b['init_s']:.1f} s (init peak {b['init_peak_gib']:.1f} GiB),"
              f" peak {b['peak_gib']:.1f} GiB; Engine B {BATCH}, {PROMPT} + "
              f"{GEN}: prefill {b['engine']['prefill_s']:.2f} s, decode "
              f"{b['engine']['decode_s'] / steps * 1e3:.1f} ms/step; "
              f"decode_attention {b['launches']} launches = "
              f"{b['launches'] / steps:g} a step x {steps} steps "
              f"({b['replays']} replays)")
        print(f"{head} (b) rank {rec['rank']}: decode step captured "
              f"{gr['captured']['ms']:.2f} ms, eager {gr['eager']['ms']:.1f}"
              f" ms wall, against the weight-bytes bound {b['bound_ms']:.2f}"
              f" ms ({b['params_gb']:.2f} GB / 3.35 TB/s); compute "
              f"kernels captured {gr['captured']['busy']:.2f} ms (compute "
              f"idle share "
              f"{1 - gr['captured']['busy'] / gr['captured']['ms']:.1%}; "
              f"NCCL kernels {gr['captured']['nccl_ms']:.2f} ms, waits "
              f"included), eager {gr['eager']['busy']:.2f} ms (compute idle"
              f" share {1 - gr['eager']['busy'] / gr['eager']['ms']:.1%}; "
              f"NCCL {gr['eager']['nccl_ms']:.2f} ms);"
              f" host launch calls {gr['captured']['calls']:.0f} against "
              f"{gr['eager']['calls']:.0f}; collectives a step (captured in "
              f"the graph): {fmt_calls(b['calls'])}")
        print(f"{head} (b) rank {rec['rank']}: ContinuousEngine, phase 6b's"
              f" stream ({CONT_REQUESTS} requests, {BATCH} slots, wall "
              f"clock): {snap['requests']['completed']} completed, "
              f"{snap['tokens_per_s']:.1f} tok/s; TTFT p50 "
              f"{snap['ttft']['p50'] * 1e3:.1f} ms p99 "
              f"{snap['ttft']['p99'] * 1e3:.1f} ms; TPOT p50 "
              f"{snap['tpot']['p50'] * 1e3:.1f} ms p99 "
              f"{snap['tpot']['p99'] * 1e3:.1f} ms; {c['steps']} batched "
              f"steps, decode_attention {c['launches']} launches")
        check(b["tokens"] == b0["tokens"],
              f"serve (b) rank {rec['rank']}: tokens differ from rank 0's")
        check(b["launches"] == layers * steps
              and b["replays"] == steps - 1,
              f"serve (b) rank {rec['rank']}: {b['launches']} launches, "
              f"{steps} steps, {b['replays']} replays")
        check(snap["requests"]["completed"] == CONT_REQUESTS
              and c["results"] == b0["continuous"]["results"]
              and c["launches"] == layers * c["steps"],
              f"serve (b) rank {rec['rank']}: continuous "
              f"{snap['requests']['completed']} completed, "
              f"{c['launches']} launches, {c['steps']} steps")
    check(mesh_logits is not None, "serve (b): rank 0 wrote no logits")
    serve_teacher(head, np.asarray(b0["tokens"]), mesh_logits, dev)


def serve_teacher(head, tokens, mesh_logits, dev):
    """SERVE_ARCH whole in bf16 (70.4 GB) on ``dev`` alone, params of seed
    0 (each drawn in f32 and cast: the mesh's, rounded), one forward over
    the mesh's ``tokens``: its logits at the positions the mesh's Engine
    sampled from (the prompt's last and each decode step's) against
    ``mesh_logits``, at TOL_BF16_LOGITS of their largest magnitude."""
    from repro_torch.models.model import Model, RunConfig
    free(dev)
    cfg = serve_cfg()
    model = Model(cfg, RunConfig(**BF16_RUN), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with torch.no_grad():
        params = model.init(seeded(dev))
        lg, _ = model.apply(params, torch.from_numpy(
            tokens.astype(np.int64)).to(dev))
        want = lg[:, PROMPT - 1:].float()
        del lg, params
    got = torch.from_numpy(mesh_logits).to(dev).transpose(0, 1)
    check(tuple(got.shape) == tuple(want.shape),
          f"serve (b): mesh logits {tuple(got.shape)}, one card "
          f"{tuple(want.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"{head} (b) {card_of(dev.index)}: the mesh's sampled logits "
          f"(f32, {got.shape[1]} positions of {got.shape[0]} rows) against "
          f"{SERVE_ARCH} whole in bf16 on this one card, teacher-forced on "
          f"the mesh's tokens: max_abs_diff {err:.3e}, largest magnitude "
          f"{scale:.2f} (gate {TOL_BF16_LOGITS:g} of it = "
          f"{TOL_BF16_LOGITS * scale:.3f}); one card: peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB, "
          f"{time.perf_counter() - t:.1f} s")
    check(bool(torch.isfinite(got).all()), "serve (b): non-finite logits")
    check(err <= TOL_BF16_LOGITS * scale, f"serve (b): {err:.3e} from one "
          f"card's bf16 logits")
    del got, want
    free(dev)


def dist_ranks():
    """14g, host only: DIST_RANKS gloo CPU ranks on this machine's torch
    (this script again, ``--mesh-rank``, with no card visible) run
    ``mesh_rank``, and DIST_RANKS more run the launcher under torchrun,
    while this process runs the same steps without a mesh; each rank is
    held to those at DIST_RANK_TOL."""
    import pickle
    import tempfile
    from repro_torch.models.model import Model, RunConfig
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    payload = {}
    for arch in DIST_RANK_ARCHS:
        cfg = rank_cfg(arch)
        params = Model(cfg, RunConfig(max_seq=64), device="cpu").init(
            torch.Generator().manual_seed(1))
        batches = []
        for _ in range(DIST_RANK_STEPS):
            t = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
            batches.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                            "mask": np.ones((4, 8), np.float32)})
        payload[arch] = {"params": tree_numpy(params), "batches": batches}
    m, n, k = DIST_RANK_GEMM
    payload["gemm"] = tuple(rng.standard_normal(s).astype(np.float32)
                            for s in ((m, k), (k, n), (m, n)))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        logs = os.path.join(tmp, "launch")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--mesh-rank", str(r), tmp], env=env)
                 for r in range(DIST_RANKS)]
        t_launch = time.perf_counter()
        procs.append(start_launcher(DIST_RANKS, "cpu", logs))
        deadline = time.monotonic() + DIST_RANK_TIMEOUT
        try:
            # the runs without a mesh, while the ranks run
            t = time.perf_counter()
            want = {arch: rank_steps(rank_cfg(arch),
                                     payload[arch]["params"],
                                     payload[arch]["batches"])
                    for arch in DIST_RANK_ARCHS}
            want["gemm"] = rank_gemm(*payload["gemm"])
            want["launch"] = plain_launch("cpu")
            plain_s = time.perf_counter() - t
            for proc in procs[:-1]:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            launched = launcher_result(procs[-1], DIST_RANKS, logs, deadline)
            launch_s = time.perf_counter() - t_launch
        except subprocess.TimeoutExpired:
            check(False, f"14g: {DIST_RANKS} ranks past {DIST_RANK_TIMEOUT} s")
        finally:
            for proc in procs:
                stop(proc)
        codes = [proc.returncode for proc in procs[:-1]]
        check(codes == [0] * DIST_RANKS, f"14g: rank exit codes {codes}")
        got = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
    head = (f"[dist] 14g host only ({DIST_RANKS} gloo CPU ranks, torch "
            f"{torch.__version__}, not the card)")
    for arch in DIST_RANK_ARCHS:
        w = want[arch]
        rel = max(abs(a - b) / abs(b) for g in got
                  for a, b in zip(g[arch]["losses"], w["losses"]))
        share = max(worst_share(g[arch]["params"], w["params"],
                                DIST_RANK_TOL) for g in got)
        ep = [g[arch]["ep"] for g in got]
        moe = rank_cfg(arch).moe is not None
        print(f"{head}: {arch} reduced, mesh {DIST_RANK_MESH}, "
              f"{DIST_RANK_STEPS} SGD steps"
              + (f" (MoE expert-parallel: {all(ep)})" if moe else "")
              + f": losses {fmt_losses(got[0][arch]['losses'])} against "
              f"{fmt_losses(w['losses'])} without a mesh (worst relative "
              f"difference {rel:.2e}, bound {DIST_RANK_TOL:g}); params at "
              f"{share:.3g} of the bound; "
              f"{max(g[arch]['s'] for g in got):.1f} s")
        check(len(got[0][arch]["losses"]) == DIST_RANK_STEPS
              and rel <= DIST_RANK_TOL and share <= 1,
              f"14g {arch}: losses {rel:.2e}, params {share:.3g}")
        check(all(ep) or not moe, f"14g {arch}: not expert-parallel")
    share = max(worst_share(g["gemm"], want["gemm"], DIST_RANK_TOL)
                for g in got)
    print(f"{head}: sharded_gemm_op {'x'.join(map(str, DIST_RANK_GEMM))} on "
          f"mesh {DIST_RANK_MESH} (lhs Shard(0) over data) against gemm_op: "
          f"output and both gradients at {share:.3g} of the bound; "
          f"{max(g['gemm']['s'] for g in got):.1f} s")
    check(share <= 1, f"14g sharded_gemm_op: {share:.3g}")
    launcher_check(head, launched, want["launch"], launch_s)
    print(f"[dist] 14g: {time.perf_counter() - t0:.1f} s (the runs without a "
          f"mesh {plain_s:.1f} s of it, beside the ranks)")


def fmt_losses(losses):
    return ", ".join(f"{x:.6f}" for x in losses)


def tree_numpy(tree):
    """A dict tree of tensors (DTensors gathered whole) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    return tree.detach().cpu().numpy()


def dist_phase(dev, flush, smi, p13):
    """Phase 14 [dist]: 14a-14e and 14h on the 1-rank NCCL mesh, then the
    NCCL group ends, 14f runs on a fake one and 14g in gloo CPU ranks.
    Returns 14b's and 14h's JSON rows."""
    t0 = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t
        return out
    mesh = timed("14a", dist_train, dev, smi, p13)
    rows = timed("14b", dist_gemm, mesh, dev, flush, smi)
    timed("14c", dist_moe, mesh, dev, smi)
    timed("14d", dist_compress, mesh, dev, smi)
    timed("14e", dist_failover, mesh, dev, smi)
    rows += timed("14h", dist_serve, mesh, dev, smi)
    torch.distributed.destroy_process_group()
    timed("14f", dist_dryrun)
    timed("14g", dist_ranks)
    print(f"[dist] phase 14: {time.perf_counter() - t0:.1f} s (" +
          ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    return rows


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def compile_repaired(dev):
    """Phase 6c's kernels, each one the port once refused: an f16 GEMM
    (qwen2-7b's up product, f32 output) and a kernel whose matmul scratch
    exceeds a block's shared memory, both through compile_traced; a
    batched product with a rank-3 matmul tile through backend_cuda.emit on
    its LoopIR (no traced graph has rank-3 tiles).  Returns (label, fn,
    inputs, bound, (library name, library call or None, what to print
    when there is none)) tuples."""
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
                             BF16_FLOP_PER_S),
                gemm_library(ck.run_cuda.plan, *xs)))
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
                ("library", None, "library none")))
    b, mm, kk = RANK3
    fn = backend_cuda.emit(ir_text.parse_ir(RANK3_TEXT), device=str(dev))
    check(fn.plan is None, "rank-3 kernel: not the general path")
    xs = [torch.randn(s, generator=gen, device=dev)
          for s in ((b, mm, kk), (kk, kk))]
    out.append(("stagecc_general batched (4, 512, 512) @ (512, 512), "
                "rank-3 tiles", fn, xs,
                roofline((2 * b * mm * kk + kk * kk) * 4, 2 * b * mm * kk * kk,
                         F32_FLOP_PER_S),
                ("torch.matmul", lambda xs=xs: torch.matmul(*xs), None)))
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
    for label, fn, xs, (bound, bound_by), (lib_name, library, why) in \
            repaired:
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
            # an emitted GEMM against its library call at phase 8's f32
            # bound (K 3584: another sum order)
            lt = GEMM_F32 if fn.plan is not None else (rtol, atol)
            lib_share = share_of(library(), got.float(), *lt)
            print(f"[repaired] {label}: {lib_name} vs the kernel at "
                  f"{lib_share:.3g} of rtol {lt[0]:g} atol {lt[1]:g}")
            check(lib_share <= 1, f"{label}: {lib_name} differs")
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
        lib = (why if library is None
               else f"{lib_name} {row['library_ms']:.3f} ms")
        print(f"[timing] {label}, cold L2: kernel {row['ms']:.3f} ms, bound "
              f"{bound:.4f} ms ({bound_by}), plain {row['plain_ms']:.3f} ms, "
              f"{lib}; card {smi}")
        rows.append(row)
        del got, want
    return rows


# phase 11b: the search and system layer's driver, each in a subprocess
# of its own: the whole stack to Verilog, a host-coupled transaction, a
# small design-space exploration
REPROC_RUNS = (["--emit=verilog"],
               ["--gemm", "8x8x8", "--pipeline", "lower", "--simulate",
                "host"],
               ["--gemm", "8x8x8", "--epilogue", "none", "--dse", "2"])
# runs the driver as ``python -m`` does, then fails if it imported jax
REPROC_MAIN = ("import runpy, sys\n"
               "code = 0\n"
               "try:\n"
               "    runpy.run_module('repro_torch.core.reproc', "
               "run_name='__main__')\n"
               "except SystemExit as e:\n"
               "    code = e.code\n"
               "sys.exit(code or (3 if 'jax' in sys.modules else 0))\n")


# ---- phase 15: the raising entry point ------------------------------------


def compile_raised(dev):
    """Phase 15's compiles (at phase 2, so the stage sources build with
    the others): every block of the RAISED configs raised from traced
    PyTorch, each config's compile plan on the card (which keeps each
    compiled block's artifact), and qwen2-7b's full-width MLP block raised
    and compiled in the plan's candidate order.  The MLP's params are
    drawn on the host (they become the raised graph's constants); nothing
    stays on the card."""
    import importlib
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.serve import compiled as sc
    raising = importlib.import_module("repro_torch.core.raise")
    t0 = time.perf_counter()
    reports = {a: raising.raise_model_blocks(a) for a in RAISED}
    plans = {a: sc.plan_blocks(a, device=str(dev)) for a in RAISED}
    blocks = []
    for arch, plan in plans.items():
        reps = {r.block: r for r in reports[arch]}
        blocks += [(arch, reps[c.block], c, c.kernel)
                   for c in plan.compiled if c.cuda]
    t1 = time.perf_counter()
    cfg = get_config(ARCH)
    params = L.init_mlp(cfg, L.Maker("init", torch.Generator().manual_seed(
        0), device="cpu"))
    rg = raising.raise_fx(lambda x: L.apply_mlp(params, x, cfg),
                          (*RAISED_MLP, cfg.d_model), name="qwen2_7b.mlp")
    label, ck, refusals = sc.compile_first(rg, device=str(dev),
                                           want_torch=False)
    for r in refusals:
        print(f"[raise] 15b: passed over {r}")
    check(ck is not None, f"qwen2_7b.mlp at full width: no schedule "
          f"compiles ({'; '.join(refusals)})")
    check(ck.run_cuda is not None, f"qwen2_7b.mlp at full width: the "
          f"general emitter refuses {label}")
    mlp = (label, rg, ck, params)
    print(f"[compile] raise: {sum(len(r) for r in reports.values())} blocks "
          f"of {', '.join(RAISED)} raised and planned, {len(blocks)} "
          f"compiled with a CUDA emission, in {t1 - t0:.2f}s; qwen2_7b.mlp "
          f"at {RAISED_MLP[0]} x {RAISED_MLP[1]} tokens x d_model "
          f"{cfg.d_model} (d_ff {cfg.d_ff}) raised ({len(rg.graph.ops)} ops)"
          f" and compiled ({mlp[0]}, {len(mlp[2].run_cuda.stages)} stages) "
          f"in {time.perf_counter() - t1:.2f}s")
    sources = [b[3].run_cuda.source for b in blocks]
    return {"reports": reports, "plans": plans, "blocks": blocks,
            "mlp": mlp, "sources": sources + [mlp[2].run_cuda.source]}


def raise_phase(raised, dev, flush, smi):
    """Phase 15: (a) the raised blocks' raisability and compile plans
    against the reference's, then each compiled block's run_cuda; (b)
    qwen2-7b's full-width MLP block through run_cuda.  Both are driven once
    with the stage launch count reset and read just after; then each is
    held to run_ref and its plain version, and timed.  Returns the JSON
    rows."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import backend_cuda
    from repro_torch.kernels import gemm
    from repro_torch.models import layers as L
    t0 = time.perf_counter()

    # 15a: raisability and the plans, as the reference gives them
    for arch, (ok, blocked) in RAISED.items():
        reps = raised["reports"][arch]
        got_ok = tuple(r.block for r in reps if r.ok)
        got_blocked = {r.block: r.error.split("[primitive: ")[1].split("]")[0]
                       for r in reps if not r.ok}
        print(f"[raise] 15a {arch}: raised {', '.join(got_ok)}; blocked "
              + (", ".join(f"{b} ({op})" for b, op in got_blocked.items())
                 or "none"))
        check(got_ok == ok and got_blocked == blocked,
              f"{arch}: raisability {got_ok} {got_blocked}, expected "
              f"{ok} {blocked}")
        plan = raised["plans"][arch]
        print(plan.describe())
        rows = tuple((c.block, c.status, c.schedule, c.cycles, c.cuda)
                     for c in plan.choices)
        check(rows == PLAN_ROWS[arch], f"{arch}: plan rows {rows}")

    # the path: each compiled block's run_cuda and the full-width MLP's,
    # once, with the stage launch count reset just before
    label, rg, ck, params = raised["mlp"]
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (*RAISED_MLP, rg.arg_shapes[0][-1])).astype(np.float32))
    bound = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in rg.bind(x)]
    torch.cuda.synchronize()
    backend_cuda.emit_general.launches = 0
    gemm_before = gemm.cuda_gemm.launches
    outs, counts = [], []
    for arch, rep, c, bck in raised["blocks"]:
        before = backend_cuda.emit_general.launches
        outs.append(rep.raised.run_compiled(bck, *rep.example_inputs,
                                            backend="cuda"))
        counts.append(backend_cuda.emit_general.launches - before)
    before = backend_cuda.emit_general.launches
    full = ck.run_cuda(*bound)
    torch.cuda.synchronize()
    mlp_count = backend_cuda.emit_general.launches - before
    total = backend_cuda.emit_general.launches
    want = [len(b[3].run_cuda.stages) for b in raised["blocks"]]
    print(f"[raise] emit_general stage launches {counts} per raised block "
          f"(stages {want}), {mlp_count} for the full-width MLP "
          f"({len(ck.run_cuda.stages)} stages), {total} in all; cuda_gemm "
          f"launches moved by {gemm.cuda_gemm.launches - gemm_before}")
    check(counts == want and mlp_count == len(ck.run_cuda.stages)
          and total == sum(want) + mlp_count and total > 0,
          f"stage launches {counts} + {mlp_count}, expected {want}")

    rows = []
    rtol, atol = TOL_COMPILED
    for (arch, rep, c, bck), (got,), count in zip(raised["blocks"], outs,
                                                  counts):
        name = f"stagecc_general raised {arch}.{c.block} float32"
        (want_ref,) = rep.raised.run_ref(*rep.example_inputs)
        xs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in rep.raised.bind(*rep.example_inputs)]
        plain = backend_cuda.general_plain(bck.run_cuda, *xs)
        torch.cuda.synchronize()
        got_t = torch.from_numpy(got)
        plain_t = plain.cpu().reshape(got_t.shape)
        ref_t = torch.from_numpy(np.ascontiguousarray(want_ref))
        check(bool(torch.isfinite(got_t).all()), f"{name}: non-finite")
        err = (got_t - plain_t).abs().max().item()
        shares = {"run_ref": share_of(got_t, ref_t, rtol, atol),
                  "plain": share_of(got_t, plain_t, rtol, atol)}
        print(f"[raise] {name} ({c.schedule}, {count} stages, modelled "
              f"{c.cycles} cycles on TPU_V5E): max_abs_err {err:.3e} vs "
              f"general_plain; worst element at {shares['run_ref']:.3g} of "
              f"rtol {rtol:g} atol {atol:g} vs run_ref, "
              f"{shares['plain']:.3g} vs general_plain")
        library = None
        if c.block == "rmsnorm":
            # the block is F.rms_norm with weight 1 + w, the d-wide
            # constant the raiser folds
            d = rep.raised.arg_shapes[0][-1]
            (wt,) = [t.reshape(d) for t in xs[rep.raised.n_args:]
                     if t.numel() == d]
            eps = reduced(get_config(arch)).norm_eps
            x2 = xs[0].reshape(-1, d)

            def library(x2=x2, d=d, wt=wt, eps=eps):
                return F.rms_norm(x2, (d,), weight=wt, eps=eps)
            shares["rms_norm"] = share_of(got_t, library().cpu().reshape(
                got_t.shape), rtol, atol)
        check(max(shares.values()) <= 1, f"{name}: off its bounds {shares}")
        fn = bck.run_cuda
        flops = sum(st.flops for st in fn.stages)
        nbytes = sum(t.numel() * 4 for t in xs) + got_t.numel() * 4
        b, by = roofline(nbytes, flops, F32_FLOP_PER_S)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/stagecc_stage.cuh",
                     "replaces": "src/repro/core/backend_pallas.py:402",
                     "launches": count, "max_abs_err": err,
                     "ms": time_ms(lambda: fn(*xs), flush, iters=5),
                     "plain_ms": time_ms(lambda: backend_cuda.general_plain(
                         fn, *xs), flush, iters=3, warm=1),
                     "bound_ms": b, "bound_by": by,
                     "library_ms": (None if library is None else
                                    time_ms(library, flush, iters=5))})
        if library is not None:
            print(f"[raise] {name}: F.rms_norm on the same inputs "
                  f"{rows[-1]['library_ms']:.4f} ms (worst element at "
                  f"{shares['rms_norm']:.3g} of its bound), run_cuda "
                  f"{rows[-1]['ms']:.4f} ms; card {smi}")
    for arch, plan in raised["plans"].items():
        for c in plan.compiled:
            if not c.cuda:
                print(f"[raise] {arch}.{c.block}: compiled ({c.schedule}) "
                      f"with no CUDA emission, as the reference has no "
                      f"Pallas one: both emitters refuse its interior "
                      f"@grid loop")

    # 15b: the full-width MLP block against apply_mlp, run_ref and its
    # plain version
    cfg = get_config(ARCH)
    p_dev = {k: v.to(dev) for k, v in params.items()}
    x_dev = x.to(dev)
    with torch.no_grad():
        lib = L.apply_mlp(p_dev, x_dev, cfg)
    got = full.reshape(lib.shape)
    (want_ref,) = rg.run_ref(x)
    plain = backend_cuda.general_plain(ck.run_cuda, *bound)
    torch.cuda.synchronize()
    name = (f"stagecc_general raised qwen2_7b.mlp {RAISED_MLP[0]}x"
            f"{RAISED_MLP[1]}x{cfg.d_model} d_ff {cfg.d_ff} float32")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    g_rtol, g_atol = GEMM_F32
    shares = {"apply_mlp": share_of(got, lib, g_rtol, g_atol),
              "run_ref": share_of(got.cpu(), torch.from_numpy(want_ref),
                                  g_rtol, g_atol),
              "plain": share_of(got, plain.reshape(lib.shape), g_rtol,
                                g_atol)}
    err = (got - plain.reshape(lib.shape)).abs().max().item()
    print(f"[raise] 15b {name} ({label}): max_abs_err {err:.3e} vs "
          f"general_plain; worst element at {shares['apply_mlp']:.3g} of "
          f"rtol {g_rtol:g} atol {g_atol:g} vs apply_mlp (TF32 off), "
          f"{shares['run_ref']:.3g} vs run_ref, {shares['plain']:.3g} vs "
          f"general_plain (max |diff| vs apply_mlp "
          f"{(got - lib).abs().max().item():.3e})")
    check(max(shares.values()) <= 1, f"{name}: off its bounds {shares}")
    del plain, lib
    fn = ck.run_cuda
    m, d = RAISED_MLP[0] * RAISED_MLP[1], cfg.d_model
    flops = 3 * 2 * m * d * cfg.d_ff
    nbytes = sum(t.numel() * 4 for t in bound) + got.numel() * 4
    b, by = roofline(nbytes, flops, F32_FLOP_PER_S)
    stage_flops = sum(st.flops for st in fn.stages)
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/stagecc_stage.cuh",
           "replaces": "src/repro/core/backend_pallas.py:402",
           "launches": mlp_count, "max_abs_err": err,
           "ms": time_ms(lambda: fn(*bound), flush, iters=5),
           "plain_ms": time_ms(lambda: backend_cuda.general_plain(
               fn, *bound), flush, iters=2, warm=1),
           "bound_ms": b, "bound_by": by,
           "library_ms": time_ms(lambda: L.apply_mlp(p_dev, x_dev, cfg),
                                 flush, iters=10)}
    env = fn.environment(*bound)
    for st in fn.stages:
        st(env)
    for st in fn.stages:
        ms = time_ms(lambda st=st: st(env), flush, iters=3, warm=1)
        sb, sby = roofline(st.hbm_bytes, st.flops, F32_FLOP_PER_S)
        print(f"[timing] {name} stage {st.index}: {st.layout}, cold L2: "
              f"{ms:.3f} ms, bound {sb:.4f} ms ({sby}: "
              f"{st.hbm_bytes / 1e6:.1f} MB, {st.flops / 1e9:.3f} GFLOP)")
    del env
    print(f"[timing] {name}, cold L2: run_cuda {row['ms']:.3f} ms per call "
          f"({mlp_count} stage launches), bound {b:.3f} ms ({by}: "
          f"{flops / 1e9:.1f} GFLOP of the three products at 67 TFLOP/s f32 "
          f"= 3 x {flops / 3 / F32_FLOP_PER_S * 1e3:.3f} ms a product; "
          f"{nbytes / 1e6:.1f} MB of inputs and output; the stages count "
          f"{stage_flops / 1e9:.1f} GFLOP), apply_mlp (torch.matmul, TF32 "
          f"off) {row['library_ms']:.3f} ms, general_plain "
          f"{row['plain_ms']:.3f} ms; card {smi}")
    rows.append(row)
    del bound, full, got, p_dev, x_dev
    torch.cuda.empty_cache()
    print(f"[raise] phase 15: {time.perf_counter() - t0:.1f} s (its raising, "
          f"compiles and builds ran in phase 2)")
    return rows


def reproc_phase():
    """Phase 11b: ``python -m repro_torch.core.reproc`` three times, in
    parallel subprocesses, on this machine, which has no JAX: each must
    exit 0 without importing jax.  The DSE's cache goes to build/, inside
    the checkout."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "STAGECC_DSE_CACHE": str(ROOT / "build" / "dse-cache")}
    jax_here = importlib.util.find_spec("jax") is not None
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", REPROC_MAIN, *argv],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in REPROC_RUNS]
    for argv, proc in zip(REPROC_RUNS, procs):
        out, err = proc.communicate(timeout=600)
        lines = out.strip().splitlines()
        print(f"[reproc] {' '.join(argv)}: exit {proc.returncode}, "
              f"{len(lines)} lines; last: {lines[-1][:100] if lines else ''}")
        check(proc.returncode == 0,
              f"reproc {argv} exited {proc.returncode}: {err[-2000:]}")
    print(f"[reproc] {len(procs)} runs in {time.perf_counter() - t0:.1f} s, "
          f"none imported jax (jax installed here: {jax_here})")


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
    cli.add_argument("--mesh-rank", nargs=2, metavar=("RANK", "DIR"),
                     help="phase 14g's gloo CPU rank RANK over DIR (the "
                          "smoke starts these itself)")
    cli.add_argument("--launcher-cards", type=int, metavar="N",
                     help="run only the launcher's reduced comparison "
                          "and qwen2-7b whole through the launcher's "
                          "torchrun on N cards of this machine (NCCL), "
                          "then the crossbar, the checkpoints, "
                          "deepseek-v2's parts and the serving parts on "
                          "them")
    cli.add_argument("--cards-rank", action="store_true",
                     help="one rank of --launcher-cards (the smoke starts "
                          "these itself, under torchrun)")
    cli.add_argument("--moe-rank", nargs="+", metavar="ARG",
                     help="DATA MODEL [PART ...]: one rank of the "
                          "deepseek-v2 parts (the smoke starts these "
                          "itself, under torchrun)")
    cli.add_argument("--serve-rank", nargs="+", metavar="ARG",
                     help="DIR [PART ...]: one rank of the serving parts "
                          "on four cards (the smoke starts these itself, "
                          "under torchrun)")
    opts = cli.parse_args()
    if opts.serve_rank:
        serve_rank(opts.serve_rank[0], opts.serve_rank[1:])
        return 0
    if opts.cards_rank:
        cards_rank()
        return 0
    if opts.moe_rank:
        moe_rank(int(opts.moe_rank[0]), int(opts.moe_rank[1]),
                 opts.moe_rank[2:])
        return 0
    if opts.launcher_cards:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        launcher_cards(opts.launcher_cards)
        moe_cards(opts.launcher_cards)
        serve_cards(opts.launcher_cards)
        print(f"[cards] every part passed in {time.perf_counter() - t0:.1f}"
              f" s")
        return 0
    if opts.mesh_rank:
        sys.path.insert(0, str(ROOT / "src"))
        mesh_rank(int(opts.mesh_rank[0]), DIST_RANKS, opts.mesh_rank[1])
        return 0
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
    t_start = time.perf_counter()
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
    autos = compile_autos(dev)
    raised = compile_raised(dev)
    sources = sorted({ck.run_cuda.source for _, _, ck in gemms + autos}
                     | {fn.source for fn in dist_gemm_products(*DIST_GEMM)})
    general = [ck.run_cuda.source for *_, ck in compiled]
    general += [fn.source for _, fn, *_ in repaired]
    general += raised["sources"]
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
          f"general emitter's, the repaired kernels' of phase 6c and the "
          f"raised blocks' of phase 15), one nvcc each, in parallel: "
          f"{time.perf_counter() - t0:.1f}s")

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
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    warm = throughput_stats(eng, prompts, GEN)
    print(f"[serve] warm rerun (captured decode steps): prefill "
          f"{warm['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{warm['decode_tok_per_s']:.1f} tok/s "
          f"({warm['decode_s'] / GEN * 1e3:.2f} ms/step)")
    eager_warm = engines_agree("serve", model, params, prompts, eng)

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        BATCH, PROMPT + 4)).astype(np.int64)).to(dev)
    plain = Model(cfg, RunConfig(backend="torch"), dev)
    with torch.no_grad():
        busy, window, rows, _ = profile_decode(eng, toks)
        step_ms = eager_warm["decode_s"] / GEN * 1e3
        if busy is None:
            print("[profile] decode step device time: not measured (the "
                  "profiler recorded no device time)")
        else:
            print(f"[profile] eager decode step: device busy {busy:.2f} ms of "
                  f"{window:.2f} ms wall in the same profiled window (idle "
                  f"share {1 - busy / window:.1%}); of {step_ms:.2f} ms in "
                  f"the eager Engine's unprofiled warm rerun, idle share "
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
        graph_vs_eager("float32 Engine", model, params,
                       *prefilled(model, params, toks),
                       model.param_count() * 4 / HBM_BYTES_PER_S * 1e3,
                       lambda scale: TOL_BACKENDS)

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
    cont_launches = continuous_phase(cfg, bmodel, bparams, dev,
                                     raised["plans"]["qwen2_7b"])
    del bmodel, bparams
    torch.cuda.empty_cache()

    # 6c. the repaired emitters
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    rows = repaired_phase(repaired, flush, smi)
    del repaired
    torch.cuda.empty_cache()

    # 6d. the recurrent and MoE families at their published widths
    rows += family_phase(dev, flush, smi)
    # 6e. the stub frontends: whisper-base and pixtral-12b, whole
    rows += frontend_phase(dev, flush, smi)

    # 7. time per launch beside the bound, the plain version and SDPA
    rows += decode_phase(dev, flush, smi, launches, errs[torch.float32])
    rows += serving_decode_rows(dev, flush, smi, bf16_launches,
                                cont_launches, errs[torch.bfloat16])
    torch.cuda.empty_cache()

    # 8. the compiled-GEMM path; 8b. the searched GEMM (cuda_auto)
    rows += gemm_phase(gemms, dev, flush, smi)
    rows += auto_phase(autos, dev, flush, smi)
    torch.cuda.empty_cache()

    # 9. blocked attention; 10. the SSD scan
    rows += attention_phase(dev, flush, smi)
    torch.cuda.empty_cache()
    rows += ssd_phase(dev, flush, smi)
    torch.cuda.empty_cache()

    # 11. the compiled serving kernels through the general emitter
    rows += compiled_phase(compiled, dev, flush, smi)
    # 11b. the search and system layer's driver, without jax
    reproc_phase()

    # 13. training: minicpm-2b whole through the launcher, then the
    # equality checks at two layers
    p13 = train_phase(dev, smi)

    # 14. the distribution layer: the mesh trainer, the sharded GEMM, the
    # expert-parallel MoE, the int8 all-reduce, failover, the dry run
    rows += dist_phase(dev, flush, smi, p13)

    # 15. the raising entry point: raised blocks through the stage kernels
    rows += raise_phase(raised, dev, flush, smi)

    print(f"[smoke] every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    # 12. every kernel's row
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
