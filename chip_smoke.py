#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. compile qwen2-7b's MLP products (repro_torch.core.compile_gemm) and
     the four serving-kernel graphs of phase 11 through the compiler stack,
     then build every CUDA kernel, one nvcc per source, all at once:
     decode_attention, flash_attention and ssd_scan from
     src/repro_torch/kernels/csrc/, the emitted GEMMs and the general
     emitter's four sources;
  3. decode_attention against its plain PyTorch version at the serving
     path's shapes, in float32 and bfloat16;
  4. serve qwen2-7b at full width (random weights from a seed) through
     repro_torch.launch.serve.main, counting the kernel's launches, then
     profile a few decode steps for the device's busy time;
  5. the full-width decode step with the kernels against the plain versions;
  6. full-width prefill + decode against one full forward (teacher forcing);
  7. decode_attention's time per launch beside its bound, its plain
     version's time and one PyTorch library call's time;
  8. the compiled-GEMM path: the MLP products through the emitted kernels
     and a gemm_op forward and backward, counting the launches; each
     against its plain version, then timed like phase 7;
  9. blocked attention through repro_torch.kernels.ops.attention (backend
     "cuda", the flash_attention kernel) at qwen2-7b's widths (causal) and
     gemma3-4b's (causal, local window 1024), f32 and bf16, counting the
     launches; each against its plain version and SDPA, then timed;
 10. the Mamba-2 SSD scan through ops.ssd (backend "cuda", the ssd_scan
     kernel) at mamba2-130m's widths, f32 and bf16, likewise, and against
     ops.ssd's "torch" backend;
 11. the compiled serving kernels: the flash graph at qwen2-7b's (causal)
     and gemma3-4b's (window 1024) widths, the decode graph at the serving
     shapes and the SSD graph at mamba2-130m's, compiled through
     repro_torch.core.compile_traced and run through run_cuda (the general
     emitter's per-nest kernels), counting the stage launches; each held to
     its plain version, a float64 oracle and the hand kernel on the same
     slice, then timed per call and per stage;
 12. a JSON line with the rows of phases 7-11.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
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
# the peak of the inputs' type: the attention and SSD kernels compute in
# f32 whatever their inputs, but a bound holds bf16 work to the bf16 rate
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
HAND_KERNELS = ("decode_attention", "flash_attention", "ssd_scan")
# The compiled serving kernels (phase 11), one (batch, head) slice each,
# at the schedules whose every stage traces at most 4096 statements:
# (label, graph kind, dims, window / valid, pipeline).  grid{vars=N} maps
# only the first nest to the grid, so the later nests run as one block.
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def time_ms(fn, flush: torch.Tensor, iters: int = 50, warm: int = 3) -> float:
    """Mean device time of one call with the L2 cache cold, as a decode
    step finds it (each layer's MLP weights stream through L2 between two
    attention calls).  CUDA events around each call; a 256 MiB write
    before each evicts the 50 MB L2."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
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
    """Device time per decode step, from torch.profiler's kernel times
    over a few steps, the wall time per step of that same window (the
    profiler slows the host, so it is longer than an unprofiled step), and
    the largest kernels (ms per step, launches per step, name).  Returns
    (busy ms per step or None where the profiler records no device time,
    window ms per step, rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = eng.model.cache_init(BATCH, PROMPT + GEN + 1)
    logits, cache = eng.prefill(eng.params, cache, toks[:, :PROMPT])
    tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = eng.decode(eng.params, cache, tok)
            tok = logits.argmax(-1, keepdim=True)
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


def attention_phase(dev, flush, smi):
    """Phase 9: drive ops.attention (backend "cuda") once per case with the
    launch count reset, then hold each result to the plain version and to
    SDPA, and time it.  Returns the JSON rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
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
    outs, counts = [], []
    for cfg, seq, window, dtype, (q, k, v) in cases:
        before = fa.flash_attention.launches
        outs.append(ops.attention(q, k, v, causal=True, window=window,
                                  backend="cuda"))
        counts.append(fa.flash_attention.launches - before)
    torch.cuda.synchronize()
    total = fa.flash_attention.launches
    print(f"[attention] flash_attention launches {total} = {len(cases)} "
          f"ops.attention calls")
    check(counts == [1] * len(cases) and total == len(cases),
          f"flash_attention launched {counts} per call, {total} in all")

    rows = []
    for (cfg, seq, window, dtype, (q, k, v)), got, count in zip(
            cases, outs, counts):
        B, H, _, hd = q.shape
        name = (f"flash_attention {cfg.name} B={B} H={H} S={seq} hd={hd} "
                f"causal window={window} {str(dtype)[6:]}")
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
                ref.attention_mask(seq, seq, True, window, dev))

        def library(q=q, k=k, v=v, mask=mask):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None)

        lib_err = (library().float() - got.float()).abs().max().item()
        # the same function: a wrong mask or scale moves outputs by O(0.1)
        check(lib_err <= TOL_BF16, f"{name}: SDPA differs by {lib_err}")
        print(line + f"; SDPA vs kernel {lib_err:.1e}")
        nbytes, flops = flash_work(q, k, True, window)
        bound, bound_by = roofline(nbytes, flops, PEAK[dtype])
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:34",
               "launches": count, "max_abs_err": err,
               "ms": time_ms(lambda: ops.attention(
                   q, k, v, backend="cuda", **kw), flush, iters=10),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                   q, k, v, **kw), flush, iters=10),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": time_ms(library, flush, iters=10)}
        rows.append(row)
        print(f"[timing] {name}, cold L2: kernel {row['ms']:.3f} ms, bound "
              f"{bound:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP of unmasked pairs; at the f32 "
              f"CUDA-core rate the kernel computes in, "
              f"{flops / F32_FLOP_PER_S * 1e3:.3f} ms), plain "
              f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.3f} ms; "
              f"card {smi}")
    return rows


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
    return rows


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
        grids = [list(st.grid) for st in ck.run_cuda.stages]
        print(f"[compile] stagecc_general {label}: {ck.name}, {pipe}; "
              f"{len(grids)} stages, grids {grids}; compiled in "
              f"{time.perf_counter() - t0:.2f}s")
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
            print(f"[timing] {name} stage {st.index}: grid "
                  f"{list(st.grid)} ({st.programs} blocks of {st.threads} "
                  f"threads), cold L2: {ms:.3f} ms, bound {b:.4f} ms ({by}: "
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


def gemm_phase(gemms, dev, flush, smi):
    """Phase 8: drive the compiled-GEMM path with the launch count reset,
    then hold each result to its plain version and time it.  Returns the
    JSON rows."""
    from repro_torch.core import backend_cuda, compile_gemm, integrate
    from repro_torch.kernels import gemm
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {prod: [torch.randn(s, generator=gen, device=dev)
                   for s in ((m, k), (k, n), (n,))]
            for prod, (m, n, k) in MLP.items()}
    args = [[x.to(dtypes[ck.run_cuda.plan.dtypes[b]]) for b, x in
             zip(ck.run_cuda.plan.in_buffers, data[prod])]
            for prod, _, ck in gemms]
    m, n, k = GEMM_OP
    x, y, w = (torch.randn(s, generator=gen, device=dev)
               for s in ((m, k), (k, n), (m, n)))
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()

    # the path: every product once, then gemm_op forward and backward
    gemm.cuda_gemm.launches = 0
    outs, counts = [], []
    for (_, _, ck), a in zip(gemms, args):
        before = gemm.cuda_gemm.launches
        outs.append(ck.run_cuda(*a))
        counts.append(gemm.cuda_gemm.launches - before)
    op = integrate.gemm_op(m, n, k, backend="cuda")
    (op(xg, yg) * w).sum().backward()
    torch.cuda.synchronize()
    total = gemm.cuda_gemm.launches
    print(f"[gemm] cuda_gemm launches {total} = {len(gemms)} products + "
          f"gemm_op {m}x{n}x{k} forward 1 and backward 2")
    check(counts == [1] * len(gemms) and total == len(gemms) + 3,
          f"cuda_gemm launched {counts} per product, {total} in all")

    rows = []
    for (prod, name, ck), a, got, count in zip(gemms, args, outs, counts):
        plan = ck.run_cuda.plan
        want = backend_cuda.gemm_plain(plan, *a)
        lo, hi = backend_cuda.bracket(plan, *a)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: {tuple(got.shape)} {got.dtype}")
        got32, want32 = got.float(), want.float()
        check(bool(torch.isfinite(got32).all()), f"{name}: non-finite")
        diff = (got32 - want32).abs()
        err = diff.max().item()
        outside = ((got32 < lo) | (got32 > hi)).sum().item()
        bf16_in = plan.dtypes[plan.matmul.lhs.buffer.name] == "bfloat16"
        rtol, atol = GEMM_BF16 if bf16_in else GEMM_F32
        share = (diff / (atol + rtol * want32.abs())).max().item()
        line = (f"[gemm] {name}: max_abs_err {err:.3e} vs gemm_plain, "
                f"worst element at {share:.3g} of rtol {rtol:g} atol "
                f"{atol:g}; {outside} elements outside the bracket of "
                f"its roundings")
        check(share <= 1 and outside == 0, f"{name}: off its bounds")
        if plan.dtypes[plan.out_buffer] == "bfloat16":
            exact = lo == hi
            moved = (got32[exact] != want32[exact]).sum().item()
            wide = torch.maximum(hi - want32, want32 - lo)
            worst = torch.where(diff > 0, diff / wide, 0.0).max().item()
            line += (f"; bf16 output: {1 - exact.float().mean().item():.3%}"
                     f" of elements may round either way, {moved} of the "
                     f"others differ, worst element at {worst:.3g} of its "
                     f"bracket")
            check(moved == 0, f"{name}: {moved} elements rounded elsewhere")
        elif bf16_in:
            f32 = (diff / (GEMM_F32[1] + GEMM_F32[0] * want32.abs())
                   ).max().item()
            line += (f"; f32 output, so no bf16 rounding after the inputs:"
                     f" worst element at {f32:.3g} of the f32 bound")
            check(f32 <= 1, f"{name}: off the f32 bound")
        print(line)
        del want, lo, hi, diff, got32, want32
        bound, bound_by = gemm_bound(plan, *MLP[prod])
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/stagecc_gemm.cuh",
            "replaces": "src/repro/core/backend_pallas.py:229",
            "launches": count, "max_abs_err": err,
            "ms": time_ms(lambda: ck.run_cuda(*a), flush, iters=20),
            "plain_ms": time_ms(
                lambda: backend_cuda.gemm_plain(plan, *a), flush, iters=20),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.matmul(a[0], a[1]), flush,
                                  iters=20)})
        r = rows[-1]
        print(f"[timing] {name}, cold L2: kernel {r['ms']:.3f} ms, bound "
              f"{bound:.3f} ms ({bound_by}), gemm_plain "
              f"{r['plain_ms']:.3f} ms, torch.matmul {r['library_ms']:.3f}"
              f" ms; card {smi}")

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


def main() -> int:
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
    compiled = compile_graphs(dev)
    sources = sorted({ck.run_cuda.source for _, _, ck in gemms})
    general = [ck.run_cuda.source for *_, ck in compiled]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(sources) + len(general) + len(HAND_KERNELS)) as pool:
        jobs = [pool.submit(_build.load, name) for name in HAND_KERNELS]
        jobs += [pool.submit(_build.load_source, src)
                 for src in sources + general]
        for job in jobs:
            job.result()
    print(f"[build] {', '.join(HAND_KERNELS)}, {len(sources)} emitted "
          f"GEMM sources and {len(general)} general-emitter sources, one "
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
              f"max_abs_err {err:.3e} (limit {tol:g})")
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
                  f"{model.param_count() * 4 / HBM_BYTES_PER_S * 1e3:.2f} ms")
            for ms, n, name in rows[:8]:
                print(f"[profile]   {ms:8.3f} ms/step  {n:4d} launches/step"
                      f"  {name[:90]}")

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

    # 7. time per launch beside the bound, the plain version and SDPA
    q, k, v, valid = attention_inputs(torch.float32, dev)
    B, KV, rep, hd = q.shape
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    addmask = torch.where(
        torch.arange(k.shape[2], device=dev)[None, :] < valid[:, None],
        0.0, -1e30).to(q.dtype)[:, None, None, :]
    qh = q.reshape(B, KV * rep, 1, hd)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, k, v, attn_mask=addmask, enable_gqa=True)

    lib_err = (library().reshape(q.shape) - da.decode_attention(
        q, k, v, valid)).abs().max().item()
    check(lib_err <= TOL_LIBRARY, f"SDPA differs from the kernel by {lib_err}")
    bound, bound_by = decode_attention_bound(q, k, valid)
    row = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:33",
           "launches": launches, "max_abs_err": errs[torch.float32],
           "ms": time_ms(lambda: da.decode_attention(q, k, v, valid), flush),
           "plain_ms": time_ms(
               lambda: da.decode_attention_ref(q, k, v, valid), flush),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": time_ms(library, flush)}
    print(f"[timing] decode_attention f32 B=4 KV=4 rep=7 hd=128 Smax=161 "
          f"valid=[0,1,129,161], cold L2: kernel {row['ms'] * 1e3:.1f} us, "
          f"bound {bound * 1e3:.2f} us ({bound_by}), plain "
          f"{row['plain_ms'] * 1e3:.1f} us, SDPA {row['library_ms'] * 1e3:.1f}"
          f" us (SDPA vs kernel {lib_err:.1e}); card {smi}")

    # 8. the compiled-GEMM path
    rows = [row] + gemm_phase(gemms, dev, flush, smi)

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
