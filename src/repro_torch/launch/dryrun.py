"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and extract memory / FLOP / byte / collective analysis.

The PyTorch counterpart of ``repro/launch/dryrun.py``.  It runs on the
host and allocates nothing: a ``"fake"`` process group of world size 256
(single pod, 16 x 16) or 512 (two pods, 2 x 16 x 16), and meta-device
DTensors placed by the state's logical axes.  Tracing a cell's step
under ``hlo_analysis.analyze_trace`` is the scale check for hardware we
don't have: every sharding resolves and every op has a DTensor rule (or
runs in a ``local_map`` region), and the trace yields per-device FLOPs,
bytes and collective bytes, priced on the H100's peaks.  Those roofline
terms are a model, not a timing.

Differences from the reference's record: ``trace_s`` replaces
``lower_s`` / ``compile_s``; there is no compiler memory or cost
analysis; the model runs the plain attention (``backend="torch"``, which
the reference's scanned stacks also reach, never its Pallas decode
kernel), recorded as ``"attention": "plain"``; a decode cell traces one
step at the last cache position (len S - 1).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCHS, get_config
from repro_torch.distributed.sharding import (Sharding, axis_rules, distribute,
                                              map_shardings, parse_axes,
                                              pspec_for, sharding_for,
                                              tree_map_axes, tree_shardings)
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import (Model, RunConfig, SHAPES,
                                      cell_applicable, input_specs)
from repro_torch.optim import schedule as sched
from repro_torch.optim.optimizer import adamw
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.step import (TrainConfig, make_train_step, new_rng,
                                    state_axes, state_shapes)

FACTORED_THRESHOLD = 5e10      # params above this use factored 2nd moment


def build_optimizer(cfg):
    factored = cfg.param_count() > FACTORED_THRESHOLD
    lr = sched.make("wsd" if cfg.name.startswith("minicpm") else "cosine",
                    peak=3e-4, warmup_steps=2000, total_steps=100_000)
    return adamw(lr, factored=factored,
                 state_dtype=torch.bfloat16 if factored else torch.float32)


def _leaf_pairs(shapes_tree, shardings_tree):
    """(tensor, Sharding) of every leaf of two trees of one structure."""
    pairs = []
    map_shardings(lambda sh, t: pairs.append((t, sh)), shardings_tree,
                  shapes_tree)
    return pairs


def _bytes_per_device(shapes_tree, shardings_tree) -> int:
    return sum(t.numel() * t.element_size() // max(sh.shards(), 1)
               for t, sh in _leaf_pairs(shapes_tree, shardings_tree))


def fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks (this process is rank
    0): collectives are recorded, not run.  A fake group of another size
    is replaced; a real one is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("dryrun: a real process group is running; "
                               "the dry run needs its own fake one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _place(shapes_tree, shardings_tree):
    """Meta DTensors of the shapes, placed by the shardings."""
    return map_shardings(lambda sh, t: distribute(t, sh), shardings_tree,
                         shapes_tree)


def state_bytes(arch: str, multi_pod: bool) -> int:
    """Per-device bytes of a train_4k cell's state (params and optimizer
    moments in the dry run's dtypes) on a production mesh's axis sizes:
    the reference's pspec arithmetic, no process group needed."""
    cfg = get_config(arch)
    model = Model(cfg, RunConfig(param_dtype="bfloat16", max_seq=4096),
                  device="meta")
    opt = build_optimizer(cfg)
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    shapes = state_shapes(model, opt)
    sh = tree_map_axes(lambda ax, t: _sizes_sharding(sizes, ax, t),
                       state_axes(model, opt), shapes)
    return _bytes_per_device(shapes, sh)


def _sizes_sharding(sizes, axes, t) -> Sharding:
    """A ``Sharding`` on a mesh given only by its axis sizes (no
    placements: nothing is placed)."""
    return Sharding(sizes, pspec_for(parse_axes(axes), t.shape, sizes), ())


def dryrun_cell(arch: str, shape: str, multi_pod: bool,
                microbatches: int = 1, remat: str = "dots",
                extra_tag: str = "", moe_impl: str = "gspmd",
                attn_probs_dtype: str = "float32",
                block_q: int = 512, block_k: int = 1024,
                mla_absorbed: bool = True) -> Dict[str, Any]:
    from repro_torch.models.layers import set_attention_options
    from repro_torch.models.mla import set_mla_absorbed
    from repro_torch.models.moe import set_moe_impl
    set_moe_impl(moe_impl)
    set_mla_absorbed(mla_absorbed)
    set_attention_options(probs_dtype=attn_probs_dtype, block_q=block_q,
                          block_k=block_k)
    cfg = get_config(arch)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": True, "reason": why}

    info = SHAPES[shape]
    n_dev = 512 if multi_pod else 256
    fake_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    run = RunConfig(param_dtype="bfloat16", cache_dtype="bfloat16",
                    max_seq=S, remat=remat if kind == "train" else "none",
                    backend="torch")
    model = Model(cfg, run, device="meta")
    specs = input_specs(cfg, shape, dtype=torch.bfloat16)

    t0 = time.perf_counter()
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    with axis_rules(mesh), grad:
        batch_shardings = {
            k: sharding_for(("batch",) + ("-",) * (v.ndim - 1), v.shape,
                            mesh)
            for k, v in specs.items()}
        batch = _place(specs, batch_shardings)

        if kind == "train":
            optimizer = build_optimizer(cfg)
            st_shapes = state_shapes(model, optimizer)
            st_shardings = tree_shardings(state_axes(model, optimizer),
                                          st_shapes, mesh)
            state_bytes_ = _bytes_per_device(st_shapes, st_shardings)
            # the step counter and the host rng stay plain tensors
            state = _place(st_shapes, st_shardings._replace(
                opt=st_shardings.opt._replace(step=None), rng=None))
            state = state._replace(rng=new_rng(0, 1))
            step_fn = make_train_step(model, optimizer,
                                      TrainConfig(microbatches=microbatches))
            stats = H.analyze_trace(step_fn, state, batch)
        else:
            pshapes = model.param_shapes()
            pshardings = tree_shardings(model.param_axes(), pshapes, mesh)
            cshapes = _tensors_only(model.cache_shapes(B, S))
            cshardings = tree_shardings(
                _tensors_only(model.cache_axes(B, S)), cshapes, mesh)
            state_bytes_ = (_bytes_per_device(pshapes, pshardings)
                            + _bytes_per_device(cshapes, cshardings))
            params = _place(pshapes, pshardings)
            cache = _place(cshapes, cshardings)
            if kind == "prefill":
                cache["len"] = 0
                fn = make_prefill_step(model)
                stats = H.analyze_trace(fn, params, cache, batch["tokens"],
                                        batch.get("extra_embeds"))
            else:                                   # decode
                cache["len"] = S - 1
                if cfg.encoder is not None:
                    cache["enc_done"] = 1
                fn = make_decode_step(model)
                stats = H.analyze_trace(fn, params, cache, batch["tokens"])
    t_trace = time.perf_counter() - t0
    coll = stats.collectives

    # analytic model flops
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = B * S
        model_flops = 6.0 * n_active * tokens
    elif kind == "prefill":
        tokens = B * S
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = B
        model_flops = 2.0 * n_active * tokens

    roof = H.roofline_terms(stats.flops, stats.bytes, coll.total_bytes,
                            model_flops_total=model_flops, n_devices=n_dev,
                            peaks=H.H100)
    return {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "params": cfg.param_count(),
        "active_params": n_active,
        "tokens_per_step": tokens,
        "trace_s": round(t_trace, 2),
        "attention": "plain",
        "state_bytes_per_device": int(state_bytes_),
        "trace_stats": {"flops": stats.flops, "bytes": stats.bytes},
        "collectives": {"counts": coll.counts,
                        "bytes_by_kind": coll.bytes_by_kind,
                        "total_bytes": coll.total_bytes},
        "roofline": dict(roof.as_dict(), peaks=H.H100.name),
        "tag": extra_tag,
    }


def _tensors_only(cache):
    """A cache tree (of tensors or axes) without its host counters
    (``len``, ``enc_done``)."""
    return {k: _tensors_only(v) if isinstance(v, dict) else v
            for k, v in cache.items() if k not in ("len", "enc_done")}


def cell_list():
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, _ = cell_applicable(cfg, shape)
            cells.append((arch, shape, ok))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="grad-accum microbatches for train cells")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--moe-impl", default="gspmd",
                    choices=["auto", "gspmd", "shardmap"])
    ap.add_argument("--attn-probs-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--block-q", type=int, default=512)
    ap.add_argument("--block-k", type=int, default=1024)
    ap.add_argument("--mla-absorbed", default="on", choices=["on", "off"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-cell subprocess timeout (--all)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, ok in cell_list():
            print(f"{arch:22s} {shape:12s} {'run' if ok else 'SKIP'}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        # --all: one subprocess per cell for isolation
        failures = []
        for arch, shape, ok in cell_list():
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                outfile = os.path.join(args.out, tag + ".json")
                if os.path.exists(outfile):
                    print(f"[skip existing] {tag}")
                    continue
                if not ok:
                    cfgrec = {"arch": arch, "shape": shape, "skipped": True,
                              "mesh": "2x16x16" if mp else "16x16",
                              "reason": cell_applicable(get_config(arch),
                                                        shape)[1]}
                    with open(outfile, "w") as f:
                        json.dump(cfgrec, f, indent=1)
                    print(f"[skip n/a] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", "multi" if mp else "single",
                       "--out", args.out,
                       "--microbatches", str(args.microbatches),
                       "--remat", args.remat, "--tag", args.tag,
                       "--moe-impl", args.moe_impl,
                       "--attn-probs-dtype", args.attn_probs_dtype,
                       "--block-q", str(args.block_q),
                       "--block-k", str(args.block_k),
                       "--mla-absorbed", args.mla_absorbed]
                print(f"[dryrun] {tag} ...", flush=True)
                t0 = time.perf_counter()
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=args.timeout)
                    dt = time.perf_counter() - t0
                    if r.returncode != 0:
                        failures.append(tag)
                        print(f"[FAIL {dt:.0f}s] {tag}\n{r.stdout[-2000:]}"
                              f"\n{r.stderr[-4000:]}")
                    else:
                        print(f"[ok {dt:.0f}s] {tag}")
                except subprocess.TimeoutExpired:
                    failures.append(tag)
                    print(f"[TIMEOUT] {tag}")
        print(f"\ndone; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    # single-cell mode
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    for mp in meshes:
        rec = dryrun_cell(args.arch, args.shape, mp,
                          microbatches=args.microbatches, remat=args.remat,
                          extra_tag=args.tag, moe_impl=args.moe_impl,
                          attn_probs_dtype=args.attn_probs_dtype,
                          block_q=args.block_q, block_k=args.block_k,
                          mla_absorbed=(args.mla_absorbed == "on"))
        tag = f"{args.arch}__{args.shape}__{rec.get('mesh', 'na')}"
        if args.tag:
            tag += f"__{args.tag}"
        outfile = os.path.join(args.out, tag + ".json")
        with open(outfile, "w") as f:
            json.dump(rec, f, indent=1)
        if not rec.get("skipped"):
            print(cell_line(tag, rec))
    return 0


def cell_line(tag: str, rec: Dict[str, Any]) -> str:
    """One line of a cell's record: the H100-priced roofline (a model)."""
    r = rec["roofline"]
    return (f"[cell] {tag}: per device {r['flops_per_device']:.4g} FLOP, "
            f"{r['hbm_bytes_per_device']:.4g} bytes, "
            f"{r['coll_bytes_per_device']:.4g} collective bytes; priced on "
            f"{r['peaks']} (a model, not a timing): "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s "
            f"bottleneck={r['bottleneck']} useful={r['useful_ratio']:.3f} "
            f"(trace {rec['trace_s']}s)")


if __name__ == "__main__":
    sys.exit(main())
