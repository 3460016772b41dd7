"""Multi-rank bodies for the distribution tests (no JAX).

``run(name, world, tmp, payload)`` starts ``world`` processes in a group
over a ``FileStore`` under ``tmp`` (no TCP port, so parallel test workers
cannot collide), runs the function ``name`` of this module as
``fn(rank, world, payload)`` on each, and returns their results in rank
order: gloo CPU ranks, or with ``device="cuda"`` NCCL ranks, one card
each (rank r on card r).  A run that outlives its ``timeout`` is killed
and raises, so a hang cannot eat the suite's time (each rank prints its
threads' stacks and exits shortly before); the group's own timeout also
ends a stuck collective.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import gc
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# this rank's device: the CPU, or its own card under ``device="cuda"``
DEVICE = torch.device("cpu")


def run(name: str, world: int, tmp, payload=None, timeout: float = 120.0,
        device: str = "cpu"):
    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_main, args=(world, tmp, name, device, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{name}: {world} ranks past {timeout}s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(rank: int, world: int, tmp: str, name: str,
          device: str = "cpu", timeout: float = 120.0) -> None:
    global DEVICE
    # a rank still running shortly before the run's deadline prints every
    # thread's stack and exits, so a hang shows where it waits
    faulthandler.dump_traceback_later(max(10.0, timeout - 20.0), exit=True)
    kw = {}
    if device == "cuda":
        DEVICE = torch.device("cuda", rank)
        torch.cuda.set_device(DEVICE)
        kw["device_id"] = DEVICE
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90),
        **kw)
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = globals()[name](rank, world, payload)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        # the body's dropped engines first: a CUDA graph that captured a
        # collective holds its NCCL communicator, and ending the group
        # while one lives does not return (serve/graphs.py)
        gc.collect()
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) mesh (``launch.mesh.make_host_mesh``) over a 1-rank gloo
    group started in this process, ended with the context, so that a test
    worker keeps no group."""
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        raise RuntimeError("a process group already runs in this process")
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _np(tree):
    from repro_torch.distributed.sharding import full
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return full(tree).detach().cpu().numpy()


def _mesh(data: int, model: int):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(DEVICE.type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def optimizer(name, lr):
    """AdamW (weight decay 0.01) or SGD at a constant ``lr`` (a 0-d
    tensor on the step counter's device, as ``optim.schedule``'s), or at
    the schedule ``optim.schedule.make(**lr)`` where ``lr`` is a dict."""
    from repro_torch.optim import schedule
    from repro_torch.optim.optimizer import adamw, sgd

    def rate(step):
        return torch.tensor(lr, device=step.device)
    if isinstance(lr, dict):
        rate = schedule.make(**lr)
    if name == "adamw":
        return adamw(rate, weight_decay=0.01)
    return sgd(rate)


def plain_steps(cfg, params, batches, opt, lr, device="cpu",
                run=None):
    """The port's train steps of ``cfg`` without a mesh, from ``params``
    (a tree of numpy arrays, or a seed the params are drawn from on
    ``device``), one a batch of ``batches`` (numpy), the model built with
    ``RunConfig(**run)`` (default ``max_seq=64``): the losses and the
    final params (on ``device``)."""
    from repro_torch.convert import to_torch
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import TrainState, make_train_step, new_rng
    m = Model(cfg, RunConfig(**(run or {"max_seq": 64})), device=device)
    po = optimizer(opt, lr)
    tp = (m.init(torch.Generator(device=device).manual_seed(params))
          if isinstance(params, int) else to_torch(params, device))
    st = TrainState(tp, po.init(tp), new_rng(0, 1))
    fn = make_train_step(m, po)
    losses = []
    for b in batches:
        st, met = fn(st, {k: torch.from_numpy(v).to(device)
                          for k, v in b.items()})
        losses.append(met["loss"].item())
    return losses, st.params


def leaf_shares(got, want, prefix=""):
    """{leaf path: (largest difference, the leaf's largest magnitude)} of
    two param trees of tensors (DTensors gathered)."""
    from repro_torch.distributed.sharding import full
    if isinstance(want, dict):
        out = {}
        for k in sorted(want):
            out.update(leaf_shares(got[k], want[k], f"{prefix}/{k}"))
        return out
    w = want.detach().float()
    g = full(got).detach().float().to(w.device)
    return {prefix: (float((g - w).abs().max()), float(w.abs().max()))}


# --------------------------------------------------------------------------
# bodies
# --------------------------------------------------------------------------


def compressed(rank, world, p):
    """compressed_psum_mean over the whole group on this rank's row of
    ``p["x"]``, and make_compressed_allreduce over the ``data`` axis of a
    (2, world // 2) mesh on a tree of this rank's rows."""
    from repro_torch.distributed import compression as C
    x = torch.from_numpy(p["x"][rank])
    whole = C.compressed_psum_mean(x)
    mesh = _mesh(2, world // 2)
    tree = {"a": torch.from_numpy(p["tree"]["a"][rank]),
            "b": {"c": torch.from_numpy(p["tree"]["b"]["c"][rank])}}
    red = C.make_compressed_allreduce(mesh, "data")(tree)
    return {"whole": whole.numpy(), "tree": _np(red)}


def shardmap_moe(rank, world, p):
    """apply_moe of the MoE layer on a (1, world) mesh with DTensor inputs
    under ``p["impl"]``, the output gathered."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  sharding_for)
    from repro_torch.models import moe
    from repro_torch.models.layers import Maker
    cfg = p["cfg"]
    mesh = _mesh(p.get("data", 1), world // p.get("data", 1))
    moe.set_moe_impl(p["impl"])
    with axis_rules(mesh):
        axes = moe.init_moe(cfg, Maker("axes"))
        params = {k: distribute(torch.from_numpy(v),
                                sharding_for(axes[k], v.shape, mesh))
                  for k, v in p["params"].items()}
        x = distribute(torch.from_numpy(p["x"]),
                       sharding_for("batch - -", p["x"].shape, mesh))
        leaves = [x] + [params[k] for k in sorted(params)]
        for t in leaves:
            t.requires_grad_(True)
        y, aux = moe.apply_moe(params, x, cfg)
        wy = distribute(torch.from_numpy(p["wy"]), sharding_for(
            "batch - -", p["wy"].shape, mesh))
        grads = torch.autograd.grad((y * wy).sum() + aux, leaves)
        picked = moe._can_shardmap(cfg, x.shape[0] * x.shape[1])
        out = {"y": y.full_tensor().detach().numpy(),
               "aux": float(aux.full_tensor()), "shardmap": picked,
               "grads": dict(zip(["x"] + sorted(params),
                                 (g.full_tensor().numpy() for g in grads)))}
    moe.set_moe_impl("auto")
    return out


def train_steps(rank, world, p):
    """Train steps of ``p["cfg"]`` on a (data, model) mesh from the params
    ``p["params"]`` (numpy, or a seed they are drawn from on this rank's
    device by ``Model.init(mesh=)``), AdamW or SGD (``p["opt"]``) at
    ``p["lr"]`` (``optimizer``), the model built with ``RunConfig(
    **p["run"])`` (default ``max_seq=64``), one a batch of
    ``p["batches"]`` (a stub frontend's ``extra_embeds`` too):
    the losses and the final params; with ``p["plain"]``, instead of the
    params, the same steps without a mesh on this rank's device
    (``plain_steps``): their losses and each leaf's largest difference
    and magnitude (``leaf_shares``)."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  sharding_for,
                                                  tree_map_axes)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import TrainState, make_train_step, new_rng
    mesh = _mesh(*p["mesh"])
    run = p.get("run", {"max_seq": 64})
    model = Model(p["cfg"], RunConfig(**run), device=DEVICE)
    opt = optimizer(p["opt"], p["lr"])
    moe.set_moe_impl(p.get("impl", "auto"))
    with axis_rules(mesh):
        if isinstance(p["params"], int):
            params = model.init(
                torch.Generator(device=DEVICE).manual_seed(p["params"]),
                mesh=mesh)
        else:
            params = tree_map_axes(
                lambda ax, a: distribute(torch.from_numpy(a).to(DEVICE),
                                         sharding_for(ax, a.shape, mesh)),
                model.param_axes(), p["params"])
        state = TrainState(params, opt.init(params), new_rng(0, 1))
        fn = make_train_step(model, opt)
        losses, shardmap = [], []
        for b in p["batches"]:
            batch = {k: distribute(torch.from_numpy(v).to(DEVICE),
                                   sharding_for(("batch",) + ("-",) *
                                                (v.ndim - 1), v.shape, mesh))
                     for k, v in b.items()}
            state, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            T = b["tokens"].shape[0] * b["tokens"].shape[1]
            shardmap.append(moe._can_shardmap(p["cfg"], T)
                            if p["cfg"].moe is not None else None)
        placements = {k: str(v.placements) for k, v in
                      state.params["scan"]["pos0"].get("mlp", {}).items()}
        out = {"losses": losses, "shardmap": shardmap,
               "placements": placements}
        if p.get("plain"):
            del fn, batch
            params = state.params
            del state
            out["plain_losses"], want = plain_steps(
                p["cfg"], p["params"], p["batches"], p["opt"], p["lr"],
                DEVICE, run)
            out["shares"] = leaf_shares(params, want)
        else:
            out["params"] = _np(state.params)
    moe.set_moe_impl("auto")
    return out


def grad_peak(rank, world, p):
    """One SGD step of ``p["cfg"]`` (remat full) on a (data, model) mesh
    from params drawn from seed 0, twice: with ``sharding.placed_grad``
    as it is, which reduces each layer's gradient of a stacked leaf as the
    backward makes it (``transformer._placed`` through
    ``sharding.reduced_grad``), and with one that only
    watches (each layer's gradient then waits for the stack, as without
    the reduction).  Both record the bytes of this rank's whole-size
    (``Partial``) gradients of the stacked leaves alive at once.  Returns
    each run's largest such total, its loss and its params."""
    import weakref
    from repro_torch.distributed import sharding as S
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import TrainState, make_train_step, new_rng
    mesh = _mesh(*p["mesh"])
    model = Model(p["cfg"], RunConfig(max_seq=64, remat="full"),
                  device=DEVICE)
    opt = optimizer("sgd", p["lr"])
    reduce = S.placed_grad
    out = {}
    for mode in ("reduce", "watch"):
        live = {"now": 0, "peak": 0}

        def drop(n, live=live):
            live["now"] -= n

        def hook(mesh_, placements, g, mode=mode, live=live):
            if S.is_dtensor(g) and any(pl.is_partial() for pl in g.placements):
                n = g.to_local().numel() * g.element_size()
                live["now"] += n
                live["peak"] = max(live["peak"], live["now"])
                weakref.finalize(g, drop, n)
            return reduce(mesh_, placements, g) if mode == "reduce" else g
        S.placed_grad = hook
        try:
            with S.axis_rules(mesh):
                params = model.init(torch.Generator().manual_seed(0),
                                    mesh=mesh)
                state = TrainState(params, opt.init(params), new_rng(0, 1))
                batch = {k: S.distribute(torch.from_numpy(v), S.sharding_for(
                    "batch -", v.shape, mesh)) for k, v in p["batch"].items()}
                state, metrics = make_train_step(model, opt)(state, batch)
                out[mode] = {"peak": live["peak"],
                             "loss": float(metrics["loss"]),
                             "params": _np(state.params)}
        finally:
            S.placed_grad = reduce
    return out


def thread_backward(rank, world, p):
    """The gradients of ``p["cfg"]``'s loss (remat full) on a (data,
    model) mesh from params drawn from seed 0, once with the backward run
    in this thread and once in another, as the autograd engine runs a
    CUDA backward on its device thread: there this thread's ``axis_rules``
    are not set, and DTensor's implicit replication is (torch carries it
    there); both gathered."""
    import threading
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  replicate_plain, shard,
                                                  sharding_for)
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import tree_leaves
    mesh = _mesh(*p["mesh"])
    model = Model(p["cfg"], RunConfig(max_seq=64, remat="full"),
                  device=DEVICE)
    out = {}
    with axis_rules(mesh):
        params = model.init(torch.Generator().manual_seed(0), mesh=mesh)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = {k: distribute(torch.from_numpy(v), sharding_for(
            "batch -", v.shape, mesh)) for k, v in p["batch"].items()}
        for where in ("here", "thread"):
            with torch.enable_grad(), replicate_plain(leaves[0]):
                loss, _ = model.loss(params, batch)
                got = {}

                def backward(got=got, loss=loss):
                    try:
                        got["grads"] = torch.autograd.grad(shard(loss),
                                                           leaves)
                    except Exception as e:      # reported, not raised
                        got["error"] = f"{type(e).__name__}: {e}"[:300]

                def device_thread():
                    with implicit_replication():
                        backward()
                if where == "here":
                    backward()
                else:
                    t = threading.Thread(target=device_thread)
                    t.start()
                    t.join()
            out[where] = ([_np(g) for g in got["grads"]] if "grads" in got
                          else got["error"])
    return out


def sharded_gemm(rank, world, p):
    """sharded_gemm_op on a (data, model) mesh: the output and both
    gradients gathered, their placements, and the ValueError of an m that
    ``data`` does not divide."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.integrate import sharded_gemm_op
    mesh = _mesh(*p["mesh"])
    a, b, w = (torch.from_numpy(p[k]) for k in ("a", "b", "w"))
    m, k = a.shape
    n = b.shape[1]
    rows = [Shard(0), Replicate()]
    rep = [Replicate(), Replicate()]
    da = distribute_tensor(a, mesh, rows, src_data_rank=None)
    db = distribute_tensor(b, mesh, rep, src_data_rank=None)
    da.requires_grad_(True)
    db.requires_grad_(True)
    out = sharded_gemm_op(mesh, m, n, k)(da, db)
    (out * distribute_tensor(w, mesh, rows, src_data_rank=None)).sum(
        ).backward()
    try:
        sharded_gemm_op(mesh, m + 1, n, k)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"out": out.full_tensor().detach().numpy(),
            "out_placements": str(out.placements),
            "ga": da.grad.full_tensor().numpy(),
            "gb": db.grad.full_tensor().numpy(),
            "gb_placements": str(db.grad.placements), "refused": refused}


def elastic(rank, world, p):
    """A train state built on a (2, 2) mesh and saved, then restored onto
    a (4, 1) mesh (``restore(shardings=)``): both gathered, and the
    restored placements."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed.sharding import map_shardings
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import adamw, tree_leaves
    from repro_torch.train.step import (init_state_sharded, state_shapes,
                                        state_shardings)
    model = Model(reduced(get_config("qwen2-7b")), RunConfig(max_seq=32),
                  device="cpu")
    opt = adamw(lambda s: 1e-3)
    mesh_a = _mesh(2, 2)
    state = init_state_sharded(model, opt, torch.Generator().manual_seed(0),
                               mesh_a)
    ckpt.save(p["dir"], 1, state)
    mesh_b = _mesh(4, 1)
    restored, extra = ckpt.restore(p["dir"], target=state_shapes(model, opt),
                                   shardings=state_shardings(model, opt,
                                                             mesh_b))
    leaves_a = tree_leaves(state.params)
    leaves_b = tree_leaves(restored.params)
    # a factored second moment made from DTensor params (optimizer.init)
    # takes the placements state_axes gives its row / col leaves
    fopt = adamw(lambda s: 1e-3, factored=True)
    factored = []
    map_shardings(lambda sh, t: factored.append(
        (str(tuple(t.placements)), str(tuple(sh.placements)),
         tuple(t.shape))),
        state_shardings(model, fopt, mesh_a).opt.v,
        fopt.init(state.params).v)
    return {"a": [_np(x) for x in leaves_a], "b": [_np(x) for x in leaves_b],
            "m": [_np(x) for x in tree_leaves(restored.opt.m)],
            "m_a": [_np(x) for x in tree_leaves(state.opt.m)],
            "mesh_b": [str(x.device_mesh.shape) for x in leaves_b],
            "local_a": [tuple(x.to_local().shape) for x in leaves_a],
            "local_b": [tuple(x.to_local().shape) for x in leaves_b],
            "step": extra["step"], "factored": factored}


def _smoke():
    """``chip_smoke.py`` as a module (its parts and its ``Collectives``)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def serve_cut_part(rank, world, p):
    """``chip_smoke.py``'s four-card serving part (a) (``serve_cut``) on a
    ``p["mesh"]`` (data, model) mesh of these ranks: its record."""
    return {"rank": rank, "card": str(DEVICE),
            "cut": _smoke().serve_cut(_mesh(*p["mesh"]), DEVICE, None)}


def smoke_parts(rank, world, p):
    """``chip_smoke.py``'s four-card deepseek-v2 parts (``moe_parts``) on
    a ``p["mesh"]`` (data, model) mesh of these ranks, with the rest of
    ``p`` as their options (``parts``, ``reduced`` and sizes): their
    record."""
    opts = dict(p)
    return _smoke().moe_parts(_mesh(*opts.pop("mesh")), DEVICE, **opts)


def host_mesh_train(rank, world, p):
    """``launch.train.main(--mesh host)`` inside a ``world``-rank group:
    the losses."""
    from repro_torch.launch import train
    res = train.main(p["argv"])
    return {"losses": [h["loss"] for h in res["trainer"].metrics_history],
            "mesh": str(res["mesh"].shape)}




def flat_np(tree):
    """{``/``-joined key: numpy array} of a state (``checkpointer``'s
    keys), each DTensor gathered, bf16 as its 16-bit words, so that
    equal arrays mean equal bits."""
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.distributed.sharding import full
    out = {}
    for key, leaf in _flatten(tree):
        t = full(leaf).detach().cpu()
        out[key] = (t.view(torch.uint16) if t.dtype == torch.bfloat16
                    else t).numpy()
    return out


def _trained_state(cfg, mesh, seed=0, run=None):
    """``cfg``'s model (``RunConfig(**run)``, default ``max_seq=16``),
    AdamW at 1e-3 (weight decay 0.01), its train step, and its state on
    ``mesh`` from ``seed`` after one step on a batch of 4 x 8 tokens (so
    the moments are not zeros)."""
    import numpy as np
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  sharding_for)
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import init_state_sharded, make_train_step
    model = Model(cfg, RunConfig(**(run or {"max_seq": 16})), device=DEVICE)
    opt = optimizer("adamw", 1e-3)
    fn = make_train_step(model, opt)
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 9))
    with axis_rules(mesh):
        state = init_state_sharded(
            model, opt, torch.Generator(device=DEVICE).manual_seed(seed),
            mesh)
        batch = {k: distribute(torch.from_numpy(v.astype(np.int32)).to(
            DEVICE), sharding_for("batch -", v.shape, mesh))
            for k, v in (("tokens", t[:, :-1]), ("labels", t[:, 1:]))}
        state, _ = fn(state, batch)
    return model, opt, state


def ckpt_sharded(rank, world, p):
    """A train state of ``p["cfg"]`` on a (2, 2) mesh after one AdamW
    step (``_trained_state``), saved as step 1 into ``p["dir"]`` with
    ``DTensor.full_tensor`` / ``redistribute`` and ``np.save`` watched;
    then restored from it onto each (data, model) mesh of ``p["onto"]``
    (``restore(shardings=)`` into meta shapes).  Returns the saved state
    (``flat_np``), the watched calls during the save, the largest array
    this rank saved, ``checkpointer.io`` of the save, and each restore's
    state, step, ``io`` and the bytes of this rank's pieces of it."""
    import numpy as np
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.train.step import state_shapes, state_shardings
    model, opt, state = _trained_state(p["cfg"], _mesh(2, 2),
                                       run=p.get("run"))
    calls = {"full_tensor": 0, "redistribute": 0}
    saved = []
    real = DTensor.full_tensor, DTensor.redistribute, np.save

    def watch(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    def save(file, arr, *args, **kwargs):
        saved.append(np.asarray(arr).nbytes)
        return real[2](file, arr, *args, **kwargs)
    DTensor.full_tensor = watch("full_tensor", real[0])
    DTensor.redistribute = watch("redistribute", real[1])
    np.save = save
    try:
        ckpt.save(p["dir"], 1, state)
    finally:
        DTensor.full_tensor, DTensor.redistribute, np.save = real
    out = {"saved": flat_np(state), "calls": calls,
           "largest": max(saved, default=0),
           "io": dict(getattr(ckpt, "io", {}).get("save", {})),
           "restored": {}}
    for shape in p["onto"]:
        got, extra = ckpt.restore(
            p["dir"], target=state_shapes(model, opt),
            shardings=state_shardings(model, opt, _mesh(*shape)))
        out["restored"][shape] = {
            "state": flat_np(got), "step": extra["step"],
            "io": dict(getattr(ckpt, "io", {}).get("restore", {})),
            "local_bytes": sum(
                (x.to_local() if is_dtensor(x) else x).nbytes
                for x in tree_leaves(got))}
    return out


def ckpt_whole(rank, world, p):
    """A one-file checkpoint (``arrays.npz``, whole leaves) in ``p["dir"]``
    restored on every rank onto each (data, model) mesh of ``p["onto"]``:
    as new DTensors (``restore(shardings=)`` into meta shapes), and into
    the DTensors of a state of ``p["cfg"]`` from another seed on that
    mesh (``restore(target=)``).  Returns, per mesh and way, the state
    (``flat_np``), the step, the meshes of its DTensor leaves, and for
    the target whether every leaf came back as the target's own tensor
    with its storage unchanged."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.train.step import state_shapes, state_shardings

    def meshes(tree):
        return sorted({str(tuple(x.device_mesh.shape))
                       for _, x in _flatten(tree) if is_dtensor(x)})
    out = {}
    for shape in p["onto"]:
        mesh = _mesh(*shape)
        model, opt, state = _trained_state(p["cfg"], mesh, seed=1,
                                           run=p.get("run"))
        got, extra = ckpt.restore(
            p["dir"], target=state_shapes(model, opt),
            shardings=state_shardings(model, opt, mesh))
        out[(shape, "shardings")] = {"state": flat_np(got),
                                     "step": extra["step"],
                                     "meshes": meshes(got)}
        before = [(x, x.to_local().data_ptr()) for _, x in _flatten(state)
                  if is_dtensor(x)]
        got, extra = ckpt.restore(p["dir"], target=state)
        after = {id(x): x for _, x in _flatten(got)}
        out[(shape, "target")] = {
            "state": flat_np(got), "step": extra["step"],
            "meshes": meshes(got),
            "in_place": bool(before) and all(
                after.get(id(x)) is x and x.to_local().data_ptr() == ptr
                for x, ptr in before)}
    return out


def _training(p):
    """The ``p["mesh"]`` (data, model) mesh, ``p["cfg"]``'s model
    (``RunConfig(max_seq=16)``), AdamW at 1e-3, its train step and the
    pipeline of 4 x 16 batches (seed 3) of ``trainer_resume`` and
    ``failover_group``."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import make_train_step
    cfg = p["cfg"]
    model = Model(cfg, RunConfig(max_seq=16), device=DEVICE)
    opt = optimizer("adamw", 1e-3)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=3))
    return _mesh(*p["mesh"]), model, opt, make_train_step(model, opt), pipe


def trainer_resume(rank, world, p):
    """``Trainer`` on a ``p["mesh"]`` (data, model) mesh (``_training``:
    ``p["cfg"]``, AdamW, the pipeline's 4 x 16 batches).  Three runs: ``p["steps"]`` steps straight; with the
    checkpoint directory ``p["dir"]`` a run that stops early, either at
    ``total_steps=p["stop"]`` or, with ``p["signal"]`` = (rank, call),
    by the SIGTERM that rank sends itself during that call of its train
    step (``install_preemption_handler`` on every rank); then a run from
    another seed's state that resumes from the checkpoint to
    ``p["steps"]``.  Returns each run's losses, log and committed steps,
    and the final states of the straight and resumed runs
    (``flat_np``)."""
    import signal
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.distributed.sharding import axis_rules, sharding_for
    from repro_torch.train.step import init_state_sharded
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh, model, opt, fn, pipe = _training(p)
    calls = {"n": -1, "armed": False}

    def step(state, batch):
        calls["n"] += 1
        out = fn(state, batch)
        if calls["armed"] and p.get("signal") == (rank, calls["n"]):
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    out = {}

    def run(name, total, seed, directory=None):
        logs = []
        trainer = Trainer(TrainerConfig(total_steps=total,
                                        checkpoint_dir=directory,
                                        log_every=1),
                          step, pipe, log_fn=logs.append)
        if calls["armed"]:
            trainer.install_preemption_handler()
        with axis_rules(mesh):
            state = init_state_sharded(
                model, opt, torch.Generator(device=DEVICE).manual_seed(seed),
                mesh)
            state = trainer.run(state, sharding=sharding_for(
                "batch -", (4, 16), mesh))
        out[name] = {"losses": [h["loss"] for h in trainer.metrics_history],
                     "log": logs,
                     "steps": sorted(ckpt.all_steps(directory or ""))}
        return state
    straight = flat_np(run("straight", p["steps"], 0))
    out["straight"]["state"] = straight
    calls["armed"], calls["n"] = "signal" in p, -1
    run("first", p["steps"] if calls["armed"] else p["stop"], 0, p["dir"])
    calls["armed"] = False
    out["resumed"]["state"] = flat_np(run("resumed", p["steps"], 1,
                                          p["dir"]))
    return out


def failover_group(rank, world, p):
    """``FailoverRunner`` on a ``p["mesh"]`` (data, model) mesh over
    ``p["steps"]`` AdamW steps of ``p["cfg"]`` (``_training``), a
    checkpoint every ``p["every"]`` into ``p["dir"]``, its train step
    raising on one rank only (``p["fail"]`` = (rank, call)) once the
    step's collectives are done (as a fault seen at its loss's sync; one
    raised before them leaves the other ranks waiting in theirs); and
    the same steps straight.  Returns the runner's failures, replayed steps and
    last step, and both final states (``flat_np``)."""
    from repro_torch.distributed import fault_tolerance as F
    from repro_torch.distributed.sharding import axis_rules, sharding_for
    from repro_torch.train.step import init_state_sharded
    mesh, model, opt, fn, pipe = _training(p)
    calls = {"n": -1}

    def flaky(state, batch):
        calls["n"] += 1
        out = fn(state, batch)
        if (rank, calls["n"]) == p["fail"]:
            raise RuntimeError("injected chip failure")
        return out
    with axis_rules(mesh):
        batch = sharding_for("batch -", (4, 16), mesh)

        def fresh():
            return init_state_sharded(
                model, opt, torch.Generator(device=DEVICE).manual_seed(0),
                mesh)
        straight = fresh()
        for i in range(p["steps"]):
            straight, _ = fn(straight, pipe.torch_batch(i, DEVICE, batch))
        runner = F.FailoverRunner(
            F.FailoverConfig(checkpoint_dir=p["dir"],
                             checkpoint_every=p["every"]),
            flaky, lambda i: pipe.torch_batch(i, DEVICE, batch),
            log_fn=lambda s: None)
        final, end = runner.run(fresh(), 0, p["steps"])
    return {"failures": runner.failures, "replayed": runner.replayed_steps,
            "end": end, "state": flat_np(final),
            "straight": flat_np(straight)}


def digests(tree):
    """{key: sha256 of the leaf's bytes} of a state (``checkpointer``'s
    keys), each DTensor gathered one leaf at a time."""
    import hashlib
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.distributed.sharding import full
    out = {}
    for key, leaf in _flatten(tree):
        t = full(leaf).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        out[key] = hashlib.sha256(t.numpy().data).hexdigest()
    return out


def ckpt_cards(rank, world, p):
    """``p["cfg"]`` (``RunConfig(max_seq=64)``) on a (4, 1) mesh from the
    params of seed 0, AdamW at ``p["lr"]``: two steps on ``p["batches"]``,
    saved as step 2 into ``p["dir"]``; restored onto (2, 2)
    (``restore(shardings=)``) and compared leaf by leaf with the state it
    was saved from; then the third step on each.  Returns the keys that
    differ, the third step's losses on (4, 1) and (2, 2), the first two,
    and the ``digests`` of the saved state."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  full, sharding_for)
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import (init_state_sharded, make_train_step,
                                        state_shapes, state_shardings)
    model = Model(p["cfg"], RunConfig(max_seq=64), device=DEVICE)
    opt = optimizer("adamw", p["lr"])
    fn = make_train_step(model, opt)

    def placed(b, mesh):
        return {k: distribute(torch.from_numpy(v).to(DEVICE), sharding_for(
            "batch -", v.shape, mesh)) for k, v in b.items()}
    mesh, other = _mesh(4, 1), _mesh(2, 2)
    losses = []
    with axis_rules(mesh):
        state = init_state_sharded(
            model, opt, torch.Generator(device=DEVICE).manual_seed(0), mesh)
        for b in p["batches"][:2]:
            state, met = fn(state, placed(b, mesh))
            losses.append(met["loss"].item())
        ckpt.save(p["dir"], 2, state)
    out = {"losses": losses, "save": dict(ckpt.io["save"])}
    restored, extra = ckpt.restore(
        p["dir"], target=state_shapes(model, opt),
        shardings=state_shardings(model, opt, other))
    out["restore"], out["step"] = dict(ckpt.io["restore"]), extra["step"]
    out["differ"] = [
        key for (key, a), (_, b) in zip(_flatten(state), _flatten(restored))
        if not torch.equal(full(a).to(DEVICE), full(b).to(DEVICE))]
    out["digests"] = digests(state)         # a collective on every rank
    with axis_rules(mesh):
        _, met = fn(state, placed(p["batches"][2], mesh))
        out["third"] = met["loss"].item()
    del state
    with axis_rules(other):
        _, met = fn(restored, placed(p["batches"][2], other))
        out["third_2x2"] = met["loss"].item()
    return out


# --------------------------------------------------------------------------
# serving on a mesh
# --------------------------------------------------------------------------


def serve_case(cfg, seed=5, batch=4, prompt=6, requests=8):
    """Serving inputs of ``cfg``: ``batch`` prompts of ``prompt`` tokens
    and ``requests`` requests (rid, prompt of 3-8 tokens, 2-6 new
    tokens), from ``seed``."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(
        np.int32)
    reqs = [(i, rng.integers(0, cfg.vocab_size,
                             (int(rng.integers(3, 9)),)).tolist(),
             int(rng.integers(2, 7))) for i in range(requests)]
    return {"prompts": prompts, "requests": reqs, "steps": 5,
            "max_len": 24, "slots": 3, "temperature": 0.8}


def _requests(p):
    from repro_torch.serve.continuous import Request
    return [Request(rid, np.asarray(prompt, np.int32), n)
            for rid, prompt, n in p["requests"]]


def _weight_pieces(params):
    """The shapes a piece of a param can take: each leaf whole and local,
    with and without its stacked layer axis (a layer's slice)."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.optim.optimizer import tree_leaves
    out = set()
    for leaf in tree_leaves(params):
        for shape in {tuple(leaf.shape), tuple(
                leaf.to_local().shape if is_dtensor(leaf) else leaf.shape)}:
            out |= {shape, shape[1:]} if len(shape) > 1 else {shape}
    return out


def _engine_run(model, params, p, cuda_graphs):
    """``chip_smoke.engine_logits`` over ``p``'s prompts: (the engine, its
    tokens, the gathered logits it sampled from)."""
    return _smoke().engine_logits(model, params, p["prompts"], cuda_graphs,
                                  p["steps"], p["max_len"])


def _slot_engines(model, params, p, out, prefix=""):
    """``SerialSlotEngine`` greedy and ``ContinuousEngine`` greedy and at
    ``p["temperature"]`` over ``p["requests"]``, into ``out``."""
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.engine import SerialSlotEngine
    out[prefix + "serial"] = SerialSlotEngine(
        model, params, slots=p["slots"],
        max_len=p["max_len"]).serve(_requests(p))
    for t in (0.0, p["temperature"]):
        out[f"{prefix}continuous T{t:g}"] = ContinuousEngine(
            model, params, slots=p["slots"], max_len=p["max_len"],
            temperature=t, seed=3).serve(_requests(p))


def serve_engines(rank, world, p):
    """The serving engines of ``p["cfg"]`` on a ``p["mesh"]`` (data, model)
    mesh, against the same engines without a mesh in this rank, from the
    params ``p["params"]``: numpy (plain on this rank's device: the
    engines place them), a seed (drawn by ``Model.init(mesh=)``), or
    ``("plain", seed)`` (drawn whole on this rank's device and placed by
    the engines, as the reference's ``serve_bench --mesh`` gives them).
    ``Engine.generate`` greedy over ``p["prompts"]``, captured and eager:
    tokens, the largest difference of its sampled logits from the run
    without a mesh and their largest magnitude, whether captured and eager
    logits are bit-equal, decode_attention launches on the mesh, its
    static cache's leaves (placements, local and global shapes), the
    collectives of one more eager decode step (``chip_smoke.Collectives``,
    param pieces watched), and what the decode kernel's plain version
    received (on the CPU); then ``SerialSlotEngine`` greedy and
    ``ContinuousEngine`` greedy and at ``p["temperature"]`` over
    ``p["requests"]`` (``_slot_engines``), on the mesh and without one."""
    from repro_torch.convert import to_torch
    from repro_torch.distributed.sharding import axis_rules, is_dtensor
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.models.transformer import cache_items
    from repro_torch.optim.optimizer import tree_leaves
    mesh = _mesh(*p["mesh"])
    model = Model(p["cfg"], RunConfig(max_seq=p["max_len"]), device=DEVICE)

    def params_on(m):
        given = p["params"]
        if isinstance(given, tuple):
            return model.init(torch.Generator(device=DEVICE).manual_seed(
                given[1]))
        if isinstance(given, int):
            return model.init(torch.Generator(device=DEVICE).manual_seed(
                given), mesh=m)
        return to_torch(given, DEVICE)
    seen, plain_ref = [], da.decode_attention_ref

    def spy(q, k, v, valid):
        seen.append([any(is_dtensor(t) for t in (q, k, v, valid)),
                     list(q.shape), list(k.shape)])
        return plain_ref(q, k, v, valid)
    da.decode_attention_ref = spy
    out = {}
    try:
        with axis_rules(mesh), torch.no_grad():
            params = params_on(mesh)
            launches = da.decode_attention.launches
            eng, out["tokens"], got = _engine_run(model, params, p, True)
            out["launches"] = da.decode_attention.launches - launches
            (key, step), = eng._steps.items()
            out["cache"] = [[name, str(leaf.placements),
                             list(leaf.to_local().shape), list(leaf.shape)]
                            for name, leaf, _ in cache_items(step.cache)]
            out["replays"] = step.replays
            # param pieces holding more storage than their own bytes
            out["views"] = [list(t.shape) for t in tree_leaves(eng.params)
                            if t.to_local().untyped_storage().nbytes() >
                            t.to_local().numel() * t.element_size()]
            tok = torch.as_tensor(out["tokens"][:, -1:], device=DEVICE)
            pieces = _weight_pieces(eng.params)
            with _smoke().Collectives(
                    mesh, lambda shape: shape in pieces) as calls:
                eng.decode(eng.params, step.cache, tok)
            out["calls"], out["watched"] = calls.rows(), calls.watched
            del eng, step
            _, eager_toks, eager = _engine_run(model, params, p, False)
            out["eager_equal"] = (bool(torch.equal(got, eager))
                                  and (eager_toks == out["tokens"]).all())
            _slot_engines(model, params, p, out)
            del params
    finally:
        da.decode_attention_ref = plain_ref
    out["seen"] = seen
    if DEVICE.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        params = params_on(None)
        _, plain_toks, want = _engine_run(model, params, p, True)
        out["plain_tokens"] = plain_toks
        out["err"] = float((got - want).abs().max())
        out["scale"] = float(want.abs().max())
        _slot_engines(model, params, p, out, "plain ")
    return out


def serve_skewed(rank, world, p):
    """``ContinuousEngine`` on a ``p["mesh"]`` mesh from the params of
    seed ``p["params"]`` drawn on it (``Model.init(mesh=)``), driven as
    the reference's ``serve_bench`` drives it: each request of
    ``p["stream"]`` submitted once it has arrived, a step after each round
    of submissions, a short sleep while idle before the next arrival.  A
    rank sees arrivals late by ``p["skew"]`` times its rank: ``("s", x)``,
    its ``WallClock`` started x seconds a rank later; or ``("steps", x)``,
    request i arriving at its step 2 i, an odd one x steps a rank later (a
    jitter that one rank's lead on the others would not absorb).  With
    ``p["outside"]`` the engine is built as ``serve_bench.run_config``
    builds it, before ``axis_rules`` and from plain params (drawn whole on
    this rank), so the loop's first submissions come before the first
    ``step`` binds the mesh.  Returns the results, the completed and
    submitted counts and the batched steps run."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.metrics import ServeMetrics, WallClock
    model = Model(p["cfg"], RunConfig(max_seq=p["max_len"]), device=DEVICE)
    stream = p["stream"]                    # (rid, prompt, max_new, arrival)
    kind, skew = p["skew"]
    mesh = _mesh(*p["mesh"])
    gen = torch.Generator(device=DEVICE).manual_seed(p["params"])

    def engine(params):
        return ContinuousEngine(model, params, slots=p["slots"],
                                max_len=p["max_len"], metrics=metrics,
                                queue_limit=p["queue_limit"])
    if kind == "s":
        time.sleep(rank * skew)
    clock = WallClock()
    metrics = ServeMetrics(clock, slots=p["slots"])
    if p.get("outside"):
        eng = engine(model.init(gen))
    with axis_rules(mesh), torch.no_grad():
        if not p.get("outside"):
            eng = engine(model.init(gen, mesh=mesh))
        i = steps = 0

        def arrived(k):
            if kind == "s":
                return stream[k][3] <= clock.now()
            return 2 * k + skew * rank * (k % 2) <= steps
        while i < len(stream) or eng.busy:
            while i < len(stream) and arrived(i):
                rid, prompt, n, arrival = stream[i]
                if not eng.submit(Request(rid, np.asarray(prompt, np.int32),
                                          n), arrival=arrival):
                    break
                i += 1
            steps += 1
            if eng.step() == 0 and i < len(stream) and kind == "s":
                gap = stream[i][3] - clock.now()
                if gap > 0:
                    time.sleep(min(gap, 0.01))
    reqs = metrics.snapshot()["requests"]
    return {"results": eng.results, "steps": eng.steps,
            "completed": reqs["completed"], "submitted": reqs["submitted"]}
