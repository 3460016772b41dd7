"""Multi-rank bodies for the distribution tests (no JAX).

``run(name, world, tmp, payload)`` starts ``world`` CPU processes in a
gloo group over a ``FileStore`` under ``tmp`` (no TCP port, so parallel
test workers cannot collide), runs the function ``name`` of this module
as ``fn(rank, world, payload)`` on each, and returns their results in
rank order.  A run that outlives its ``timeout`` is killed and raises, so
a hang cannot eat the suite's time; the group's own timeout also ends a
stuck collective.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(name: str, world: int, tmp, payload=None, timeout: float = 120.0):
    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_main, args=(world, tmp, name), nprocs=world,
                             join=False, start_method="spawn")
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


def _main(rank: int, world: int, tmp: str, name: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = globals()[name](rank, world, payload)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _np(tree):
    from repro_torch.distributed.sharding import full
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return full(tree).detach().numpy()


def _mesh(data: int, model: int):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


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
    ``p["params"]`` (numpy), AdamW or SGD (``p["opt"]``), one a batch of
    ``p["batches"]``: the losses and the final params."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  sharding_for,
                                                  tree_map_axes)
    from repro_torch.models import moe
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import adamw, sgd
    from repro_torch.train.step import TrainState, make_train_step, new_rng
    mesh = _mesh(*p["mesh"])
    model = Model(p["cfg"], RunConfig(max_seq=64), device="cpu")
    lr = lambda s: torch.tensor(p["lr"])              # noqa: E731
    opt = (adamw(lr, weight_decay=0.01) if p["opt"] == "adamw"
           else sgd(lr))
    moe.set_moe_impl(p.get("impl", "auto"))
    with axis_rules(mesh):
        params = tree_map_axes(
            lambda ax, a: distribute(torch.from_numpy(a),
                                     sharding_for(ax, a.shape, mesh)),
            model.param_axes(), p["params"])
        state = TrainState(params, opt.init(params), new_rng(0, 1))
        fn = make_train_step(model, opt)
        losses, shardmap = [], []
        for b in p["batches"]:
            batch = {k: distribute(torch.from_numpy(v),
                                   sharding_for("batch -", v.shape, mesh))
                     for k, v in b.items()}
            state, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            T = b["tokens"].shape[0] * b["tokens"].shape[1]
            shardmap.append(moe._can_shardmap(p["cfg"], T)
                            if p["cfg"].moe is not None else None)
        placements = {k: str(v.placements) for k, v in
                      state.params["scan"]["pos0"].get("mlp", {}).items()}
        out = {"losses": losses, "params": _np(state.params),
               "shardmap": shardmap, "placements": placements}
    moe.set_moe_impl("auto")
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


def host_mesh_train(rank, world, p):
    """``launch.train.main(--mesh host)`` inside a ``world``-rank group:
    the losses."""
    from repro_torch.launch import train
    res = train.main(p["argv"])
    return {"losses": [h["loss"] for h in res["trainer"].metrics_history],
            "mesh": str(res["mesh"].shape)}


