"""Multi-rank meshes of the port against its own run without a mesh.

This module imports neither ``jax`` nor the JAX package, so it also runs
on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_ranks.py

Each case starts 4 gloo CPU ranks (``_torch_dist_ranks``) and holds the
result of one rank body to the port's own run of the same function
without a mesh, from the same numpy params and batches: train steps on
(2, 2), (1, 4) and (4, 1) meshes (qwen2-7b, and deepseek-v2 with its MoE
on the expert-parallel path), the sharded GEMM, the int8 all-reduce, the
expert-parallel MoE layer, the elastic restore onto another mesh and the
launcher's host mesh.  DTensor decides which ops a sharded tensor may
take in Python, the same on the CPU and on CUDA, so gloo ranks meet the
refusals that NCCL ranks on cards would.  ``test_torch_distributed.py``
holds the same bodies to the JAX reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.core.integrate import gemm_op
from repro_torch.distributed import compression as C
from repro_torch.models import moe
from repro_torch.models.layers import Maker
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import optimizer as opt_mod
from repro_torch.train import step as step_mod

import _torch_dist_ranks as ranks


def test_torch_version():
    """The version the multi-rank cases below ran under, for the log."""
    print(f"torch {torch.__version__}")
    assert torch.distributed.is_available()
    assert torch.distributed.is_gloo_available()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _moe_cfg():
    """Reduced deepseek-v2 with 8 experts at a capacity factor at which
    no path drops a token."""
    c = reduced(get_config("deepseek_v2_236b"))
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=8.0, num_experts=8))


def _cfg(arch):
    return _moe_cfg() if arch == "deepseek_v2_236b" else reduced(
        get_config(arch))


def _batches(vocab, n=3, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (4, 9)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                    "mask": np.ones((4, 8), np.float32)})
    return out


def _optimizer(name, lr):
    if name == "adamw":
        return opt_mod.adamw(lambda s: torch.tensor(lr), weight_decay=0.01)
    return opt_mod.sgd(lambda s: torch.tensor(lr))


def _plain_steps(cfg, params, batches, opt, lr):
    """The port's train steps without a mesh: losses and final params."""
    m = Model(cfg, RunConfig(max_seq=64), device="cpu")
    po = _optimizer(opt, lr)
    tp = to_torch(params, "cpu")
    st = step_mod.TrainState(tp, po.init(tp), step_mod.new_rng(0, 1))
    fn = step_mod.make_train_step(m, po)
    losses = []
    for b in batches:
        st, met = fn(st, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(met["loss"].item())
    return losses, _numpy(st.params)


def _close_to_scale(got, want, tol, what):
    """Each leaf within ``tol`` of its own largest magnitude."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k]) - w).max())
        assert err <= tol * scale, (what, k, err, scale)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "deepseek_v2_236b"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)],
                         ids=lambda m: "x".join(map(str, m)))
def test_train_steps_on_a_mesh_match_no_mesh(tmp_path, mesh, arch, opt):
    """3 train steps on a (data, model) gloo mesh (DTensor params, moments
    and batches; deepseek's MoE on the expert-parallel path, which "auto"
    picks on each mesh) against the port's run without a mesh
    from the same params and batches: losses within 1e-6 relative; after
    SGD steps every param within 1e-6 of its leaf's largest magnitude
    (AdamW's m / sqrt(v) magnifies the rounding of a gradient that is zero
    in exact arithmetic, see ``test_torch_distributed``)."""
    cfg = _cfg(arch)
    params = _numpy(Model(cfg, RunConfig(max_seq=64), device="cpu").init(
        torch.Generator().manual_seed(1)))
    batches = _batches(cfg.vocab_size)
    lr = 3e-3 if opt == "adamw" else 0.3
    out = ranks.run("train_steps", 4, tmp_path,
                    {"cfg": cfg, "params": params, "batches": batches,
                     "mesh": mesh, "lr": lr, "opt": opt})
    losses, final = _plain_steps(cfg, params, batches, opt, lr)
    if cfg.moe is not None:
        assert out[0]["shardmap"] == [True] * 3
    for r in range(4):
        np.testing.assert_allclose(out[r]["losses"], losses, rtol=1e-6)
        if opt == "sgd":
            _close_to_scale(out[r]["params"], final, 1e-6, r)
    if out[0]["placements"] and mesh[1] > 1:
        assert "Shard" in out[0]["placements"]["w_up"]


def test_sharded_gemm_on_a_2x2_mesh_matches_gemm_op(tmp_path):
    """``sharded_gemm_op`` on a (2, 2) mesh against ``gemm_op`` on the
    whole operands: the output and both gradients within 1e-6 of their
    largest magnitude, the rhs gradient a ``Partial`` over data."""
    rng = np.random.default_rng(11)
    a, b, w = (rng.standard_normal(s).astype(np.float32)
               for s in ((16, 24), (24, 8), (16, 8)))
    out = ranks.run("sharded_gemm", 4, tmp_path,
                    {"a": a, "b": b, "w": w, "mesh": (2, 2)})
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    y = gemm_op(16, 8, 24)(ta, tb)
    (y * torch.from_numpy(w)).sum().backward()
    want = {"out": y.detach().numpy(), "ga": ta.grad.numpy(),
            "gb": tb.grad.numpy()}
    for r in range(4):
        o = out[r]
        _close_to_scale({k: o[k] for k in want}, want, 1e-6, r)
        assert o["out_placements"] == "(Shard(dim=0), Replicate())"
        assert o["gb_placements"] == "(Partial(sum), Replicate())"
        assert "not divisible" in o["refused"]


def test_compressed_allreduce_on_a_2x2_mesh_matches_no_group(tmp_path):
    """``compressed_psum_mean`` over 4 ranks and the tree all-reduce over
    ``data`` of a (2, 2) mesh against the same arithmetic without a group:
    each rank's int8 payload summed, times the largest scale over n."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 33)) *
         np.array([[1.0], [3.0], [0.1], [10.0]])).astype(np.float32)
    tree = {"a": rng.standard_normal((4, 5, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 7)).astype(np.float32)}}
    out = ranks.run("compressed", 4, tmp_path, {"x": x, "tree": tree})

    def mean(rows):
        q = [C.quantize_int8(torch.from_numpy(np.ascontiguousarray(r)))
             for r in rows]
        return (sum(qi.to(torch.int32) for qi, _ in q).float()
                * max(s for _, s in q) / len(q)).numpy()
    whole = mean(x)
    for r in range(4):
        np.testing.assert_allclose(out[r]["whole"], whole, rtol=1e-6,
                                   atol=1e-6)
        for key, arr in (("a", tree["a"]), ("b/c", tree["b"]["c"])):
            got = _flat(out[r]["tree"])[key]
            np.testing.assert_allclose(got, mean(arr[[r % 2, r % 2 + 2]]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("data", [1, 2])
def test_expert_parallel_moe_matches_no_mesh(tmp_path, data):
    """``apply_moe`` on DTensors over a (data, 4 // data) mesh on the
    expert-parallel path against the same layer without a mesh: output,
    aux loss and the gradients of the input and every param within 1e-5
    of their largest magnitude."""
    cfg = _moe_cfg()
    gen = torch.Generator().manual_seed(2)
    p = _numpy(moe.init_moe(cfg, Maker("init", generator=gen, device="cpu")))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, cfg.d_model)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    out = ranks.run("shardmap_moe", 4, tmp_path,
                    {"cfg": cfg, "params": p, "x": x, "wy": wy,
                     "impl": "shardmap", "data": data})
    tp = to_torch(p, "cpu")
    tx = torch.from_numpy(x)
    leaves = [tx] + [tp[k] for k in sorted(tp)]
    for t in leaves:
        t.requires_grad_(True)
    y, aux = moe.apply_moe(tp, tx, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(wy)).sum() + aux,
                                leaves)
    want = dict(zip(["x"] + sorted(tp), (g.numpy() for g in grads)))
    for r in range(4):
        assert out[r]["shardmap"]
        _close_to_scale({"y": out[r]["y"]}, {"y": y.detach().numpy()},
                        1e-5, r)
        np.testing.assert_allclose(out[r]["aux"], float(aux.detach()), rtol=1e-5)
        _close_to_scale(out[r]["grads"], want, 1e-5, r)


def test_elastic_restore_from_2x2_onto_4x1(tmp_path):
    """A train state made on a (2, 2) mesh equals the one made without a
    mesh from the same seed, and restores onto (4, 1) bit-equal with that
    mesh's placements."""
    out = ranks.run("elastic", 4, tmp_path, {"dir": str(tmp_path / "ck")})
    model = Model(reduced(get_config("qwen2-7b")), RunConfig(max_seq=32),
                  device="cpu")
    plain = step_mod.init_state(model, opt_mod.adamw(lambda s: 1e-3),
                                torch.Generator().manual_seed(0))
    want = [x.detach().numpy() for x in opt_mod.tree_leaves(plain.params)]
    for r in range(4):
        o = out[r]
        assert o["step"] == 1
        assert len(o["a"]) == len(want)
        for w, a, b in zip(want, o["a"], o["b"]):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
        for a, b in zip(o["m_a"], o["m"]):
            np.testing.assert_array_equal(a, b)
        assert all(s == "(4, 1)" for s in o["mesh_b"])
        V, d = o["a"][0].shape
        assert o["local_a"][0] == (V // 2, d // 2)
        assert o["local_b"][0] == (V, d // 4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm-2b"])
def test_host_mesh_launcher_in_four_ranks(tmp_path, arch):
    """``launch.train --mesh host`` in a 4-rank gloo group trains on a
    (4, 1) mesh with the launcher's losses without a mesh, within 1e-6."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--global-batch", "4"]
    out = ranks.run("host_mesh_train", 4, tmp_path,
                    {"argv": argv + ["--mesh", "host"]})
    from repro_torch.launch import train
    base = [h["loss"] for h in train.main(argv)["trainer"].metrics_history]
    assert len(base) == 3
    for r in range(4):
        assert out[r]["mesh"] == "(4, 1)"
        np.testing.assert_allclose(out[r]["losses"], base, rtol=1e-6)
