"""Multi-rank meshes of the port against its own run without a mesh.

This module imports neither ``jax`` nor the JAX package, so it also runs
on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_ranks.py

Each case starts 4 gloo CPU ranks (``_torch_dist_ranks``) and holds the
result of one rank body to the port's own run of the same function
without a mesh, from the same numpy params and batches: train steps on
(2, 2), (1, 4) and (4, 1) meshes (qwen2-7b, and deepseek-v2 with its MoE
on the expert-parallel path), two train steps of every other registry
family on (2, 2), the sharded GEMM, the int8 all-reduce, the
expert-parallel MoE layer, the elastic restore onto another mesh, the
launcher's host mesh and the per-layer reduction of the stacked leaves'
gradients.  Checkpoints on the group: a (2, 2) state saved with each
rank writing only its own pieces and restored onto (4, 1), (1, 4), (2, 2)
and one process; ``Trainer`` resumed from one, bit-equal to a straight
run; a SIGTERM seen by one rank stopping all four at the same step; and
``FailoverRunner`` rolling every rank back when one fails.  Serving on
(1, 4) and (2, 2): ``Engine``, ``SerialSlotEngine`` and
``ContinuousEngine`` given plain params under ``axis_rules``, against the
same engines without a mesh, and ``ContinuousEngine`` driven by ranks that
see the arrivals at other times.  DTensor decides which ops a sharded tensor may take in
Python, the same on the CPU and on CUDA, so gloo ranks meet the
refusals that NCCL ranks on cards would.  ``test_torch_distributed.py``
holds the same bodies to the JAX reference.

The state split of full qwen2-7b and of deepseek-v2 (2, 3 and 60 layers)
on four ranks is reckoned from shapes and ``pspec_for`` alone, and
qwen2-7b's step, deepseek-v2's MoE layer and its 2-layer loss traced on
a ``"fake"`` group of meta tensors (in a subprocess, so no worker keeps
a group).  ``chip_smoke.py``'s four-card deepseek-v2 parts run here on
gloo ranks at the reduced width.  The cases marked ``cuda`` need four
cards (NCCL ranks, one a card) and skip with fewer: qwen2-7b at full
width cut to two layers on (2, 2) and (4, 1) against one card without a
mesh, with SGD, and with the launcher's recipe (AdamW, its cosine
schedule, remat full, its batches) on (4, 1), and its checkpoint after
two AdamW steps on (4, 1) restored onto (2, 2) and one card; deepseek-v2
at full width on (1, 4) and (2, 2), its MoE layer and 3 SGD steps of 2
layers; qwen1.5-32b at full width cut to 2 layers served on (1, 4):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_ranks.py
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.core.integrate import gemm_op
from repro_torch.distributed.sharding import pspec_for, spec_axes
from repro_torch.distributed import compression as C
from repro_torch.models import moe
from repro_torch.models.layers import Maker
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import optimizer as opt_mod
from repro_torch.serve import loadgen
from repro_torch.serve.continuous import ContinuousEngine, Request
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


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _moe_cfg(arch="deepseek_v2_236b"):
    """A reduced MoE config with 8 experts at a capacity factor at which
    no path drops a token."""
    c = reduced(get_config(arch))
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=8.0, num_experts=8))


def _cfg(arch):
    c = get_config(arch)
    return _moe_cfg(arch) if c.moe is not None else reduced(c)


def _batches(cfg, n=3, seed=9):
    """``n`` batches of 4 x 8 tokens, with the stub frontend's input
    (whisper's frames, pixtral's patches) as ``tests/test_torch_train.py``
    makes it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:],
             "mask": np.ones((4, 8), np.float32)}
        if cfg.encoder is not None:
            b["extra_embeds"] = rng.standard_normal(
                (4, cfg.encoder.context, cfg.encoder.d_model)).astype(
                    np.float32)
        elif cfg.frontend:
            b["extra_embeds"] = rng.standard_normal(
                (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _plain_steps(cfg, params, batches, opt, lr):
    """The port's train steps without a mesh: losses and final params."""
    losses, final = ranks.plain_steps(cfg, params, batches, opt, lr)
    return losses, _numpy(final)


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
    batches = _batches(cfg)
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


# checkpoints on a group of four ranks: each writes and reads only its own
# pieces (checkpoint/checkpointer.py)

ONTO = [(4, 1), (1, 4), (2, 2)]


@pytest.fixture(scope="module", params=["qwen2_7b", "deepseek_v2_236b"])
def sharded_ckpt(request, tmp_path_factory):
    """A (2, 2) state after one AdamW step saved by four ranks and
    restored by each onto ``ONTO`` (``ranks.ckpt_sharded``): reduced
    qwen2-7b in f32, deepseek-v2 (8 experts) in bf16."""
    tmp = tmp_path_factory.mktemp(request.param)
    bf16 = request.param == "deepseek_v2_236b"
    model = {"cfg": _cfg(request.param),
             "run": {"max_seq": 16,
                     "param_dtype": "bfloat16" if bf16 else "float32"}}
    out = ranks.run("ckpt_sharded", 4, tmp, {
        **model, "dir": str(tmp / "ck"), "onto": ONTO})
    return tmp / "ck" / "step_00000001", out, model


def test_group_save_writes_each_piece_once_and_gathers_nothing(
        sharded_ckpt):
    """On (2, 2) no rank calls ``full_tensor`` or ``redistribute`` while
    it saves, every rank writes, the bytes all ranks write sum to the
    state's bytes once (a piece replicated over an axis written by one
    rank), no rank saves an array larger than the largest piece, and the
    manifest keeps the reference's index (bf16 leaves as ``bfloat16``)
    with pieces that tile each leaf."""
    path, out, _ = sharded_ckpt
    saved = out[0]["saved"]
    with open(path / "manifest.json") as f:
        index = json.load(f)["index"]
    assert sorted(index) == sorted(saved)
    largest = 0
    for key, meta in index.items():
        assert meta["shape"] == list(saved[key].shape)
        assert meta["dtype"] in (str(saved[key].dtype), "bfloat16")
        whole = np.zeros(saved[key].shape, np.int64)
        for p in meta["pieces"]:
            arr = np.load(path / p["file"], mmap_mode="r")
            assert list(arr.shape) == p["shape"]
            whole[tuple(slice(o, o + n) for o, n in
                        zip(p["offset"], p["shape"]))] += 1
            largest = max(largest, arr.nbytes)
        assert (whole == 1).all(), key
    assert any(m["dtype"] == "bfloat16" for m in index.values()) == (
        "deepseek" in str(path))
    assert sum(o["io"]["bytes"] for o in out) == \
        sum(a.nbytes for a in saved.values())
    for o in out:
        assert o["calls"] == {"full_tensor": 0, "redistribute": 0}
        assert 0 < o["largest"] <= largest
        assert o["io"]["bytes"] > 0


@pytest.mark.parametrize("onto", ONTO + [None],
                         ids=lambda m: "x".join(map(str, m)) if m
                         else "one-process")
def test_group_checkpoint_restores_bit_equal_onto_any_mesh(sharded_ckpt,
                                                           onto):
    """The (2, 2) checkpoint restores bit-equal in params, m, v, step and
    rng onto (4, 1), (1, 4) and (2, 2), each rank reading exactly the
    bytes of its own pieces; and in this process, without a group or
    shardings, as whole leaves."""
    from repro_torch.checkpoint import checkpointer as ckpt
    path, out, _ = sharded_ckpt
    want = out[0]["saved"]
    if onto is None:
        tree, extra = ckpt.restore(str(path.parent))
        got = [{"state": ranks.flat_np(tree), "step": extra["step"]}]
        assert ckpt.io["restore"]["bytes"] == \
            sum(a.nbytes for a in want.values())
    else:
        got = [o["restored"][onto] for o in out]
        for g in got:
            assert g["io"]["bytes"] == g["local_bytes"]
            assert g["local_bytes"] < sum(a.nbytes for a in want.values())
    for g in got:
        assert g["step"] == 1
        assert sorted(g["state"]) == sorted(want)
        for key, w in want.items():
            assert g["state"][key].dtype == w.dtype, key
            np.testing.assert_array_equal(g["state"][key], w, err_msg=key)


def test_one_file_checkpoint_restores_onto_a_group(sharded_ckpt,
                                                   tmp_path):
    """A one-file checkpoint (the reference's ``arrays.npz`` of whole
    leaves, as a process without a group or the parent's mesh writer
    saves) restores on four ranks onto (2, 2) and (4, 1), both as new
    DTensors (``restore(shardings=)``) and into a mesh state's own
    DTensors (``restore(target=)``), bit-equal in params, m, v, step and
    rng to the state it was saved from."""
    from repro_torch.checkpoint import checkpointer as ckpt
    path, out, model = sharded_ckpt
    want = out[0]["saved"]
    whole, extra = ckpt.restore(str(path.parent))
    ckpt.save(str(tmp_path / "one"), extra["step"], whole)
    assert sorted(os.listdir(tmp_path / "one" / "step_00000001")) == \
        ["arrays.npz", "manifest.json"]
    onto = [(2, 2), (4, 1)]
    got = ranks.run("ckpt_whole", 4, tmp_path, {
        **model, "dir": str(tmp_path / "one"), "onto": onto})
    for o in got:
        assert sorted(o) == sorted((m, way) for m in onto
                                   for way in ("shardings", "target"))
        for (mesh, way), g in o.items():
            assert g["step"] == 1 and g["meshes"] == [str(mesh)]
            assert g.get("in_place", True), (mesh, way)
            _same_state(g["state"], want)


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)],
                         ids=lambda m: "x".join(map(str, m)))
def test_resumed_training_on_a_mesh_is_bit_equal_to_straight(tmp_path,
                                                             mesh):
    """Through ``Trainer`` on four ranks (reduced qwen2-7b, AdamW): two
    steps and a checkpoint, then a run from another seed's state that
    resumes from it and takes two more, equal bit for bit to four steps
    straight (losses, params, moments, step, rng)."""
    out = ranks.run("trainer_resume", 4, tmp_path, {
        "cfg": reduced(get_config("qwen2_7b")), "mesh": mesh, "steps": 4,
        "stop": 2, "dir": str(tmp_path / "ck")})
    for o in out:
        straight = o["straight"]["losses"]
        assert len(straight) == 4 and all(np.isfinite(straight))
        assert o["first"]["losses"] == straight[:2]
        assert o["resumed"]["losses"] == straight[2:]
        assert o["first"]["steps"] == [2] and o["resumed"]["steps"] == [2, 4]
        assert any("resumed from step 2" in line
                   for line in o["resumed"]["log"])
        _same_state(o["resumed"]["state"], o["straight"]["state"])


def test_preemption_on_one_rank_stops_every_rank_at_the_same_step(
        tmp_path):
    """SIGTERM reaches rank 1 alone, during its third step of six: every
    rank stops after that step, the checkpoint of step 3 commits once,
    and the run that resumes from it ends bit-equal to six steps
    straight.  (Were the flag not combined, rank 1 would enter the save
    while the others ran step 4, and the run would hang.)"""
    out = ranks.run("trainer_resume", 4, tmp_path, {
        "cfg": reduced(get_config("qwen2_7b")), "mesh": (2, 2), "steps": 6,
        "signal": (1, 2), "dir": str(tmp_path / "ck")}, timeout=150)
    for o in out:
        assert len(o["first"]["losses"]) == 3
        assert any("preempted at step 3" in line
                   for line in o["first"]["log"])
        assert sum("checkpointed step" in line
                   for line in o["first"]["log"]) == 1
        assert o["first"]["steps"] == [3] and o["resumed"]["steps"] == [3, 6]
        assert o["first"]["losses"] + o["resumed"]["losses"] == \
            o["straight"]["losses"]
        _same_state(o["resumed"]["state"], o["straight"]["state"])


def test_failover_on_a_group_rolls_every_rank_back_together(tmp_path):
    """``FailoverRunner`` on (2, 2) whose step raises on rank 2 alone, at
    the end of its fourth call of six steps (a checkpoint every 2): every
    rank counts the failure, rolls back to step 2 and replays, ending
    bit-equal to six steps straight.  (Were the failure not combined,
    rank 2 alone would restore and replay step 3 while the others ran
    step 4, their collectives paired across steps.)"""
    out = ranks.run("failover_group", 4, tmp_path, {
        "cfg": reduced(get_config("qwen2_7b")), "mesh": (2, 2), "steps": 6,
        "every": 2, "fail": (2, 3), "dir": str(tmp_path / "ck")})
    for o in out:
        assert (o["failures"], o["replayed"], o["end"]) == (1, 1, 6)
        _same_state(o["state"], o["straight"])


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


FAMILIES = ("recurrentgemma_2b", "mamba2_130m", "gemma3_4b", "qwen1_5_32b",
            "minicpm_2b", "kimi_k2_1t", "whisper_base", "pixtral_12b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_steps_on_a_2x2_mesh_match_no_mesh(tmp_path, arch):
    """2 SGD steps of each other registry family (reduced; kimi-k2 with 8
    experts at capacity factor 8, so no token is dropped; whisper-base
    and pixtral-12b on their stub frames and patches) on a (2, 2) gloo
    mesh against the port's run without a mesh from the same params and
    batches: losses within 1e-6 relative, every param within 1e-6 of its
    leaf's largest magnitude."""
    cfg = _cfg(arch)
    params = _numpy(Model(cfg, RunConfig(max_seq=64), device="cpu").init(
        torch.Generator().manual_seed(1)))
    batches = _batches(cfg, n=2)
    out = ranks.run("train_steps", 4, tmp_path,
                    {"cfg": cfg, "params": params, "batches": batches,
                     "mesh": (2, 2), "lr": 0.3, "opt": "sgd"})
    losses, final = _plain_steps(cfg, params, batches, "sgd", 0.3)
    assert all(np.isfinite(losses))
    for r in range(4):
        np.testing.assert_allclose(out[r]["losses"], losses, rtol=1e-6)
        _close_to_scale(out[r]["params"], final, 1e-6, r)


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_stacked_gradients_are_reduced_as_the_backward_makes_them(
        tmp_path, mesh):
    """``transformer._placed`` (through ``sharding.reduced_grad``)
    reduces each layer's ``Partial`` gradient of a stacked leaf as the
    backward produces it: one SGD step
    (remat full) on a gloo mesh gives the loss and params of the same step
    where each layer's gradient waits for the stack (a ``placed_grad``
    that only watches), and the whole-size gradient bytes alive at
    once on a rank fall from every layer's and the head's to the largest
    one (reduced qwen2-7b at 4 layers).  The params agree within 1e-6 of each
    leaf's largest magnitude: an all-reduce of one layer's slice may sum
    the ranks in another order than one of the stack."""
    cfg = reduced(get_config("qwen2_7b"), layers=4)
    rng = np.random.default_rng(3)
    t = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    out = ranks.run("grad_peak", 4, tmp_path,
                    {"cfg": cfg, "mesh": mesh, "lr": 0.3,
                     "batch": {"tokens": t[:, :-1], "labels": t[:, 1:]}})
    # the leaves whose gradient comes back Partial over data (the fsdp dim
    # is their contraction dim): wq, wk, wv, w_gate, w_up of each layer,
    # and the head
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    layer = 4 * (d * d + 2 * d * kv + 2 * d * ff) // mesh[1]
    head = 4 * d * V // mesh[1]
    for r in range(4):
        o = out[r]
        print(f"rank {r} mesh {mesh}: whole-size gradient bytes alive at "
              f"once {o['reduce']['peak']} (reduced as made) against "
              f"{o['watch']['peak']} (waiting for the stack); one layer's "
              f"{layer}, the head's {head}")
        assert o["reduce"]["loss"] == o["watch"]["loss"]
        _close_to_scale(o["reduce"]["params"], o["watch"]["params"], 1e-6, r)
        assert o["watch"]["peak"] >= cfg.num_layers * layer + head
        assert 0 < o["reduce"]["peak"] <= max(head, 4 * d * ff // mesh[1])


def _flat_meta(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_meta(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_qwen2_7b_state_splits_four_ways(mesh):
    """Full qwen2-7b's params (meta tensors, their logical axes and
    ``pspec_for`` over the mesh's axis sizes; nothing allocated) split to
    1.904 G a rank on four ranks, 30.5 GB of f32 AdamW state (params,
    gradients, m, v) a card against 121.8 GB whole; the only leaves not
    split four ways are the norms and the QKV biases."""
    model = Model(get_config("qwen2-7b"), RunConfig(max_seq=256),
                  device="meta")
    shapes = _flat_meta(model.param_shapes())
    axes = _flat_meta(model.param_axes())
    sizes = {"data": mesh[0], "model": mesh[1]}
    per, whole = 0, {}
    for k, t in shapes.items():
        spec = pspec_for(axes[k].split(), t.shape, sizes)
        n = int(np.prod([sizes[a] for e in spec for a in spec_axes(e)]))
        assert t.numel() % n == 0, k
        per += t.numel() // n
        if n != 4:
            whole[k] = t.numel()
    total = sum(t.numel() for t in shapes.values())
    assert total == 7_615_616_512
    assert sorted(whole) == ["/final_norm", "/scan/pos0/attn/bk",
                             "/scan/pos0/attn/bq", "/scan/pos0/attn/bv",
                             "/scan/pos0/attn/norm", "/scan/pos0/mlp/norm"]
    assert sum(whole.values()) == 333_312
    assert round(per / 1e6) == 1904
    assert round(16 * per / 1e8) == 305 and round(16 * total / 1e8) == 1218


# the collectives a rank makes, recorded below DTensor on a "fake" group
# of 4 ranks with meta DTensors: (op, mesh axis, the local tensor's shape)
_RECORD = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.launch.dryrun import fake_group

fake_group(4)


def make_mesh(data, model):
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(data, model),
                      mesh_dim_names=("data", "model"))
    axis = {tuple(dist.get_process_group_ranks(mesh.get_group(n))): n
            for n in ("data", "model")}
    return mesh, axis


class Record(TorchDispatchMode):
    def __init__(self, axis):
        super().__init__()
        self.axis, self.phase = axis, "forward"
        self.calls = {"forward": [], "backward": []}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        names = [a.name for a in func._schema.arguments]
        if func.namespace == "_c10d_functional" and "group_name" in names:
            vals = dict(zip(names, args), **kwargs)
            pg = _resolve_process_group(vals["group_name"])
            self.calls[self.phase].append(
                (func.overloadpacket.__name__,
                 self.axis.get(tuple(dist.get_process_group_ranks(pg)), "?"),
                 list(args[0].shape)))
        return func(*args, **kwargs)


# the collectives of cfg's loss and gradients (remat full, 8 x 256 tokens)
# on a (data, model) mesh of meta DTensors
def traced_loss(cfg, data, model):
    from repro_torch.distributed.sharding import (axis_rules, distribute,
        map_shardings, replicate_plain, sharding_for, tree_shardings)
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.optim.optimizer import tree_leaves
    mesh, axis = make_mesh(data, model)
    m = Model(cfg, RunConfig(max_seq=256, remat="full", backend="torch"),
              device="meta")
    with axis_rules(mesh):
        shapes = m.param_shapes()
        params = map_shardings(lambda s, t: distribute(t, s),
                               tree_shardings(m.param_axes(), shapes, mesh),
                               shapes)
        tok = torch.empty((8, 256), dtype=torch.int64, device="meta")
        tok = distribute(tok, sharding_for("batch -", tok.shape, mesh))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        rec = Record(axis)
        with rec, replicate_plain(leaves[0]):
            loss, _ = m.loss(params, {"tokens": tok, "labels": tok})
            rec.phase = "backward"
            torch.autograd.grad(loss, leaves)
    return rec.calls
"""

_TRACE = _RECORD + r"""
from repro_torch.configs.base import get_config
print(json.dumps({f"{d}x{m}": traced_loss(get_config("qwen2-7b"), d, m)
                  for d, m in ((4, 1), (2, 2))}))
"""


def _traced(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_qwen2_7b_forward_gathers_one_layer_at_a_time():
    """Full qwen2-7b's loss and gradients (remat full, 8 x 256 tokens)
    traced on a ``"fake"`` group of 4 ranks with meta DTensors (nothing
    allocated) on (4, 1) and (2, 2): no collective carries a tensor with
    the layer-stack axis (each stacked leaf is unbound once, and each
    layer's slice is gathered where it is used), and on (2, 2) the
    forward gathers nothing over ``model`` but the logits for the loss
    (the 28 query and 4 KV heads divide by 2)."""
    out = _traced(_TRACE)
    layers = get_config("qwen2-7b").num_layers
    V = get_config("qwen2-7b").padded_vocab
    for mesh, rec in out.items():
        every = rec["forward"] + rec["backward"]
        assert any(k == "all_gather_into_tensor" for k, _, _ in
                   rec["forward"]), mesh
        assert not [c for c in every if len(c[2]) == 3
                    and c[2][0] % layers == 0 and c[2][0] >= layers], mesh
        over_model = [c for c in rec["forward"]
                      if c[0] == "all_gather_into_tensor" and c[1] == "model"]
        if mesh == "2x2":
            assert over_model == [["all_gather_into_tensor", "model",
                                   [4, 256, V // 2]]]
        else:
            assert over_model == []


def _deepseek(layers):
    """deepseek-v2-236b at full width cut to ``layers`` layers (the dense
    first layer, then MoE layers)."""
    return dataclasses.replace(get_config("deepseek-v2-236b"),
                               num_layers=layers)


@pytest.mark.parametrize("layers,params,whole,per_card", [
    (2, 5_519_108_096, 88.3, (22.2, 22.1, 22.1)),
    (3, 9_571_439_104, 153.1, (38.4, 38.3, 38.3)),
    (60, 240_554_306_560, 3848.9, (964.9, 963.1, 962.2))],
    ids=["2L", "3L", "60L"])
def test_deepseek_v2_state_splits_four_ways(layers, params, whole, per_card):
    """deepseek-v2-236b at full width cut to 2 and 3 layers, and whole
    (meta tensors and ``pspec_for`` over each mesh's axis sizes; nothing
    allocated): its params, its f32 AdamW state (params, gradients, m, v:
    16 bytes a param) whole, and a card's share on (1, 4), (2, 2) and
    (4, 1).  The 2-layer cut's state (88.3 GB) fits no one card, but its
    SGD state (params and gradients, 44.2 GB) does; the 3-layer cut's
    153.1 GB is 38.3-38.4 GB a card on every four-rank mesh."""
    model = Model(_deepseek(layers), RunConfig(max_seq=256), device="meta")
    shapes = _flat_meta(model.param_shapes())
    axes = _flat_meta(model.param_axes())
    total = sum(t.numel() for t in shapes.values())
    assert total == params
    assert round(16 * total / 1e9, 1) == whole
    if layers == 2:
        assert round(8 * total / 1e9, 1) == 44.2
    for mesh, want in zip(((1, 4), (2, 2), (4, 1)), per_card):
        sizes = {"data": mesh[0], "model": mesh[1]}
        per = 0
        for k, t in shapes.items():
            spec = pspec_for(axes[k].split(), t.shape, sizes)
            n = int(np.prod([sizes[a] for e in spec for a in spec_axes(e)]))
            assert t.numel() % n == 0, k
            per += t.numel() // n
        assert round(16 * per / 1e9, 1) == want, mesh


_MOE_TRACE = _RECORD + r"""
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import (axis_rules, distribute,
    replicate_plain, sharding_for)
from repro_torch.models import moe
from repro_torch.models.layers import Maker

cfg = get_config("deepseek-v2-236b")
out = {}
for data, model in ((1, 4), (2, 2), (4, 1)):
    mesh, axis = make_mesh(data, model)
    for B, S in ((4, 1), (8, 256)):
        with axis_rules(mesh):
            axes = moe.init_moe(cfg, Maker("axes"))
            p = {k: distribute(v, sharding_for(axes[k], v.shape, mesh)
                               ).requires_grad_(True)
                 for k, v in moe.init_moe(cfg, Maker("shape")).items()}
            x = torch.empty((B, S, cfg.d_model), device="meta")
            x = distribute(x, sharding_for("batch - -", x.shape, mesh)
                           ).requires_grad_(True)
            rec = Record(axis)
            with rec, replicate_plain(x):
                y, aux = moe.apply_moe(p, x, cfg)
                rec.phase = "backward"
                torch.autograd.grad(y.sum() + aux, [x] + list(p.values()))
            out[f"{data}x{model} T{B * S}"] = dict(
                rec.calls, expert_parallel=moe._can_shardmap(cfg, B * S))
print(json.dumps(out))
"""

_DEEPSEEK_LOSS_TRACE = _RECORD + r"""
import dataclasses
from repro_torch.configs.base import get_config
print(json.dumps(traced_loss(dataclasses.replace(
    get_config("deepseek-v2-236b"), num_layers=2), 1, 4)))
"""


def _expert_weights(calls, cfg):
    """The recorded collectives whose tensor is a piece of an expert
    weight (or of its gradient): its last two dims a piece of d_model by
    a piece of expert_ff, in either order, cut at most four ways each."""
    d, f = cfg.d_model, cfg.moe.expert_ff
    pieces = {(d // a, f // b) for a in (1, 2, 4) for b in (1, 2, 4)}
    return [c for c in calls if len(c[2]) >= 3 and (
        tuple(c[2][-2:]) in pieces or tuple(c[2][-2:])[::-1] in pieces)]


def test_moe_layer_keeps_its_experts_sharded_on_both_paths():
    """deepseek-v2's MoE layer at full width (160 experts of 5120 x 1536)
    traced with its backward on a ``"fake"`` group of 4 ranks (meta
    DTensors): at 4 tokens (a decode step, T * K = 24 < 160: the dense
    path) and 2048 (8 x 256: the expert-parallel path) on (1, 4), (2, 2)
    and (4, 1).  On (1, 4) no collective carries a piece of an expert
    weight at either size: the dense path gathers only its (E, C, d)
    token buffer, where it used to gather all 160 experts on every rank
    (3 x 40 x 5120 x 1536 values a rank).  On (2, 2) expert weights move
    only over ``data`` (the ``fsdp`` halves, as the reference's expert
    specs gather them), never over ``model``."""
    out = _traced(_MOE_TRACE)
    cfg = get_config("deepseek-v2-236b")
    assert sorted(out) == sorted(f"{m} T{t}" for m in ("1x4", "2x2", "4x1")
                                 for t in (4, 2048))
    for key, rec in out.items():
        every = rec["forward"] + rec["backward"]
        moved = _expert_weights(every, cfg)
        print(key, "expert-parallel" if rec["expert_parallel"] else "dense",
              f"{len(every)} collectives, {len(moved)} with expert weights",
              moved)
        assert rec["expert_parallel"] == key.endswith("T2048"), key
        if key.startswith("1x4"):
            assert moved == [], key
        elif key.startswith("2x2"):
            assert moved and {c[1] for c in moved} == {"data"}, key
        if key == "1x4 T4":
            # the token buffer: (E / 4, C, d) gathered over model, C = 1
            assert ["all_gather_into_tensor", "model",
                    [cfg.moe.num_experts // 4, 1, cfg.d_model]
                    ] in rec["forward"]


def test_deepseek_v2_loss_never_gathers_its_experts():
    """deepseek-v2-236b at full width cut to 2 layers (the dense first
    layer and one MoE layer; 5.519 G params), its loss and gradients over
    8 x 256 tokens (remat full) traced on a ``"fake"`` group with meta
    DTensors on (1, 4): no collective of the forward or the backward
    carries a piece of an expert weight or of its gradient."""
    rec = _traced(_DEEPSEEK_LOSS_TRACE)
    every = rec["forward"] + rec["backward"]
    assert rec["forward"] and rec["backward"]
    assert _expert_weights(every, _deepseek(2)) == []


def _smoke():
    """``chip_smoke.py`` as a module (its four-card parts and checks)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_four_card_deepseek_parts_hold_on_gloo_at_reduced_size(tmp_path,
                                                               mesh):
    """``chip_smoke.py --launcher-cards 4``'s deepseek-v2 parts
    (``moe_parts``) on 4 gloo ranks with the family's reduced config (16
    experts, top-2): (a) the MoE layer on 4 x 8 tokens, (b) on (1, 4)
    serving a 4 x 8 prefill and 2 decode steps in f32 and bf16, (c) 3
    steps of plain SGD and (d) 3 steps of the launcher's recipe on 4 x 16 batches,
    each against its run without a mesh in the same rank; every check of
    ``moe_report`` holds as on the cards (within 1e-5; the serving logits
    at phase 6d's gates), and the decode steps move no expert weight."""
    out = ranks.run("smoke_parts", 4, tmp_path,
                    {"mesh": mesh, "reduced": True, "layer_tokens": (4, 8),
                     "batch": (4, 16), "serve": (4, 8, 2), "steps": 3},
                    timeout=300)
    for part in ("layer", "train", "state") + (("serve",) if mesh[0] == 1
                                               else ()):
        assert "error" not in out[0][part], out[0][part]
    _smoke().moe_report(out, mesh, 0.0)
    if mesh[0] == 1:
        assert out[0]["serve"]["prefill_ep"]
        assert out[0]["serve"]["decode_dense"]
    else:
        assert "serve" not in out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_deepseek_v2_at_full_width_on_four_cards_matches_one_card(tmp_path,
                                                                  mesh):
    """deepseek-v2-236b at full width on four NCCL ranks, a card each,
    params of seed 0 drawn on every card, through ``chip_smoke.py``'s parts
    (a) and (c) against the same work on one card (each rank's own):
    (a) the MoE layer (160 experts, top-6, f32) on 8 x 256 tokens at the
    config's capacity factor of 1.25, on the expert-parallel path: output,
    aux loss and the gradients of the input and every param within 1e-5
    of their largest magnitude (on (2, 2) against the layer on each data
    shard's rows apart, each at its own capacity; tokens re-routed at a
    near-tie held apart); (c) 3 steps of plain SGD (lr 0.1, no momentum)
    of the 2-layer cut (5.519 G params; its params and gradients fit one
    card, with AdamW's or momentum's state they do not) on the launcher's
    8 x 256 batches of seed 0 at capacity factor 1.25, on (2, 2) against
    one card's run at each data shard's capacity (``ShardedMoE``): losses
    within 1e-5 relative, params within 1e-5 of each leaf's largest
    magnitude."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out = ranks.run("smoke_parts", 4, tmp_path,
                    {"mesh": mesh, "parts": ["layer", "train"]},
                    timeout=900, device="cuda")
    for part in ("layer", "train"):
        assert "error" not in out[0][part], out[0][part]
    _smoke().moe_report(out, mesh, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)],
                         ids=lambda m: "x".join(map(str, m)))
def test_full_width_on_four_cards_matches_one_card(tmp_path, mesh):
    """qwen2-7b at full width cut to 2 layers (1.556 G params) on four
    NCCL ranks, a card each: 3 SGD steps from the params of seed 0 (drawn
    on each card, ``Model.init(mesh=)``) against the same steps without a
    mesh on one card (each rank's own, after its mesh run): losses within
    1e-5 relative, every param within 1e-5 of its leaf's largest
    magnitude."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    assert round(Model(cfg, RunConfig(max_seq=64), device="meta")
                 .param_count() / 1e6) == 1556
    out = ranks.run("train_steps", 4, tmp_path,
                    {"cfg": cfg, "params": 0, "batches": _batches(cfg),
                     "mesh": mesh, "lr": 0.1, "opt": "sgd", "plain": True},
                    timeout=900, device="cuda")
    for r in range(4):
        o = out[r]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(o["losses"], o["plain_losses"]))
        share = max(err / max(scale, 1e-30)
                    for err, scale in o["shares"].values())
        print(f"rank {r} mesh {mesh}: losses {o['losses']} against one "
              f"card's {o['plain_losses']}: worst relative {rel:.3e} "
              f"(bound 1e-5); params: worst difference {share:.3e} of its "
              f"leaf's largest magnitude (bound 1e-5)")
        assert len(o["losses"]) == 3 and all(np.isfinite(o["losses"]))
        np.testing.assert_allclose(o["plain_losses"],
                                   out[0]["plain_losses"], rtol=1e-6)
        assert rel <= 1e-5 and share <= 1e-5


@pytest.mark.cuda
def test_full_width_checkpoint_on_four_cards_restores_anywhere(tmp_path):
    """qwen2-7b at full width cut to 2 layers (1.556 G params, 18.7 GB of
    f32 AdamW state) on four NCCL ranks, a card each: two AdamW steps on
    (4, 1) from the params of seed 0, saved (each rank its own pieces);
    restored onto (2, 2) the state equals the saved one leaf by leaf, and
    restored whole onto one card without a group its leaves' SHA-256
    equal rank 0's of the saved state; the third step's loss from each
    within 1e-6 relative of the third step on (4, 1)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.checkpoint import checkpointer as ckpt
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    batches = _batches(cfg)
    out = ranks.run("ckpt_cards", 4, tmp_path,
                    {"cfg": cfg, "batches": batches, "lr": 1e-4,
                     "dir": str(tmp_path / "ck")},
                    timeout=900, device="cuda")
    dev = torch.device("cuda", 0)
    model = Model(cfg, RunConfig(max_seq=64), device=dev)
    opt = ranks.optimizer("adamw", 1e-4)
    state, extra = ckpt.restore(str(tmp_path / "ck"),
                                target=step_mod.state_shapes(model, opt),
                                device=dev)
    one = ckpt.io["restore"]
    same = ranks.digests(state) == out[0]["digests"]
    _, met = step_mod.make_train_step(model, opt)(
        state, {k: torch.from_numpy(v).to(dev) for k, v in batches[2].items()})
    third_one = met["loss"].item()
    del state, met
    torch.cuda.empty_cache()
    want = out[0]["third"]
    for r, o in enumerate(out):
        print(f"rank {r}: losses {o['losses']}, saved "
              f"{o['save']['bytes'] / 1e9:.3f} GB in "
              f"{o['save']['seconds']:.2f} s, read onto (2, 2) "
              f"{o['restore']['bytes'] / 1e9:.3f} GB in "
              f"{o['restore']['seconds']:.2f} s; third step on (4, 1) "
              f"{o['third']!r}, on (2, 2) {o['third_2x2']!r}")
        assert o["step"] == 2 and o["differ"] == []
        assert o["third"] == want
        assert abs(o["third_2x2"] - want) <= 1e-6 * abs(want)
    print(f"one card: read {one['bytes'] / 1e9:.3f} GB in "
          f"{one['seconds']:.2f} s, digests equal {same}, third step "
          f"{third_one!r}")
    assert extra["step"] == 2 and same
    assert abs(third_one - want) <= 1e-6 * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("peak", [1e-4, 3e-3], ids=lambda x: f"lr{x:g}")
def test_launcher_recipe_on_four_cards_matches_one_card(tmp_path, peak):
    """The launcher's training recipe (``launch/train.py``: AdamW with
    weight decay 0.01, the cosine schedule of an 8-step run, warmup 1,
    remat full, its pipeline's 8 x 256-token batches of seed 0) at
    qwen2-7b's full width cut to 2 layers, its first 3 steps from the
    params of seed 0 on the launcher's (4, 1) mesh over four NCCL ranks
    (a card each) against the same steps without a mesh on one card: the
    backward of remat full and AdamW on NCCL past its first step.  Losses
    within 1e-5 relative.  The params' worst difference is printed, not
    held: Adam's first step moves each param by about ``peak`` times the
    sign of its gradient, so a gradient within rounding of 0 may move
    another way on the mesh.  At ``--lr 1e-4``, which ``chip_smoke.py
    --launcher-cards`` trains whole qwen2-7b at, and at the launcher's
    default 3e-3."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.data.pipeline import DataConfig, Pipeline
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                               global_batch=8, seed=0))
    lr = {"name": "cosine", "peak": peak, "warmup_steps": 1,
          "total_steps": 8}
    out = ranks.run("train_steps", 4, tmp_path,
                    {"cfg": cfg, "params": 0, "mesh": (4, 1),
                     "batches": [pipe.batch(s) for s in range(3)],
                     "run": {"max_seq": 256, "remat": "full"}, "lr": lr,
                     "opt": "adamw", "plain": True},
                    timeout=900, device="cuda")
    for r in range(4):
        o = out[r]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(o["losses"], o["plain_losses"]))
        share = max(err / max(scale, 1e-30)
                    for err, scale in o["shares"].values())
        print(f"rank {r} lr {peak:g}: losses {o['losses']} against one "
              f"card's {o['plain_losses']}: worst relative {rel:.3e} "
              f"(bound 1e-5); params: worst difference {share:.3e} of its "
              f"leaf's largest magnitude (not held)")
        assert len(o["losses"]) == 3 and all(np.isfinite(o["losses"]))
        np.testing.assert_allclose(o["plain_losses"],
                                   out[0]["plain_losses"], rtol=1e-6)
        assert rel <= 1e-5


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_remat_recompute_in_another_thread_keeps_the_mesh(tmp_path, mesh):
    """A checkpointed group's recompute runs where the backward runs: for
    CUDA tensors on the autograd engine's device thread, where the mesh
    and implicit replication of ``axis_rules`` / ``replicate_plain``
    (thread-local) are not set.  ``sharding.in_context`` carries them
    there: the gradients of a backward run in another thread equal those
    of one run in the forward's thread (reduced qwen2-7b, remat full, on a
    gloo mesh)."""
    cfg = reduced(get_config("qwen2_7b"))
    rng = np.random.default_rng(5)
    t = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    out = ranks.run("thread_backward", 4, tmp_path,
                    {"cfg": cfg, "mesh": mesh,
                     "batch": {"tokens": t[:, :-1], "labels": t[:, 1:]}})
    for r in range(4):
        here, there = out[r]["here"], out[r]["thread"]
        assert not isinstance(there, str), there
        for a, b in zip(here, there):
            np.testing.assert_array_equal(a, b)


# ---- serving on a mesh ----------------------------------------------------

SERVE_ARCH = "qwen1.5-32b"     # reduced: 4 query and 4 KV heads, QKV bias


def _same_results(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_serve_engines_on_a_mesh_match_no_mesh(tmp_path, mesh):
    """Reduced qwen1.5-32b served on 4 gloo ranks under ``axis_rules`` of
    a (data, model) mesh, the engines given plain params (they place
    them): ``Engine.generate`` greedy gives the tokens of the same engine
    without a mesh, from logits within 1e-5 of their largest magnitude,
    captured and eager bit-equal; ``SerialSlotEngine`` and
    ``ContinuousEngine`` greedy, and ``ContinuousEngine`` at temperature
    0.8 over 8 requests, the streams of their runs without a mesh; every
    rank's the same.  The static cache's leaves are DTensors, each rank
    holding (B / data, Smax, KV / model, hd) of every layer's keys and
    values; the decode kernel's plain version receives plain tensors of
    each rank's rows and KV / model heads; one more decode step moves no
    piece of a weight over ``model`` (all-reduces of the row-parallel
    products and the logits' gather), and on (1, 4) none at all (on
    (2, 2) the ``fsdp`` halves are gathered over ``data``, as the
    reference's specs place them); and no rank's piece of a param keeps
    the whole param's storage alive (the vocab-sharded embedding table's
    rows were a view of the whole table)."""
    data, model = mesh
    cfg = reduced(get_config(SERVE_ARCH))
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 4) and cfg.qkv_bias
    m = Model(cfg, RunConfig(max_seq=24), device="cpu")
    case = ranks.serve_case(cfg)
    case.update(cfg=cfg, mesh=mesh,
                params=_numpy(m.init(torch.Generator().manual_seed(0))))
    out = ranks.run("serve_engines", 4, tmp_path, case, timeout=300)
    _served_as_without_a_mesh(out, case, cfg, mesh)
    # the engines' steps: B rows a data shard, 1 (serial), 3 slots
    # (continuous; 3 rows do not split over data, so every rank's)
    for o in out:
        assert {q[0] for _, q, _ in o["seen"]} == {
            case["prompts"].shape[0] // data, 1, 3}
        for dtensor, q, k in o["seen"]:
            assert not dtensor
            assert q[1] == k[1] == cfg.num_kv_heads // model, (q, k)
            assert k[2] == 24, k


def _served_as_without_a_mesh(out, case, cfg, mesh):
    """``serve_engines``' records on a (data, model) ``mesh``: tokens,
    logits and streams those of the engines without a mesh and of rank 0,
    captured bit-equal to eager, no piece of a param keeping a whole
    param alive, the static cache's leaves split by rows and KV heads,
    and one more decode step moving no piece of a weight over ``model``
    (on (1, 4) none at all)."""
    from repro_torch.models.layers import cache_depth
    data, model = mesh
    B, P = case["prompts"].shape
    hd = cfg.resolved_head_dim
    depth = cache_depth(case["max_len"])
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["tokens"], o["plain_tokens"])
        np.testing.assert_array_equal(o["tokens"], out[0]["tokens"])
        assert o["tokens"].shape == (B, P + case["steps"])
        assert o["err"] <= 1e-5 * o["scale"], (o["err"], o["scale"])
        assert o["eager_equal"]
        assert o["views"] == []
        for kind in ("serial", "continuous T0", "continuous T0.8"):
            _same_results(o[kind], o["plain " + kind])
            _same_results(o[kind], out[0][kind])
        assert len(o["cache"]) == 2
        for name, placements, local, whole in o["cache"]:
            assert whole == [cfg.num_layers, B, depth, cfg.num_kv_heads, hd]
            assert local == [cfg.num_layers, B // data, depth,
                             cfg.num_kv_heads // model, hd], (name, local)
            assert placements.startswith("("), placements
        kinds = {(kind, axis) for kind, axis, _, _ in o["calls"]}
        assert ("all_reduce", "model") in kinds, o["calls"]
        assert ("all_gather_into_tensor", "model") in kinds, o["calls"]
        assert [c for c in o["watched"] if c[1] != "data"] == []
        if data == 1:
            assert o["watched"] == [] and {a for _, a in kinds} == {"model"}


@pytest.mark.parametrize("skew,outside", [(("s", 0.01), False),
                                          (("steps", 1), False),
                                          (("s", 0.01), True)],
                         ids=["0.01s", "1steps", "0.01s-built-outside"])
def test_serve_continuous_ranks_agree_under_skewed_submissions(tmp_path, skew,
                                                               outside):
    """``ContinuousEngine`` on 4 gloo ranks of a (2, 2) mesh (reduced
    qwen1.5-32b, params drawn on the mesh), driven as ``serve_bench``
    drives it (arrival times, a queue limit of 2, a step a round), where
    the ranks see the arrivals at other times: rank r's wall clock started
    r x 10 ms late, or every other request reaching rank r r steps late.
    Rank 0's queue decides each step's admissions on every rank, and no
    rank stops stepping before the others: every rank completes the 10
    requests in the same number of steps, with the tokens of the engine
    run without a mesh, and counts each submitted once; within the run's
    timeout (a rank that prefilled while another decoded would make gloo
    fail or hang).  The ``built-outside`` case builds the engine before
    ``axis_rules`` from plain params, as ``serve_bench.run_config`` does:
    the first submissions reach it before its first step binds the
    mesh."""
    cfg = reduced(get_config(SERVE_ARCH))
    load = loadgen.LoadConfig(
        num_requests=10, vocab_size=cfg.vocab_size, seed=2, rate=20.0,
        prompt=loadgen.LengthDist("uniform", 3, 8),
        output=loadgen.LengthDist("uniform", 2, 6))
    stream = [(r.rid, np.asarray(r.prompt).tolist(), r.max_new, r.arrival)
              for r in loadgen.generate_stream(load)]
    out = ranks.run("serve_skewed", 4, tmp_path,
                    {"cfg": cfg, "params": 0, "mesh": (2, 2),
                     "stream": stream, "skew": skew, "max_len": 24,
                     "slots": 3, "queue_limit": 2, "outside": outside},
                    timeout=120)
    m = Model(cfg, RunConfig(max_seq=24), device="cpu")
    want = ContinuousEngine(m, m.init(torch.Generator().manual_seed(0)),
                            slots=3, max_len=24).serve(
        [Request(rid, np.asarray(p, np.int32), n)
         for rid, p, n, _ in stream])
    for o in out:
        assert o["completed"] == o["submitted"] == len(stream)
        assert o["steps"] == out[0]["steps"]
        _same_results(o["results"], want)


@pytest.mark.cuda
def test_serve_at_full_width_on_four_cards_matches_one_card(tmp_path):
    """qwen1.5-32b at full width cut to 2 layers (40 query and 40 KV
    heads, 10 a card) on a (1, 4) mesh of four NCCL ranks, a card each,
    through ``chip_smoke.py``'s serving part (a) (``serve_cut``): params
    of seed 0 drawn by ``Model.init(mesh=)``, ``Engine.generate`` greedy
    (4 prompts of 128 tokens, 32 new) replaying its captured decode step,
    the decode kernel launching once a layer a step on each card; its
    sampled logits bit-equal to the eager engine's on the mesh and within
    1e-5 of their largest magnitude of one card's without a mesh, its
    tokens one card's and every rank's the same (``serve_cut_report``)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out = ranks.run("serve_cut_part", 4, tmp_path, {"mesh": (1, 4)},
                    timeout=300, device="cuda")
    smoke = _smoke()
    smoke.serve_cut_report(f"[serve] {smoke.SERVE_ARCH} on (1, 4)", out)


@pytest.mark.cuda
def test_serve_engines_on_four_cards_match_one_card(tmp_path):
    """The CPU case's ``serve_engines`` body on four NCCL ranks of a
    (1, 4) mesh, a card each: qwen1.5-32b at full width cut to 2 layers,
    f32, params drawn whole on every card and placed by the engines (as
    the reference's ``serve_bench --mesh`` gives them); ``Engine`` (4
    prompts of 128 tokens, 32 new) captured, eager and under a collective
    count, ``SerialSlotEngine`` greedy and ``ContinuousEngine`` greedy
    and at temperature 0.8 over 8 requests: everything as the CPU case
    holds it, against each card's own run without a mesh; the decode
    kernel launching once a layer a step (replays of the captured step).
    Each rank collects its dropped engines before the group ends (a graph
    that captured a collective holds the communicator)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    smoke = _smoke()
    cfg = smoke.serve_cfg(2)
    case = ranks.serve_case(cfg, prompt=128)
    case.update(cfg=cfg, mesh=(1, 4), params=("plain", 0), steps=32,
                max_len=161)
    out = ranks.run("serve_engines", 4, tmp_path, case, timeout=300,
                    device="cuda")
    _served_as_without_a_mesh(out, case, cfg, (1, 4))
    for o in out:
        assert o["seen"] == []                # the kernel ran, not its plain
        assert o["launches"] == cfg.num_layers * case["steps"]
        assert o["replays"] == case["steps"] - 1
