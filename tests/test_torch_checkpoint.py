"""Checkpointing in the port: atomic commit, GC, resume, and checkpoints
that cross between the two packages (``tests/test_checkpoint.py``'s cases
on the port, plus cross-restores)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as jck
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import Model as JaxModel
from repro.models.model import RunConfig as JaxRunConfig
from repro.optim.optimizer import adamw as jax_adamw
from repro.train.step import init_state as jax_init_state
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim.optimizer import adamw, tree_leaves
from repro_torch.train.step import (TrainConfig, TrainState, init_state,
                                    make_train_step, state_shapes)
from repro_torch.train.trainer import Trainer, TrainerConfig


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(
        rng.standard_normal((4, 8)).astype(np.float32))},
        "b": torch.from_numpy(rng.integers(0, 10, (3,)).astype(np.int32)),
        "h": torch.from_numpy(rng.standard_normal((2, 3)).astype(
            np.float32)).to(torch.bfloat16)}


def test_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t, extra={"note": "x"})
    target = {"a": {"w": torch.zeros(4, 8)},
              "b": torch.zeros(3, dtype=torch.int32),
              "h": torch.zeros(2, 3, dtype=torch.bfloat16)}
    got, extra = ck.restore(str(tmp_path), target=target)
    for k in ("b", "h"):
        assert got[k].dtype == t[k].dtype
        assert torch.equal(got[k], t[k])
    assert torch.equal(got["a"]["w"], t["a"]["w"])
    assert got["a"]["w"] is target["a"]["w"]          # restored in place
    assert extra["step"] == 7 and extra["note"] == "x"


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t, keep=3)
    assert ck.latest_step(str(tmp_path)) == 5
    assert sorted(ck.all_steps(str(tmp_path))) == [3, 4, 5]


def test_shape_mismatch_rejected(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    bad = {"a": {"w": torch.zeros((5, 8))},
           "b": torch.zeros((3,), dtype=torch.int32),
           "h": torch.zeros((2, 3), dtype=torch.bfloat16)}
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), target=bad)
    with pytest.raises(KeyError):
        ck.restore(str(tmp_path), target={"c": torch.zeros(1)})


def test_tmp_dir_never_visible(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_elastic_restore_nested_dict(tmp_path):
    """Restore without a target rebuilds the nested structure, as tensors
    on the given device."""
    t = _tree()
    ck.save(str(tmp_path), 2, t)
    got, _ = ck.restore(str(tmp_path), device="cpu")
    assert set(got) == {"a", "b", "h"}
    assert torch.equal(got["a"]["w"], t["a"]["w"])
    assert torch.equal(got["h"], t["h"])


def _setup(wd=0.0):
    cfg = reduced(get_config("minicpm_2b"), layers=2, d_model=32, vocab=64)
    model = Model(cfg, RunConfig(max_seq=32), device="cpu")
    opt = adamw(lambda s: 1e-3, weight_decay=wd)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=1))
    return model, opt, pipe, make_train_step(model, opt, TrainConfig())


def test_resume_continues_identically(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint + restore into a fresh
    state + 3: identical."""
    model, opt, pipe, step = _setup()
    s_straight = init_state(model, opt, torch.Generator().manual_seed(0))
    for i in range(6):
        s_straight, _ = step(s_straight, pipe.torch_batch(i, "cpu"))

    s_a = init_state(model, opt, torch.Generator().manual_seed(0))
    for i in range(3):
        s_a, _ = step(s_a, pipe.torch_batch(i, "cpu"))
    ck.save(str(tmp_path), 3, s_a)
    fresh = init_state(model, opt, torch.Generator().manual_seed(9))
    s_b, extra = ck.restore(str(tmp_path), target=fresh)
    assert int(s_b.opt.step) == 3 and s_b.rng.tolist() == s_a.rng.tolist()
    for i in range(extra["step"], 6):
        s_b, _ = step(s_b, pipe.torch_batch(i, "cpu"))
    for l1, l2 in zip(tree_leaves(s_straight), tree_leaves(s_b)):
        assert torch.equal(l1, l2)


def test_trainer_auto_resume(tmp_path):
    model, opt, pipe, step = _setup(wd=0.1)
    logs = []
    tc = TrainerConfig(total_steps=4, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path), log_every=100)
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    trainer = Trainer(tc, step, pipe, log_fn=logs.append)
    trainer.run(state)
    assert ck.latest_step(str(tmp_path)) == 4
    assert len(trainer.metrics_history) == 4
    assert any("checkpointed step 2" in line for line in logs)
    # a second run resumes at 4 and does nothing more
    logs2 = []
    t2 = Trainer(tc, step, pipe, log_fn=logs2.append)
    t2.run(init_state(model, opt, torch.Generator().manual_seed(0)))
    assert any("resumed from step 4" in line for line in logs2)
    assert t2.metrics_history == []


def _jax_state():
    cfg = jax_reduced(jax_get_config("minicpm_2b"), layers=2, d_model=32,
                      vocab=64)
    jm = JaxModel(cfg, JaxRunConfig(max_seq=32))
    jo = jax_adamw(lambda s: 1e-3, factored=True)
    js = jax_init_state(jm, jo, jax.random.PRNGKey(0))
    # moments that are not zeros, so that a swapped leaf would show
    js = js._replace(opt=js.opt._replace(
        step=jnp.int32(5),
        m=jax.tree.map(lambda x: x + 0.5, js.opt.m),
        v=jax.tree.map(lambda x: x + 0.25, js.opt.v)))
    model = Model(reduced(get_config("minicpm_2b"), layers=2, d_model=32,
                          vocab=64), RunConfig(max_seq=32), device="cpu")
    return js, model, adamw(lambda s: 1e-3, factored=True)


def _same(js, state):
    want = jax.tree.leaves(js)
    got = tree_leaves(state)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A TrainState saved by the reference restores into the port's
    (params, factored opt, step and rng equal), by the same keys."""
    js, model, opt = _jax_state()
    jck.save(str(tmp_path), 5, js)
    target = init_state(model, opt, torch.Generator().manual_seed(3))
    got, extra = ck.restore(str(tmp_path), target=target)
    assert extra["step"] == 5
    assert isinstance(got, TrainState)
    _same(js, got)
    assert got.rng.dtype == torch.uint32 and int(got.opt.step) == 5
    # into meta-tensor shapes, made on the device
    made, _ = ck.restore(str(tmp_path), target=state_shapes(model, opt),
                         device="cpu")
    _same(js, made)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    js, model, opt = _jax_state()
    state = init_state(model, opt, torch.Generator().manual_seed(3))
    ck.save(str(tmp_path), 2, state)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        keys = set(__import__("json").load(f)["index"])
    assert {"params/scan/pos0/attn/wq", "opt/step", "rng",
            "opt/v/embed/row", "opt/m/embed"} <= keys
    got, _ = jck.restore(str(tmp_path), target=js)
    _same(got, state)


def _flat_keys(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_keys(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def test_four_rank_checkpoint_reaches_the_reference_through_one_process(
        tmp_path):
    """A checkpoint of four gloo ranks on a (2, 2) mesh (each rank its
    own pieces), restored whole in one process without a group and saved
    again, is the reference's one-file format: the reference's
    ``checkpointer.restore`` reads it, every leaf equal to the state the
    ranks saved."""
    import _torch_dist_ranks as ranks
    out = ranks.run("ckpt_sharded", 4, tmp_path, {
        "cfg": reduced(get_config("qwen2-7b")),
        "dir": str(tmp_path / "ck"), "onto": []})
    with open(tmp_path / "ck" / "step_00000001" / "manifest.json") as f:
        assert all("pieces" in m for m in json.load(f)["index"].values())
    whole, extra = ck.restore(str(tmp_path / "ck"))
    ck.save(str(tmp_path / "one"), extra["step"], whole)
    assert sorted(os.listdir(tmp_path / "one" / "step_00000001")) == \
        ["arrays.npz", "manifest.json"]
    tree, jextra = jck.restore(str(tmp_path / "one"))
    assert jextra["step"] == 1
    got, want = _flat_keys(tree), out[0]["saved"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
