"""The training stack against the JAX package, on the CPU.

Params are initialised by the reference and carried over with
``repro_torch.convert``; batches are numpy-seeded.  The loss and every
gradient leaf are held to ``jax.value_and_grad`` of the reference's
``Model.loss`` for every registry config, reduced; the optimizers, the
schedules, the data pipeline and short loss curves to the reference's
own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs.base import ARCHS as JAX_ARCHS
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import layers as JL
from repro.models import model as jax_model
from repro.optim import optimizer as jopt
from repro.optim import schedule as jsched
from repro.train import step as jstep
from repro_torch.configs.base import ARCHS, get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as L
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import optimizer as opt_mod
from repro_torch.optim import schedule as sched
from repro_torch.train import step as step_mod

LOSS_RTOL = 1e-5      # the loss, relative
GRAD_TOL = 1e-4       # each gradient leaf, absolute
OPT_TOL = 1e-6        # optimizer states and params after 3 updates
CURVE_RTOL = 1e-4     # a short loss curve from shared params


def _pair(arch, seed=1, **run):
    """(jax model, jax params, port model, port params), reduced, f32."""
    jm = jax_model.Model(jax_reduced(jax_get_config(arch)),
                         jax_model.RunConfig(max_seq=64, **run))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(reduced(get_config(arch)), RunConfig(max_seq=64, **run),
              device="cpu")
    return jm, jp, m, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B=2, S=12, seed=4, holes=True):
    """Tokens, labels, a mask with holes, and the stub frontend's input."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = ((rng.random((B, S)) > 0.2) if holes else
            np.ones((B, S), bool)).astype(np.float32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.encoder is not None:
        out["extra_embeds"] = rng.standard_normal(
            (B, cfg.encoder.context, cfg.encoder.d_model)).astype(np.float32)
    elif cfg.frontend:
        out["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _grads(m, p, batch):
    leaves = opt_mod.tree_leaves(p)
    for x in leaves:
        x.requires_grad_(True)
    loss, metrics = m.loss(p, batch)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    """Model.loss (masked mean NLL plus the MoE aux loss) within 1e-5
    relative and every gradient leaf within 1e-4 of the reference's
    ``jax.value_and_grad``, leaves in the reference's order."""
    jm, jp, m, p = _pair(arch)
    batch = _batch(m.cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, _jax(batch))
    loss, met, grads = _grads(m, p, _torch(batch))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=GRAD_TOL)


def test_stacked_params_unbind_once_under_autograd():
    """Each stacked leaf is unbound once: under autograd into one stacked
    gradient, and with grad or without into views of the stack."""
    m = Model(reduced(get_config("minicpm_2b")), device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    w = p["scan"]["pos0"]["attn"]["wq"].requires_grad_(True)
    layers = T._unstack(p["scan"]["pos0"], m.cfg.num_layers)
    assert [x["attn"]["wq"].grad_fn.name() for x in layers] == [
        "UnbindBackward0"] * m.cfg.num_layers
    assert layers[1]["attn"]["wq"].data_ptr() == w[1].data_ptr()
    with torch.no_grad():
        views = T._unstack(p["scan"]["pos0"], m.cfg.num_layers)
    assert views[1]["attn"]["wq"].data_ptr() == w[1].data_ptr()


def _opt_params(seed=0):
    """A param tree with factorable (rank >= 2, last two axes >= 8) and
    unfactorable leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (16, 12), "s": (3, 16, 8)}, "b": (5,),
              "c": (4, 9)}

    def draw(s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32)
    return jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))


OPTIMIZERS = {
    "adamw": lambda lr, f: f.adamw(lr, weight_decay=0.1),
    "adamw_factored": lambda lr, f: f.adamw(lr, weight_decay=0.01,
                                            factored=True),
    "adamw_noclip": lambda lr, f: f.adamw(lr, clip_norm=None),
    "sgd": lambda lr, f: f.sgd(lr, momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    """Three updates from the same params and gradients: params, moments
    and step within 1e-6 of the reference's."""
    jlr = jsched.make("cosine", peak=1e-2, warmup_steps=1, total_steps=5)
    lr = sched.make("cosine", peak=1e-2, warmup_steps=1, total_steps=5)
    jo, o = OPTIMIZERS[name](jlr, jopt), OPTIMIZERS[name](lr, opt_mod)
    host = _opt_params()
    jp = jax.tree.map(jnp.asarray, host)
    p = to_torch(host, "cpu")
    js, s = jo.init(jp), o.init(p)
    for i in range(3):
        g = _opt_params(10 + i)
        jp, js, jmet = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, s, met = o.update(to_torch(g, "cpu"), s, p)
        for k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-6)
    assert int(s.step) == int(js.step) == 3
    for want, got in ((jp, p), (js.m, s.m), (js.v, s.v)):
        wl = jax.tree.leaves(want)
        gl = opt_mod.tree_leaves(got)
        assert len(wl) == len(gl)
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_clip_and_global_norm_match_jax():
    host = _opt_params(3)
    jt, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, host), 1.0)
    t, n = opt_mod.clip_by_global_norm(to_torch(host, "cpu"), 1.0)
    np.testing.assert_allclose(n.item(), float(jn), rtol=1e-6)
    for a, b in zip(opt_mod.tree_leaves(t), jax.tree.leaves(jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert opt_mod._is_factorable((8, 8)) and not opt_mod._is_factorable(
        (7, 8)) and not opt_mod._is_factorable((64,))


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_equal_jax(name):
    """Every step of a 100-step schedule (warmup 5), from Python ints and
    from int32 tensors, equals the reference's f32 rate."""
    kw = dict(peak=3e-3, warmup_steps=5, total_steps=100)
    jf, f = jsched.make(name, **kw), sched.make(name, **kw)
    for s in list(range(0, 12)) + [50, 88, 89, 90, 91, 99, 100, 150]:
        want = np.asarray(jf(jnp.int32(s)))
        assert f(s).item() == want
        assert f(torch.tensor(s, dtype=torch.int32)).item() == want
    assert sched.linear_warmup(2, 4, 1.0).item() == float(
        jsched.linear_warmup(2, 4, 1.0))


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_pipeline_batches_byte_equal(tmp_path, source):
    path = None
    if source == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 1 << 20, 5000).astype(
            np.int32).tofile(path)
    kw = dict(vocab_size=977, seq_len=33, global_batch=6, seed=3,
              source=source, memmap_path=path, num_shards=2, shard_id=1)
    jp, p = JaxPipeline(JaxDataConfig(**kw)), Pipeline(DataConfig(**kw))
    for step in (0, 1, 7):
        want, got = jp.batch(step), p.batch(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            assert want[k].tobytes() == got[k].tobytes()
        tb = p.torch_batch(step, "cpu")
        assert tb["tokens"].dtype == torch.int32
        assert tb["labels"].numpy().tobytes() == want["labels"].tobytes()


def _curve(arch, steps=3, microbatches=1, remat="none"):
    """The losses of ``steps`` AdamW steps from shared params and
    batches, in both packages (the reference's step jitted)."""
    jm, jp, m, p = _pair(arch, remat=remat)
    kw = dict(peak=3e-3, warmup_steps=1, total_steps=steps)
    jo = jopt.adamw(jsched.make("wsd", **kw), weight_decay=0.01)
    o = opt_mod.adamw(sched.make("wsd", **kw), weight_decay=0.01)
    tc = dict(microbatches=microbatches)
    jfn = jax.jit(jstep.make_train_step(jm, jo, jstep.TrainConfig(**tc)))
    fn = step_mod.make_train_step(m, o, step_mod.TrainConfig(**tc))
    js = jstep.TrainState(jp, jo.init(jp), jax.random.PRNGKey(0))
    s = step_mod.TrainState(p, o.init(p), step_mod.new_rng(0, 1))
    want, got = [], []
    for i in range(steps):
        batch = _batch(m.cfg, B=4, S=10, seed=20 + i, holes=False)
        js, jmet = jfn(js, _jax(batch))
        s, met = fn(s, _torch(batch))
        want.append(float(jmet["loss"]))
        got.append(met["loss"].item())
    return want, got, js, s


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_v2_236b",
                                  "whisper_base"])
def test_loss_curve_matches_jax(arch):
    want, got, js, s = _curve(arch)
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    assert int(s.opt.step) == 3 and s.rng.tolist() == [0, 4]


def test_microbatches_match_jax_and_full_batch():
    """microbatches=2: the reference's losses, and the full batch's loss
    and gradients within 1e-5 relative."""
    want, got, _, _ = _curve("minicpm_2b", steps=2, microbatches=2)
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    _, _, m, p = _pair("minicpm_2b")
    batch = _torch(_batch(m.cfg, B=4, S=10, holes=False))
    runs = []
    for n in (1, 2):
        seen = {}

        def update(grads, state, params):
            seen["g"] = opt_mod.tree_leaves(grads)
            return params, state, {}
        rec = opt_mod.Optimizer(init=lambda q: opt_mod.OptState(
            torch.zeros((), dtype=torch.int32), {}, ()), update=update)
        fn = step_mod.make_train_step(m, rec, step_mod.TrainConfig(n))
        _, met = fn(step_mod.TrainState(p, rec.init(p), step_mod.new_rng(0, 1)),
                    batch)
        runs.append((met["loss"].item(), seen["g"]))
    (l1, g1), (l2, g2) = runs
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    for a, b in zip(g1, g2):
        scale = max(a.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_v2_236b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_variants_agree(arch, remat):
    """remat checkpoints each stacked group (recomputing an MoE layer must
    route as before): loss and gradients within 1e-6 of no remat."""
    _, _, m, p = _pair(arch)
    mr = Model(m.cfg, RunConfig(max_seq=64, remat=remat), device="cpu")
    batch = _torch(_batch(m.cfg))
    l0, _, g0 = _grads(m, p, batch)
    l1, _, g1 = _grads(mr, p, batch)
    assert abs(l0.item() - l1.item()) <= 1e-6 * abs(l0.item())
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        Model(m.cfg, RunConfig(remat="some"), device="cpu").loss(p, batch)


def test_remat_dots_saves_the_plain_products():
    """"dots" keeps aten.mm / addmm (the reference's
    dots_with_no_batch_dims_saveable) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    assert T._dots_policy(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert T._dots_policy(None, torch.ops.aten.bmm.default) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert T._dots_policy(None, torch.ops.aten.exp.default) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_set_attention_options_as_the_reference():
    """The blockwise path with bf16 probabilities and smaller blocks
    against the reference's under the same options."""
    saved, jsaved = dict(L.ATTN_OPTIONS), dict(JL.ATTN_OPTIONS)
    try:
        for mod in (L, JL):
            mod.set_attention_options(probs_dtype="bf16", block_q=256,
                                      block_k=512)
        assert L.ATTN_OPTIONS == {"probs_dtype": torch.bfloat16,
                                  "block_q": 256, "block_k": 512}
        rng = np.random.default_rng(0)
        B, S, H, KV, hd = 1, 2048, 2, 1, 8
        q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
                   for n in (H, KV, KV))
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        want = JL.attention_core(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(pos), None, True, None)
        args = [torch.from_numpy(x) for x in (q, k, v, pos, pos)]
        got = L.attention_core(*args, None, True, None)
        # a probability whose two f32 computations round to neighbouring
        # bf16 values moves an output by one bf16 step of that term
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=5e-4)
        L.set_attention_options(probs_dtype="float32")
        assert L.ATTN_OPTIONS["probs_dtype"] == torch.float32
        f32 = L.attention_core(*args, None, True, None)
        assert (f32 - got).abs().max().item() > 1e-3
    finally:
        L.ATTN_OPTIONS.update(saved)
        JL.ATTN_OPTIONS.update(jsaved)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_input_specs_and_cell_applicable_as_the_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert model_mod.SHAPES == jax_model.SHAPES
    for shape in jax_model.SHAPES:
        assert model_mod.cell_applicable(cfg, shape) == \
            jax_model.cell_applicable(jcfg, shape)
        want = jax_model.input_specs(jcfg, shape)
        got = model_mod.input_specs(cfg, shape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name


def test_state_shapes_allocate_nothing_and_refusals_name_a11():
    """Once refusals naming A11, now what the reference does:
    ``state_axes`` equals the reference's, a ``grad_compress=True`` step
    equals one without (the reference's make_train_step never reads it),
    and ``--mesh host`` trains on a (1, 1) mesh with the losses of the
    run without one."""
    cfg = get_config("minicpm_2b")
    o = opt_mod.adamw(lambda s: 1e-3, factored=True)
    st = step_mod.state_shapes(Model(cfg), o)
    assert st.rng.shape == (2,) and st.rng.dtype == torch.uint32
    leaves = opt_mod.tree_leaves(st.params)
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) == 2_725_173_504
    assert st.opt.v["embed"]["row"].shape == (cfg.padded_vocab,)
    jo = jopt.adamw(lambda s: 1e-3, factored=True)
    want = jstep.state_axes(jax_model.Model(jax_get_config("minicpm_2b")), jo)
    got = step_mod.state_axes(Model(cfg), o)
    assert got.rng == want.rng and got.opt.step == want.opt.step
    assert got.params == want.params
    assert got.opt.m == want.opt.m and got.opt.v == want.opt.v

    m = Model(reduced(cfg), RunConfig(max_seq=16), device="cpu")
    so = opt_mod.adamw(lambda s: torch.tensor(1e-3))
    batch = _torch(_batch(m.cfg, B=2, S=8))
    runs = []
    for compress in (False, True):
        state = step_mod.init_state(m, so, torch.Generator().manual_seed(0))
        fn = step_mod.make_train_step(
            m, so, step_mod.TrainConfig(grad_compress=compress))
        state, met = fn(state, batch)
        runs.append((met["loss"].item(), opt_mod.tree_leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    argv = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--global-batch", "2"]
    plain = train_launcher.main(argv)
    try:
        meshed = train_launcher.main(argv + ["--mesh", "host"])
    finally:
        # the 1-rank gloo group the launcher started
        torch.distributed.destroy_process_group()
    assert meshed["mesh"].shape == (1, 1)
    assert [h["loss"] for h in meshed["trainer"].metrics_history] == \
        [h["loss"] for h in plain["trainer"].metrics_history]
    assert opt_mod.tree_leaves(meshed["state"].params)[0].placements


def test_train_launcher_runs_reduced_on_cpu(capsys, tmp_path):
    res = train_launcher.main([
        "--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--steps",
        "12", "--seq-len", "32", "--global-batch", "4", "--remat", "full",
        "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "6"])
    losses = [h["loss"] for h in res["trainer"].metrics_history]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert res["model"].run.remat == "full"
    out = capsys.readouterr().out
    assert "[train] arch=minicpm-2b" in out and "loss first->last" in out
    assert "[train] losses: " + " ".join(map(repr, losses)) in out
    assert sorted(int(d[5:]) for d in __import__("os").listdir(tmp_path)) \
        == [6, 12]
