"""The distribution layer against the JAX package, on the CPU.

Logical-axis resolution (``pspec_for``, ``state_axes``, per-device state
bytes) is held to the reference's exactly for every registry config on
both production mesh shapes.  Collective bodies run in 2-4 gloo ranks
(``_torch_dist_ranks``) against the reference's own bodies under a named
``jax.vmap`` over the rank axis, which runs its ``psum`` / ``pmax`` /
``axis_index`` on one CPU device.  Training on a (2, 2) mesh is held to
the reference's single-device run and to the port's own run without a
mesh; the sharded GEMM, the elastic restore, the failover state machine
and the no-mesh behaviour of the mesh options likewise.
"""

import dataclasses
import functools

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
from repro.distributed import compression as JC
from repro.distributed import fault_tolerance as JF
from repro.distributed import sharding as JS
from repro.models import layers as JL
from repro.models.layers import Maker as JMaker
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.optim import optimizer as jopt
from repro.serve import continuous as jax_continuous
from repro.serve import engine as jax_engine
from repro.train import step as jstep
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed import compression as C
from repro_torch.distributed import fault_tolerance as F
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.model import Model, RunConfig
from repro_torch.optim import optimizer as opt_mod
from repro_torch.train import step as step_mod

import _torch_dist_ranks as ranks

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _Sizes:
    """The reference's pspec_for reads only ``.shape`` of a mesh."""

    def __init__(self, shape):
        self.shape = shape


def _flat(tree, prefix=()):
    """{path: leaf} of dicts and (Named)tuples, the structure both
    packages' state trees share."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, str):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flat(x, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _jax_state(arch):
    cfg = jax_get_config(arch)
    model = jax_model.Model(cfg, jax_model.RunConfig(param_dtype="bfloat16",
                                                     max_seq=4096))
    opt = jopt.adamw(lambda s: 1e-4, factored=cfg.param_count() > 5e10,
                     state_dtype=jnp.bfloat16)
    return jstep.state_axes(model, opt), jstep.state_shapes(model, opt)


def _port_state(arch):
    cfg = get_config(arch)
    model = Model(cfg, RunConfig(param_dtype="bfloat16", max_seq=4096),
                  device="meta")
    opt = opt_mod.adamw(lambda s: 1e-4, factored=cfg.param_count() > 5e10,
                        state_dtype=torch.bfloat16)
    return step_mod.state_axes(model, opt), step_mod.state_shapes(model, opt)


def _shards(spec, sizes):
    n = 1
    for entry in spec:
        for a in S.spec_axes(entry):
            n *= sizes[a]
    return n


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_state_axes_pspecs_and_bytes_equal_the_reference(arch):
    """``state_axes`` leaf for leaf, each leaf's partition spec on both
    production meshes, and the per-device state bytes integer for
    integer (the dry run's ``state_bytes`` for the bf16 train state)."""
    jaxes, jshapes = _jax_state(arch)
    axes, shapes = _port_state(arch)
    ja, pa = _flat(jaxes), _flat(axes)
    assert ja == pa
    js, ps = _flat(jshapes), _flat(shapes)
    assert sorted(js) == sorted(ps)
    for name, sizes in MESHES.items():
        jbytes = pbytes = 0
        for key, ax in pa.items():
            want = tuple(JS.pspec_for(JS.parse_axes(ja[key]),
                                      js[key].shape, _Sizes(sizes)))
            got = S.pspec_for(S.parse_axes(ax), tuple(ps[key].shape), sizes)
            assert got == want, (name, key, got, want)
            assert tuple(ps[key].shape) == tuple(js[key].shape)
            n = int(np.prod(js[key].shape)) if js[key].shape else 1
            jbytes += n * js[key].dtype.itemsize // _shards(want, sizes)
            pbytes += ps[key].numel() * ps[key].element_size() // \
                _shards(got, sizes)
        assert pbytes == jbytes
        if arch == "kimi_k2_1t":
            assert dryrun.state_bytes(arch, name != "16x16") == jbytes


def test_kimi_state_bytes_need_two_pods():
    """The reference's scale finding, on the port's arithmetic."""
    one, two = (dryrun.state_bytes("kimi-k2-1t", mp) for mp in (False, True))
    assert 15e9 < one < 17.5e9 and two < 10e9


@pytest.mark.parametrize("arch", ["qwen2_7b", "whisper_base",
                                  "deepseek_v2_236b", "mamba2_130m"])
def test_cache_axes_equal_the_reference(arch):
    """``cache_axes`` mirrors the port's cache tree leaf for leaf, and
    equals the reference's where the trees agree (``len`` and
    ``enc_done`` are host ints in the port, ``""`` in both axes
    trees)."""
    jm = jax_model.Model(jax_get_config(arch))
    m = Model(get_config(arch), device="meta")
    want = _flat(jm.cache_axes(4, 64))
    got = _flat(m.cache_axes(4, 64))
    assert got == want
    shapes = _flat(m.cache_shapes(4, 64))
    assert sorted(shapes) == sorted(got)


def test_resolver_fallbacks_and_shard_identity():
    sizes = {"data": 16, "model": 16}
    # 28 heads do not divide a 16-way model axis: replicated
    assert S.pspec_for(("batch", None, "heads", None),
                       (256, 10, 28, 128), sizes) == ("data",)
    # the greedy prefix drops "data" when pod x data does not divide
    assert S.pspec_for(("fsdp",), (2 * 8,), {"pod": 2, "data": 16}) == \
        ("pod",)
    assert S.parse_axes("fsdp - ff") == ("fsdp", None, "ff")
    with pytest.raises(ValueError):
        S.sharding_for("fsdp ff", (4,), sizes)
    x = torch.ones(3, 4)
    assert S.shard(x, "batch", None) is x            # no mesh active
    with S.axis_rules({"data": 2}):
        assert S.current_mesh() == {"data": 2}
        assert S.shard(x, "batch", None) is x        # a plain tensor
    assert S.current_mesh() is None


def test_maker_axes_and_param_axes_equal_the_reference():
    for arch in ("qwen2_7b", "deepseek_v2_236b", "recurrentgemma_2b"):
        jm = jax_model.Model(jax_get_config(arch))
        assert _flat(Model(get_config(arch), device="meta").param_axes()) \
            == _flat(jm.param_axes())


# --------------------------------------------------------------------------
# collective bodies
# --------------------------------------------------------------------------


def test_compressed_psum_mean_matches_reference_under_vmap(tmp_path):
    """4 gloo ranks against the reference's body under a named vmap: the
    whole group, and ``make_compressed_allreduce`` over ``data`` of a
    (2, 2) mesh (ranks {0, 2} and {1, 3}); within 1e-6."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 33)) *
         np.array([[1.0], [3.0], [0.1], [10.0]])).astype(np.float32)
    tree = {"a": rng.standard_normal((4, 5, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 7)).astype(np.float32)}}
    out = ranks.run("compressed", 4, tmp_path, {"x": x, "tree": tree})
    want = np.asarray(jax.vmap(functools.partial(
        JC.compressed_psum_mean, axis_name="i"), axis_name="i")(
            jnp.asarray(x)))
    for r in range(4):
        np.testing.assert_allclose(out[r]["whole"], want[r], rtol=1e-6,
                                   atol=1e-6)
    # data groups of a (2, 2) mesh: ranks r and r + 2
    for key, arr in (("a", tree["a"]), ("b/c", tree["b"]["c"])):
        for r in range(4):
            pair = arr[[r % 2, r % 2 + 2]]
            w = np.asarray(jax.vmap(functools.partial(
                JC.compressed_psum_mean, axis_name="i"), axis_name="i")(
                    jnp.asarray(pair)))[0]
            got = out[r]["tree"]["a"] if key == "a" else \
                out[r]["tree"]["b"]["c"]
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


def test_compressed_mean_is_the_reference_caveat():
    """Each rank's payload at its own scale, summed, times the largest
    scale over n: not the true mean when the scales differ.  On the 4-rank
    input of the test above (scales 1, 3, 0.1, 10) the reference's result
    is 8.55 off a true mean whose largest magnitude is 4.97; the port
    gives the reference's result (the test above), caveat included."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 33)) *
         np.array([[1.0], [3.0], [0.1], [10.0]])).astype(np.float32)
    got = np.asarray(jax.vmap(functools.partial(
        JC.compressed_psum_mean, axis_name="i"), axis_name="i")(
            jnp.asarray(x)))[0]
    err = np.abs(got - x.mean(0)).max()
    assert 8.5 < err < 8.6 and np.abs(x.mean(0)).max() < 5
    # the port's arithmetic on the same payloads and scales
    q = [C.quantize_int8(torch.from_numpy(r)) for r in x]
    port = (sum(qi.to(torch.int32) for qi, _ in q).float()
            * max(s for _, s in q) / 4)
    np.testing.assert_allclose(port.numpy(), got, rtol=1e-6, atol=1e-6)


def test_quantize_and_error_feedback_equal_the_reference():
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    r = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 1e-2,
         "b": {"c": np.zeros(7, np.float32)}}
    jq, js = JC.quantize_int8(jnp.asarray(g["w"]))
    q, s = C.quantize_int8(torch.from_numpy(g["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    jg, jr = JC.error_feedback_update(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, r))
    tg, tr = C.error_feedback_update(to_torch(g, "cpu"), to_torch(r, "cpu"))
    for a, b in ((_flat(tg), _flat(jg)), (_flat(tr), _flat(jr))):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-6, atol=1e-7)


def _moe_cfg(cap=8.0):
    """Reduced deepseek-v2 with a capacity factor at which neither path
    drops a token."""
    def one(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cap, num_experts=8))
    return (one(jax_reduced(jax_get_config("deepseek_v2_236b"))),
            one(reduced(get_config("deepseek_v2_236b"))))


def _moe_params(jcfg, seed=2):
    jp = jax_moe.init_moe(jcfg, JMaker("init", jax.random.PRNGKey(seed)))
    return {k: np.asarray(v) for k, v in jp.items()}


def test_local_expert_ffn_matches_reference_under_vmap():
    """Each model rank's partial output, summed, against the reference's
    body under a named vmap over 4 model ranks (its psum), within 1e-5."""
    jcfg, cfg = _moe_cfg()
    p = _moe_params(jcfg)
    rng = np.random.default_rng(5)
    T, d = 12, jcfg.d_model
    h = rng.standard_normal((T, d)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(h) @ p["router"], -1)
    top_vals, top_idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    gates = top_vals / top_vals.sum(-1, keepdims=True)
    G, E = 4, jcfg.moe.num_experts
    cap = T

    def split(w):
        return w.reshape((G, E // G) + w.shape[1:])
    body = functools.partial(
        jax_moe._local_expert_ffn, n_experts=E, top_k=jcfg.moe.top_k,
        capacity=cap, act=jax.nn.silu, gated=True, axis="model")
    want = np.asarray(jax.vmap(body, in_axes=(None, None, None, 0, 0, 0),
                               axis_name="model")(
        jnp.asarray(h), top_idx, gates, split(p["w_gate"]),
        split(p["w_up"]), split(p["w_down"])))[0]
    got = sum(moe._local_expert_ffn(
        torch.from_numpy(h), torch.from_numpy(np.asarray(top_idx)),
        torch.from_numpy(np.asarray(gates)),
        *(torch.from_numpy(split(p[k])[r].copy())
          for k in ("w_gate", "w_up", "w_down")),
        rank=r, top_k=jcfg.moe.top_k, capacity=cap,
        act=torch.nn.functional.silu, gated=True) for r in range(G))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,data", [("shardmap", 1), ("shardmap", 2),
                                       ("gspmd", 2)])
def test_moe_on_a_mesh_matches_reference(tmp_path, impl, data):
    """apply_moe on DTensors over 4 gloo ranks, (1, 4) or (2, 2): the
    expert-parallel path (local_map, Partial over model) and the
    replicated dispatch against the reference's single-device layer,
    output, aux loss and the gradients of the input and every param,
    within 1e-5."""
    jcfg, cfg = _moe_cfg()
    p = _moe_params(jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, jcfg.d_model)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    out = ranks.run("shardmap_moe", 4, tmp_path,
                    {"cfg": cfg, "params": p, "x": x, "wy": wy, "impl": impl,
                     "data": data})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, aux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)

    def f(xx, pp):
        y, a = jax_moe.apply_moe(pp, xx, jcfg)
        return (y * wy).sum() + a
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jp)
    jgrads = dict(gp, x=gx)
    for r in range(4):
        assert out[r]["shardmap"] == (impl == "shardmap")
        np.testing.assert_allclose(out[r]["y"], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[r]["aux"], float(aux), rtol=1e-5)
        assert sorted(out[r]["grads"]) == sorted(jgrads)
        for k, g in jgrads.items():
            np.testing.assert_allclose(out[r]["grads"][k], np.asarray(g),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def _jax_moe_per_shard(pp, xx, jcfg, shards, ranks_):
    """The reference's layer as the expert-parallel path computes it on a
    (``shards``, ``ranks_``) mesh: the routing and the aux loss of the
    whole batch, then each data shard's rows through the reference's
    ``_local_expert_ffn`` under a named vmap over ``ranks_`` model ranks
    (its psum), at the capacity of that shard's tokens."""
    m = jcfg.moe
    B, S, d = xx.shape
    T, E, K = B * S, m.num_experts, m.top_k
    h = JL.rmsnorm(xx, pp["norm"], jcfg.norm_eps).reshape(T, d)
    probs = jax.nn.softmax((h @ pp["router"]).astype(jnp.float32), -1)
    top_vals, top_idx = jax.lax.top_k(probs, K)
    gates = top_vals / jnp.maximum(top_vals.sum(-1, keepdims=True), 1e-9)
    frac = jnp.zeros((E,), jnp.float32).at[top_idx.reshape(-1)].add(
        1.0) / (T * K)
    aux = E * jnp.sum(frac * probs.mean(0)) * m.router_aux_weight
    T_loc = T // shards
    cap = max(1, min(int(np.ceil(T_loc * K * m.capacity_factor / E)), T_loc))

    def split(w):
        return w.reshape((ranks_, E // ranks_) + w.shape[1:])
    body = functools.partial(
        jax_moe._local_expert_ffn, n_experts=E, top_k=K, capacity=cap,
        act=jax.nn.silu, gated=True, axis="model")
    ys = []
    for r in range(shards):
        rows = slice(r * T_loc, (r + 1) * T_loc)
        ys.append(jax.vmap(body, in_axes=(None, None, None, 0, 0, 0),
                           axis_name="model")(
            h[rows], top_idx[rows], gates[rows].astype(jnp.float32),
            split(pp["w_gate"]), split(pp["w_up"]), split(pp["w_down"]))[0])
    y = jnp.concatenate(ys)
    y = y + (jax.nn.silu(h @ pp["shared_gate"]) * (h @ pp["shared_up"])
             ) @ pp["shared_down"]
    return xx + y.reshape(B, S, d), aux


def _drops(top_idx, E, cf, shards):
    """The (token, expert) pairs dropped when each of ``shards`` row
    blocks fills its own C = min(T_loc, ceil(T_loc * K * cf / E)) slots
    per expert."""
    top_idx = np.asarray(top_idx)
    T, K = top_idx.shape
    T_loc = T // shards
    cap = max(1, min(int(np.ceil(T_loc * K * cf / E)), T_loc))
    return sum(int(np.maximum(np.bincount(
        top_idx[r * T_loc:(r + 1) * T_loc].reshape(-1), minlength=E) - cap,
        0).sum()) for r in range(shards))


@pytest.mark.parametrize("impl,data", [("shardmap", 1), ("shardmap", 2),
                                       ("gspmd", 1), ("gspmd", 2)])
def test_moe_dropping_tokens_on_a_mesh_matches_reference(tmp_path, impl,
                                                         data):
    """apply_moe on DTensors over 4 gloo ranks, (1, 4) or (2, 2), at a
    capacity factor of 0.5 (8 experts, top-2, 24 tokens), where tokens
    drop: the expert-parallel path (each data shard's capacity from its
    own tokens, the reference's arithmetic) and the dense path (every
    expert's slots from the whole batch, its experts kept sharded) against
    the reference: ``jax_moe.apply_moe`` for the dense path and for (1, 4),
    where one data shard holds every token; for the expert-parallel path
    on (2, 2), the reference's ``_local_expert_ffn`` under a named vmap
    over the 2 model ranks, once for each data shard at that shard's
    capacity, with the aux loss of the whole batch.  Output, aux loss and
    the gradients of the input and every param within 1e-5, with dropped
    pairs asserted."""
    jcfg, cfg = _moe_cfg(cap=0.5)
    p = _moe_params(jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, jcfg.d_model)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    out = ranks.run("shardmap_moe", 4, tmp_path,
                    {"cfg": cfg, "params": p, "x": x, "wy": wy, "impl": impl,
                     "data": data})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    m = jcfg.moe
    shards = data if impl == "shardmap" else 1

    def f(xx, pp):
        if shards == 1:
            return jax_moe.apply_moe(pp, xx, jcfg)
        return _jax_moe_per_shard(pp, xx, jcfg, shards, 4 // data)

    def loss(xx, pp):
        y, a = f(xx, pp)
        return (y * wy).sum() + a
    want, aux = f(jnp.asarray(x), jp)
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    jgrads = dict(gp, x=gx)
    h = JL.rmsnorm(jnp.asarray(x), jp["norm"], jcfg.norm_eps).reshape(
        -1, jcfg.d_model)
    _, top_idx = jax.lax.top_k(jax.nn.softmax(
        (h @ jp["router"]).astype(jnp.float32), -1), m.top_k)
    dropped = _drops(top_idx, m.num_experts, m.capacity_factor, shards)
    print(f"{impl} on ({data}, {4 // data}): {dropped} of "
          f"{top_idx.size} (token, expert) pairs dropped")
    assert dropped > 0
    if shards > 1:
        # the per-shard capacity drops other pairs than the whole batch's
        assert dropped != _drops(top_idx, m.num_experts, m.capacity_factor, 1)
    for r in range(4):
        assert out[r]["shardmap"] == (impl == "shardmap")
        np.testing.assert_allclose(out[r]["y"], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[r]["aux"], float(aux), rtol=1e-5)
        assert sorted(out[r]["grads"]) == sorted(jgrads)
        for k, g in jgrads.items():
            np.testing.assert_allclose(out[r]["grads"][k], np.asarray(g),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_set_moe_impl_shardmap_without_a_mesh_takes_gspmd():
    """The reference accepts "shardmap" with no mesh and runs the dense
    path (``_can_shardmap`` is False): the same output."""
    jcfg, cfg = _moe_cfg()
    p = _moe_params(jcfg)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    tp = to_torch(p, "cpu")
    base, _ = moe.apply_moe(tp, x, cfg)
    try:
        moe.set_moe_impl("shardmap")
        jax_moe.set_moe_impl("shardmap")
        assert not moe._can_shardmap(cfg, 10)
        assert not jax_moe._can_shardmap(jcfg, 10)
        got, _ = moe.apply_moe(tp, x, cfg)
    finally:
        moe.set_moe_impl("auto")
        jax_moe.set_moe_impl("auto")
    torch.testing.assert_close(got, base, rtol=0, atol=0)


# --------------------------------------------------------------------------
# training on a (2, 2) mesh
# --------------------------------------------------------------------------


def _train_pair(arch):
    if arch == "deepseek_v2_236b":
        jcfg, cfg = _moe_cfg()
    else:
        jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(
            get_config(arch))
    return jcfg, cfg


def _optimizers(name, lr):
    if name == "adamw":
        return (jopt.adamw(lambda s: jnp.float32(lr), weight_decay=0.01),
                opt_mod.adamw(lambda s: torch.tensor(lr), weight_decay=0.01))
    return (jopt.sgd(lambda s: jnp.float32(lr)),
            opt_mod.sgd(lambda s: torch.tensor(lr)))


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "deepseek_v2_236b"])
def test_training_on_a_2x2_mesh_matches_reference(tmp_path, arch, opt):
    """3 train steps on a (2, 2) gloo mesh (DTensor params, moments and
    batches; deepseek's MoE on the expert-parallel path, which "auto"
    picks) against the reference's single-device run from the same
    params and batches (losses within 1e-5 relative) and the port's run
    without a mesh (within 1e-6).  The params are held to both (1e-5 and
    1e-6 of each leaf's largest magnitude) after SGD steps: AdamW's
    m / sqrt(v) turns the rounding noise of a gradient that is zero in
    exact arithmetic (a key bias's: softmax ignores a constant added to
    a row's logits) into a move of O(lr), so AdamW params differ by
    ~1e-4 of the largest even between the port without a mesh and the
    reference."""
    jcfg, cfg = _train_pair(arch)
    jm = jax_model.Model(jcfg, jax_model.RunConfig(max_seq=64))
    jp = jm.init(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        t = rng.integers(0, jcfg.vocab_size, (4, 9)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                        "mask": np.ones((4, 8), np.float32)})
    lr = 3e-3 if opt == "adamw" else 0.3
    out = ranks.run("train_steps", 4, tmp_path,
                    {"cfg": cfg, "params": params, "batches": batches,
                     "mesh": (2, 2), "lr": lr, "opt": opt})
    jo, po = _optimizers(opt, lr)
    # the reference, one device
    fn = jax.jit(jstep.make_train_step(jm, jo))
    st = jstep.TrainState(jp, jo.init(jp), jax.random.PRNGKey(0))
    jlosses = []
    for b in batches:
        st, met = fn(st, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(met["loss"]))
    # the port, no mesh
    m = Model(cfg, RunConfig(max_seq=64), device="cpu")
    tp = to_torch(params, "cpu")
    pst = step_mod.TrainState(tp, po.init(tp), step_mod.new_rng(0, 1))
    pfn = step_mod.make_train_step(m, po)
    plosses = []
    for b in batches:
        pst, met = pfn(pst, {k: torch.from_numpy(v) for k, v in b.items()})
        plosses.append(met["loss"].item())

    if cfg.moe is not None:
        assert out[0]["shardmap"] == [True] * 3
    for r in range(4):
        got = out[r]["losses"]
        np.testing.assert_allclose(got, jlosses, rtol=1e-5)
        np.testing.assert_allclose(got, plosses, rtol=1e-6)
        if opt == "adamw":
            continue
        mesh_p = _flat(out[r]["params"])
        for tree, tol in ((jax.tree.map(np.asarray, st.params), 1e-5),
                          (pst.params, 1e-6)):
            for k, want in _flat(tree).items():
                want = np.asarray(want.detach() if torch.is_tensor(want)
                                  else want)
                scale = max(float(np.abs(want).max()), 1e-30)
                assert np.abs(mesh_p[k] - want).max() <= tol * scale, k
    # the MLP weights stay on their own placements after the updates
    if out[0]["placements"]:
        assert "Shard" in out[0]["placements"]["w_up"]


def test_host_mesh_launcher_in_four_ranks(tmp_path):
    """``launch.train --mesh host`` inside a 4-rank gloo group: a (4, 1)
    mesh, the same losses as the launcher without a mesh within 1e-6."""
    argv = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--global-batch", "4"]
    out = ranks.run("host_mesh_train", 4, tmp_path,
                    {"argv": argv + ["--mesh", "host"]})
    from repro_torch.launch import train
    base = [h["loss"] for h in train.main(argv)["trainer"].metrics_history]
    for r in range(4):
        assert out[r]["mesh"] == "(4, 1)"
        np.testing.assert_allclose(out[r]["losses"], base, rtol=1e-6)


# --------------------------------------------------------------------------
# the sharded GEMM, elastic restore
# --------------------------------------------------------------------------


def test_sharded_gemm_op_matches_a_at_b(tmp_path):
    """On a (2, 2) mesh: Shard(0) over data, forward and both gradients
    within the reference's 1e-4 of ``a @ b``; the rhs gradient a Partial
    over data; an m that data does not divide raises ValueError."""
    rng = np.random.default_rng(11)
    a, b, w = (rng.standard_normal(s).astype(np.float32)
               for s in ((16, 24), (24, 8), (16, 8)))
    out = ranks.run("sharded_gemm", 4, tmp_path,
                    {"a": a, "b": b, "w": w, "mesh": (2, 2)})
    for r in range(4):
        o = out[r]
        np.testing.assert_allclose(o["out"], a @ b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["ga"], w @ b.T, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["gb"], a.T @ w, rtol=1e-4, atol=1e-4)
        assert o["out_placements"] == "(Shard(dim=0), Replicate())"
        assert o["gb_placements"] == "(Partial(sum), Replicate())"
        assert "not divisible" in o["refused"]


def test_elastic_restore_onto_another_mesh(tmp_path):
    """A state saved from a (2, 2) mesh restores onto (4, 1) bit-equal,
    with the new mesh's placements; the checkpoint holds each rank's own
    pieces, and restored whole in one process and saved again it is the
    format the reference reads."""
    ck = tmp_path / "ck"
    out = ranks.run("elastic", 4, tmp_path, {"dir": str(ck)})
    for r in range(4):
        o = out[r]
        assert o["step"] == 1
        for a, b in zip(o["a"], o["b"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(o["m_a"], o["m"]):
            np.testing.assert_array_equal(a, b)
        assert all(s == "(4, 1)" for s in o["mesh_b"])
        # embed is "vocab fsdp": (V / model, d / data) on each mesh
        V, d = o["a"][0].shape
        assert o["local_a"][0] == (V // 2, d // 2)
        assert o["local_b"][0] == (V, d // 4)
        # optimizer.init on DTensor params: factored row / col moments on
        # state_axes' placements
        assert o["factored"] and all(m == w for m, w, _ in o["factored"])
        assert any("Shard" in m for m, _, _ in o["factored"])
    from repro.checkpoint import checkpointer as jck
    from repro_torch.checkpoint import checkpointer as port_ck
    whole, extra = port_ck.restore(str(ck))
    port_ck.save(str(tmp_path / "one"), extra["step"], whole)
    tree, extra = jck.restore(str(tmp_path / "one"))
    assert extra["step"] == 1 and sorted(tree) == ["opt", "params", "rng"]
    np.testing.assert_array_equal(tree["params"]["embed"], out[0]["a"][0])


# --------------------------------------------------------------------------
# failover
# --------------------------------------------------------------------------


def _failover_setup():
    cfg = reduced(get_config("minicpm_2b"), layers=2, d_model=32, vocab=64)
    model = Model(cfg, RunConfig(max_seq=32), device="cpu")
    opt = opt_mod.adamw(lambda s: torch.tensor(1e-3), weight_decay=0.0)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=7))
    step = step_mod.make_train_step(model, opt, step_mod.TrainConfig())

    def fresh():
        return step_mod.init_state(model, opt,
                                   torch.Generator().manual_seed(0))
    return pipe, step, fresh


def _reference_counts(crash_at, every, total, tmp_path):
    """failures / replayed_steps of the reference's FailoverRunner on a
    step that only counts, crashing at the same calls."""
    calls = {"n": -1}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] in crash_at:
            raise RuntimeError("injected chip failure")
        return state + 1, {"loss": jnp.float32(0)}
    runner = JF.FailoverRunner(
        JF.FailoverConfig(checkpoint_dir=str(tmp_path), checkpoint_every=every),
        flaky, lambda i: {"x": jnp.zeros(1)}, log_fn=lambda s: None)
    _, end = runner.run(jnp.zeros(()), 0, total)
    return runner.failures, runner.replayed_steps, end


def test_failover_replays_to_identical_state(tmp_path):
    """Crashes at calls 5 and 9 of 12 steps, a checkpoint every 4: the
    final state is bit-equal to an uninterrupted run; failures and
    replayed steps are the reference's state machine's."""
    pipe, step, fresh = _failover_setup()
    ref = fresh()
    for i in range(12):
        ref, _ = step(ref, pipe.torch_batch(i, "cpu"))

    crash_at = {5, 9}
    calls = {"n": -1}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] in crash_at:
            raise RuntimeError("injected chip failure")
        return step(state, batch)

    runner = F.FailoverRunner(
        F.FailoverConfig(checkpoint_dir=str(tmp_path / "port"),
                         checkpoint_every=4),
        flaky_step, lambda i: pipe.torch_batch(i, "cpu"),
        log_fn=lambda s: None)
    final, end = runner.run(fresh(), 0, 12)
    assert end == 12
    assert (runner.failures, runner.replayed_steps, end) == \
        _reference_counts(crash_at, 4, 12, tmp_path / "ref")
    for a, b in zip(opt_mod.tree_leaves(ref.params),
                    opt_mod.tree_leaves(final.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_failover_gives_up_after_max_failures(tmp_path):
    pipe, _, fresh = _failover_setup()

    def always_fail(state, batch):
        raise RuntimeError("dead host")

    runner = F.FailoverRunner(
        F.FailoverConfig(checkpoint_dir=str(tmp_path), checkpoint_every=4,
                         max_failures=2),
        always_fail, lambda i: pipe.torch_batch(i, "cpu"),
        log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="exceeded"):
        runner.run(fresh(), 0, 4)
    assert runner.failures == 3
    assert F.RECOVERABLE == (RuntimeError, ValueError)
    assert issubclass(torch.cuda.OutOfMemoryError, RuntimeError)


def test_pipeline_sharded_batch_matches_the_reference(tmp_path):
    """``torch_batch`` without shardings equals the reference's
    ``jax_batch`` byte for byte (the sharded form is checked by the mesh
    trainers)."""
    cfg = dict(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    got = Pipeline(DataConfig(**cfg)).torch_batch(2, "cpu")
    want = JaxPipeline(JaxDataConfig(**cfg)).jax_batch(2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# serving on a mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_serve_on_a_mesh_matches_reference(tmp_path, mesh):
    """Reduced qwen1.5-32b (4 query and 4 KV heads, QKV bias) served on 4
    gloo ranks of a (data, model) mesh from the reference's params: the
    greedy tokens of ``Engine.generate`` and of ``ContinuousEngine`` over
    8 requests are the reference's ``Engine`` and ``ContinuousEngine``
    run without a mesh on the same params, on every rank."""
    jcfg = jax_reduced(jax_get_config("qwen1_5_32b"))
    cfg = reduced(get_config("qwen1_5_32b"))
    jm = jax_model.Model(jcfg, jax_model.RunConfig(max_seq=24))
    jp = jm.init(jax.random.PRNGKey(3))
    case = ranks.serve_case(cfg)
    case.update(cfg=cfg, mesh=mesh, params=jax.tree.map(np.asarray, jp))
    out = ranks.run("serve_engines", 4, tmp_path, case, timeout=300)
    want = np.asarray(jax_engine.Engine(
        jm, jp, jax_engine.EngineConfig(max_len=case["max_len"])).generate(
            case["prompts"], case["steps"]))
    reqs = jax_continuous.ContinuousEngine(
        jm, jp, slots=case["slots"], max_len=case["max_len"]).serve(
        [jax_continuous.Request(rid, np.asarray(p, np.int32), n)
         for rid, p, n in case["requests"]])
    for o in out:
        np.testing.assert_array_equal(o["tokens"], want)
        got = o["continuous T0"]
        assert sorted(got) == sorted(reqs)
        for rid in reqs:
            np.testing.assert_array_equal(got[rid], np.asarray(reqs[rid]))
