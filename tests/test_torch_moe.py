"""The latent-attention and mixture-of-experts layers (``models/mla.py``,
``models/moe.py``) against the JAX package.

Reduced deepseek-v2 / kimi-k2 widths: params drawn by the reference's
``Maker``, carried over with ``repro_torch.convert``, inputs drawn with
numpy; both packages run on the CPU and agree within 1e-5 (f32).  The MoE
cases cover gated silu and gelu and the plain gelu MLP, shared experts,
and a capacity small enough that tokens drop (the same tokens must drop).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.models.layers import Maker as JaxMaker
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.models import mla, moe

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jcfg, init, seed=0):
    jp = init(jcfg, JaxMaker("init", jax.random.PRNGKey(seed)))
    return jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _mla_cfgs():
    return (jax_reduced(jax_get_config("deepseek_v2_236b")),
            reduced(get_config("deepseek_v2_236b")))


@pytest.mark.parametrize("absorbed", [True, False])
def test_apply_mla_matches_jax(absorbed):
    """No cache (the reconstruct form), a prefill into a cache at an int
    length, then two decode steps (the absorbed form on cached paths
    unless switched off)."""
    jcfg, cfg = _mla_cfgs()
    jp, p = _params(jcfg, jax_mla.init_mla)
    B, P, SMAX = 2, 7, 16
    x = _rand(1, B, P + 2, cfg.d_model)
    pos = np.broadcast_to(np.arange(P + 2), (B, P + 2)).astype(np.int32)
    jax_mla.set_mla_absorbed(absorbed)
    mla.set_mla_absorbed(absorbed)
    try:
        want, _ = jax_mla.apply_mla(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos))
        got, none = mla.apply_mla(p, torch.from_numpy(x), cfg,
                                  torch.from_numpy(pos))
        assert none is None
        _close(got, want)
        a = cfg.mla
        jc = {"ckv": jnp.zeros((B, SMAX, a.kv_lora)),
              "kr": jnp.zeros((B, SMAX, a.qk_rope_dim))}
        c = {k: torch.zeros(v.shape) for k, v in jc.items()}
        for lo, hi in ((0, P), (P, P + 1), (P + 1, P + 2)):
            want, jc = jax_mla.apply_mla(
                jp, jnp.asarray(x[:, lo:hi]), jcfg,
                jnp.asarray(pos[:, lo:hi]), cache=jc, kv_len=jnp.int32(lo))
            got, same = mla.apply_mla(p, torch.from_numpy(x[:, lo:hi]), cfg,
                                      torch.from_numpy(pos[:, lo:hi]),
                                      cache=c, kv_len=lo)
            assert same is c
            _close(got, want)
            for k in ("ckv", "kr"):
                _close(c[k], jc[k])
    finally:
        jax_mla.set_mla_absorbed(True)
        mla.set_mla_absorbed(True)


def test_apply_mla_per_row_lengths():
    """A decode step with a (B,) int32 length tensor writes each row at
    its own position and equals B=1 steps of the rows (int lengths)."""
    jcfg, cfg = _mla_cfgs()
    _, p = _params(jcfg, jax_mla.init_mla, seed=3)
    a, SMAX, lens = cfg.mla, 12, [3, 8]
    c = {"ckv": torch.from_numpy(_rand(4, 2, SMAX, a.kv_lora)),
         "kr": torch.from_numpy(_rand(5, 2, SMAX, a.qk_rope_dim))}
    ones = [{k: v[b:b + 1].clone() for k, v in c.items()} for b in range(2)]
    x = torch.from_numpy(_rand(6, 2, 1, cfg.d_model))
    pos = torch.tensor(lens, dtype=torch.int32)[:, None]
    got, _ = mla.apply_mla(p, x, cfg, pos, cache=c,
                           kv_len=torch.tensor(lens, dtype=torch.int32))
    for b in range(2):
        want, _ = mla.apply_mla(p, x[b:b + 1], cfg, pos[b:b + 1],
                                cache=ones[b], kv_len=lens[b])
        torch.testing.assert_close(got[b:b + 1], want, rtol=TOL, atol=TOL)
        for k in c:
            torch.testing.assert_close(c[k][b:b + 1], ones[b][k])


def _moe_cfgs(arch="deepseek_v2_236b", **over):
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    mlp = over.pop("mlp", None)
    if mlp:
        jcfg = dataclasses.replace(jcfg, mlp=mlp)
        cfg = dataclasses.replace(cfg, mlp=mlp)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **over)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             **over)))


@pytest.mark.parametrize("arch,mlp,over", [
    ("deepseek_v2_236b", None, {}),
    ("deepseek_v2_236b", "gated_gelu", dict(num_shared=1)),
    ("deepseek_v2_236b", "gelu", dict(num_shared=0)),
    ("kimi_k2_1t", None, dict(num_experts=8, top_k=3, capacity_factor=8.0)),
    ("deepseek_v2_236b", None, dict(num_experts=6, top_k=2,
                                    capacity_factor=0.3)),
])
def test_apply_moe_matches_jax(arch, mlp, over):
    jcfg, cfg = _moe_cfgs(arch, mlp=mlp, **over)
    jp, p = _params(jcfg, jax_moe.init_moe)
    x = _rand(2, 2, 9, cfg.d_model)
    want, waux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, waux)
    assert aux.dtype == torch.float32 and aux.shape == ()


def test_small_capacity_drops_the_same_tokens():
    """capacity 1 per expert (cf 0.1, 18 tokens x 2 over 6 experts): the
    port and the reference drop the same (token, expert) pairs, so with
    the shared experts off each token's routed output is zero in both or
    in neither, and equal."""
    jcfg, cfg = _moe_cfgs(num_experts=6, top_k=2, capacity_factor=0.3,
                          num_shared=0)
    assert moe.capacity(cfg, 18) == 2
    jcfg, cfg = _moe_cfgs(num_experts=6, top_k=2, capacity_factor=0.1,
                          num_shared=0)
    assert moe.capacity(cfg, 18) == 1
    jp, p = _params(jcfg, jax_moe.init_moe, seed=4)
    x = _rand(7, 2, 9, cfg.d_model)
    want, _ = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    routed_w = np.abs(np.asarray(want) - x).reshape(18, -1).max(-1)
    routed_g = (got - torch.from_numpy(x)).abs().reshape(18, -1).amax(-1)
    np.testing.assert_array_equal(routed_g.numpy() == 0, routed_w == 0)
    # 6 of the 36 (token, expert) pairs fit: 12 tokens or more lose all
    assert (routed_w == 0).sum() >= 12
    _close(got, want)


def test_top_k_ties_take_the_lower_index():
    """Equal router probabilities (a zero router): every token picks
    experts 0..K-1, as jax.lax.top_k does."""
    jcfg, cfg = _moe_cfgs(num_experts=6, top_k=3, capacity_factor=8.0)
    jp, p = _params(jcfg, jax_moe.init_moe, seed=5)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _rand(8, 1, 5, cfg.d_model)
    want, _ = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _close(got, want)
    # with the experts past K-1 zeroed the output is unchanged
    q = dict(p, w_down=p["w_down"].clone())
    q["w_down"][3:] = 0
    again, _ = moe.apply_moe(q, torch.from_numpy(x), cfg)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_moe_impl_knob():
    """The reference's knob: "shardmap" is a valid setting (with no mesh
    the dense path runs, as the reference's ``_can_shardmap`` is False
    there), a bogus one asserts."""
    moe.set_moe_impl("gspmd")
    assert moe._MOE_IMPL == "gspmd"
    moe.set_moe_impl("shardmap")
    assert moe._MOE_IMPL == "shardmap"
    cfg = reduced(get_config("deepseek_v2_236b"))
    assert not moe._can_shardmap(cfg, 64)
    assert not jax_moe._can_shardmap(jax_reduced(
        jax_get_config("deepseek_v2_236b")), 64)
    with pytest.raises(AssertionError):
        moe.set_moe_impl("bogus")
    moe.set_moe_impl("auto")
