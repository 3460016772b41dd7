"""The port's model layers against the JAX package's, at small sizes.

Inputs and params are made with numpy (or by the reference's own init)
and handed to both; the bound is 1e-5 (float32, small widths).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.models import layers as L

TOL = 1e-5
GQA = dict(num_heads=14, num_kv_heads=2, head_dim=8)   # rep = 7


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _cfgs(arch="qwen2_7b", **over):
    """The same reduced config in both packages."""
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = 0.1 * rng.standard_normal(32).astype(np.float32)
    _close(L.rmsnorm(_t(x), _t(w), 1e-6),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(40, 46)]).astype(np.int32)
    _close(L.rope(_t(x), _t(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,window,valid", [
    (True, None, None), (False, None, None), (True, 3, None),
    (True, None, 9)])
def test_attention_core_direct(causal, window, valid):
    B, Sq, Sk, H, KV, hd = 2, 12, 12, 6, 2, 8
    q, k, v = _qkv(2, B, Sq, Sk, H, KV, hd)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    want = JL.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), None if valid is None else jnp.asarray(valid),
        causal=causal, window=window)
    got = L.attention_core(_t(q), _t(k), _t(v), _t(pos), _t(pos), valid,
                           causal=causal, window=window)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 300])
def test_attention_core_blockwise(window):
    """Sq * Sk = 2^22 > 2^21 takes the blockwise online-softmax path in
    both packages (block_q 512, block_k 1024)."""
    B, S, H, KV, hd = 1, 2048, 2, 1, 8
    q, k, v = _qkv(3, B, S, S, H, KV, hd)
    assert S * S > L._DIRECT_LIMIT == JL._DIRECT_LIMIT
    pos = np.arange(S, dtype=np.int32)[None]
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), None,
                             causal=True, window=window)
    got = L.attention_core(_t(q), _t(k), _t(v), _t(pos), _t(pos), None,
                           causal=True, window=window)
    _close(got, want)


def _attn_params(jcfg, seed):
    p = JL.init_attention(jcfg, JL.Maker("init", jax.random.PRNGKey(seed)))
    # the reference inits norm and biases to zero: give them values so
    # the test sees them
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
    for name in ("norm", "bq", "bk", "bv"):
        if name in p:
            p[name] = 0.1 * rng.standard_normal(p[name].shape).astype(
                np.float32)
    return p


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_apply_attention_prefill_then_decode(backend):
    """Prefill into a fresh cache, then two decode steps.  The JAX side
    runs backend pallas (its decode kernel in interpret mode)."""
    jcfg, cfg = _cfgs(**GQA)
    p = _attn_params(jcfg, 4)
    B, P, Smax, d = 2, 5, 16, cfg.d_model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, P + 2, d)).astype(np.float32)
    shape = (B, Smax, cfg.num_kv_heads, cfg.resolved_head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    tp = to_torch(p, "cpu")
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    want, jcache = JL.apply_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[:, :P]),
        jcfg, jnp.asarray(pos), cache=jcache, kv_len=jnp.int32(0),
        backend="pallas")
    got, same = L.apply_attention(tp, _t(x[:, :P]), cfg, _t(pos),
                                  cache=cache, kv_len=0, backend=backend)
    assert same is cache
    _close(got, want)
    for t in (P, P + 1):
        tpos = np.full((B, 1), t, np.int32)
        want, jcache = JL.apply_attention(
            {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(x[:, t:t + 1]), jcfg, jnp.asarray(tpos),
            cache=jcache, kv_len=jnp.int32(t), backend="pallas")
        got, _ = L.apply_attention(tp, _t(x[:, t:t + 1]), cfg, _t(tpos),
                                   cache=cache, kv_len=t, backend=backend)
        _close(got, want)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])


def test_apply_attention_rejects_a_full_cache():
    _, cfg = _cfgs(**GQA)
    jcfg, _ = _cfgs(**GQA)
    tp = to_torch(_attn_params(jcfg, 0), "cpu")
    shape = (1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="cache full"):
        L.apply_attention(tp, x, cfg, torch.zeros((1, 1), dtype=torch.long),
                          cache=cache, kv_len=4)


@pytest.mark.parametrize("mlp", ["gated_silu", "gated_gelu", "gelu"])
def test_mlp(mlp):
    jcfg, cfg = _cfgs(mlp=mlp)
    p = JL.init_mlp(jcfg, JL.Maker("init", jax.random.PRNGKey(6)))
    p = {k: np.asarray(v) for k, v in p.items()}
    p["norm"] = 0.1 * np.random.default_rng(6).standard_normal(
        p["norm"].shape).astype(np.float32)
    x = np.random.default_rng(7).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg)
    _close(L.apply_mlp(to_torch(p, "cpu"), _t(x), cfg), want)
    assert sorted(L.init_mlp(cfg, L.Maker("shape"))) == sorted(p)


def test_maker_fan_in_is_per_layer():
    """Stacked leaves are drawn at the per-layer scale: fan-in 4096 gives
    std 1/64, not the 0.02 a fan-in of the layer count would."""
    g = torch.Generator().manual_seed(0)
    mk = L.Maker("init", g, device="cpu", lead=(4,))
    w = mk((4096, 4), "fsdp heads")
    assert w.shape == (4, 4096, 4)
    assert abs(w.std().item() * 64 - 1) < 0.02
    shape = L.Maker("shape", lead=(3,))((5, 7), "x")
    assert shape.device.type == "meta" and shape.shape == (3, 5, 7)


def test_init_attention_keys_and_shapes_match():
    jcfg, cfg = _cfgs(**GQA)
    want = JL.init_attention(jcfg, JL.Maker("shape"))
    got = L.init_attention(cfg, L.Maker("shape"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
