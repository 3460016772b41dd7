"""The recurrent layers (``models/recurrent.py``) against the JAX package.

RG-LRU (recurrentgemma) and SSD (mamba2) blocks at reduced widths: params
drawn by the reference's ``Maker``, carried over with
``repro_torch.convert``, inputs drawn with numpy; both packages run on
the CPU and agree within 1e-5 (f32).  Also the oracles ``rglru_ref`` and
``rmsnorm_ref``, the cache specs, and the port's in-place cache update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ref as jax_ref
from repro.models import recurrent as jax_rec
from repro.models.layers import Maker as JaxMaker
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.kernels import ref
from repro_torch.models import recurrent as rec

TOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,W", [(7, 4), (1, 4), (5, 1)])
def test_causal_conv1d_matches_jax(with_state, S, W):
    x, w = _rand(0, 2, S, 6), _rand(1, W, 6)
    state = _rand(2, 2, W - 1, 6) if with_state else None
    want_y, want_s = jax_rec.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    got_y, got_s = rec.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if state is None else torch.from_numpy(state))
    _close(got_y, want_y)
    assert tuple(got_s.shape) == tuple(want_s.shape)
    _close(got_s, want_s, 0)


def _layer(arch, init, seed=0):
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jp = getattr(jax_rec, init)(jcfg, JaxMaker("init",
                                               jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _cache_pair(jcfg, cfg, kind, B, seed):
    """The same nonzero cache in both packages: (jax dict, port dict)."""
    spec = getattr(jax_rec, f"{kind}_cache_spec")(jcfg, B, jnp.float32)
    jc = {k: jnp.asarray(_rand(seed + i, *s.shape, scale=0.5))
          for i, (k, s) in enumerate(sorted(spec.items()))}
    return jc, {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


@pytest.mark.parametrize("mode,S", [("none", 11), ("prefill", 11),
                                    ("prefill", 8), ("decode", 1)])
def test_apply_rglru_matches_jax(mode, S):
    jcfg, cfg, jp, p = _layer("recurrentgemma_2b", "init_rglru")
    x = _rand(5, 2, S, cfg.d_model)
    jc = c = None
    if mode != "none":
        jc, c = _cache_pair(jcfg, cfg, "rglru", 2, 7)
    want, jnew = jax_rec.apply_rglru(jp, jnp.asarray(x), jcfg, jc)
    got, new = rec.apply_rglru(p, torch.from_numpy(x), cfg, c)
    _close(got, want)
    if mode == "none":
        assert new is None and jnew is None
    else:
        assert new is c
        for k in ("h", "conv"):
            _close(new[k], jnew[k])


@pytest.mark.parametrize("mode,S", [("none", 16), ("none", 13),
                                    ("prefill", 16), ("prefill", 13),
                                    ("decode", 1)])
def test_apply_ssd_matches_jax(mode, S):
    """S 13 is prime: the chunk (8 at reduced size) falls to 1."""
    jcfg, cfg, jp, p = _layer("mamba2_130m", "init_ssd")
    x = _rand(6, 2, S, cfg.d_model)
    jc = c = None
    if mode != "none":
        jc, c = _cache_pair(jcfg, cfg, "ssd", 2, 9)
    want, jnew = jax_rec.apply_ssd(jp, jnp.asarray(x), jcfg, jc)
    got, new = rec.apply_ssd(p, torch.from_numpy(x), cfg, c)
    _close(got, want)
    if mode != "none":
        for k in ("state", "conv"):
            _close(new[k], jnew[k])


def test_ssd_with_state_matches_jax_across_chunks():
    """The chunked scan with an initial state at several chunk sizes."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 24, 3, 4, 5
    xs, Bm, Cm = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = rng.uniform(0.05, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    D = rng.standard_normal((H,)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    for chunk in (24, 8, 5, 1):
        wy, wh = jax_rec._ssd_with_state(
            *(jnp.asarray(a) for a in (xs, dt, A, Bm, Cm, D, h0)), chunk,
            "xla")
        gy, gh = rec._ssd_with_state(
            *(torch.from_numpy(a) for a in (xs, dt, A, Bm, Cm, D, h0)),
            chunk)
        _close(gy, wy, 1e-4)
        _close(gh, wh, 1e-4)


@pytest.mark.parametrize("kind,arch", [("rglru", "recurrentgemma_2b"),
                                       ("ssd", "mamba2_130m")])
def test_cache_specs_match_jax_in_bf16(kind, arch):
    """Shapes and dtypes: the states f32, the conv window bf16."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = getattr(jax_rec, f"{kind}_cache_spec")(jcfg, 3, jnp.bfloat16)
    got = getattr(rec, f"{kind}_cache_spec")(cfg, 3, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == tuple(want[k].shape), k
        assert str(dtype).split(".")[-1] == want[k].dtype.name, k


def test_rglru_ref_matches_jax_and_the_layer_scan():
    x, ag, ig = (_rand(s, 9, 6) for s in (1, 2, 3))
    a_param = _rand(4, 6)
    want = jax_ref.rglru_ref(*(jnp.asarray(a) for a in (x, ag, ig, a_param)))
    got = ref.rglru_ref(*(torch.from_numpy(a) for a in (x, ag, ig, a_param)))
    _close(got, want)
    # the layer's log-depth scan computes the same recurrence
    h, last = rec._rglru_scan(*(torch.from_numpy(a)[None]
                                for a in (x, ag, ig)),
                              torch.from_numpy(a_param), 8.0, None)
    _close(h[0], want)
    _close(last[0], np.asarray(want)[-1])


def test_rmsnorm_ref_matches_jax():
    x, w = _rand(1, 4, 7, 16), _rand(2, 16)
    _close(ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w)),
           jax_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kind,arch,init", [
    ("rglru", "recurrentgemma_2b", "init_rglru"),
    ("ssd", "mamba2_130m", "init_ssd")])
def test_decode_updates_the_state_in_place(kind, arch, init):
    """A cached step writes the cache's own tensors (same storage, new
    values): what a captured CUDA graph needs."""
    jcfg, cfg, _, p = _layer(arch, init)
    _, c = _cache_pair(jcfg, cfg, kind, 2, 11)
    before = {k: (v.data_ptr(), v.clone()) for k, v in c.items()}
    apply = rec.apply_rglru if kind == "rglru" else rec.apply_ssd
    for S in (5, 1):
        _, new = apply(p, torch.from_numpy(_rand(S, 2, S, cfg.d_model)), cfg,
                       c)
        assert new is c
    for k, (ptr, old) in before.items():
        assert c[k].data_ptr() == ptr, k
        assert not torch.equal(c[k], old), k
