"""The whole slice: model, engine and launcher against the JAX package.

reduced(qwen2-7b) with GQA switched on (14 query heads over 2 KV heads,
rep 7) is initialised by the reference, carried over with
``repro_torch.convert`` and run by both packages on the CPU.  The JAX side
runs backend ``pallas``; the port runs backend ``cuda``, which on CPU
tensors takes the kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import Model as JaxModel
from repro.models.model import RunConfig as JaxRunConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs.base import ARCHS, get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.launch import serve
from repro_torch.models.layers import decode_block
from repro_torch.models.model import Model, RunConfig, mask_padded_vocab
from repro_torch.serve.engine import (Engine, EngineConfig, cache_depth,
                                      real_token_count, throughput_stats)

LOGIT_TOL = 2e-4     # the reference's decode-consistency bound
GQA = dict(num_heads=14, num_kv_heads=2, head_dim=8)
PORTED = ("qwen2_7b", "qwen1_5_32b", "gemma3_4b", "minicpm_2b")


def _pair(arch="qwen2_7b", seed=1, backend="cuda", **over):
    """(jax model, jax params, port model, port params) on the CPU."""
    over = over or (GQA if arch == "qwen2_7b" else {})
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    jm = JaxModel(jcfg, JaxRunConfig(max_seq=64, backend="pallas"))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(cfg, RunConfig(backend=backend), device="cpu")
    return jm, jp, m, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_logits_match_jax(arch):
    jm, jp, m, p = _pair(arch)
    B, P, D, MAX = 2, 8, 4, 32
    toks = _tokens(2, B, P + D, m.cfg.vocab_size)
    jcache = jm.cache_init(B, MAX)
    cache = m.cache_init(B, MAX)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]), cache=jcache)
    got, cache = m.apply(p, torch.from_numpy(toks[:, :P]), cache=cache)
    errs = [np.abs(got.numpy() - np.asarray(want)).max()]
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        errs.append(np.abs(got.numpy() - np.asarray(want)).max())
    assert cache["len"] == P + D == int(jcache["len"])
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("depth", [300, 547])
def test_decode_at_any_cache_depth_matches_jax(depth):
    """Caches deeper than one 256 tile that 256 does not divide: 300 takes
    tiles of 150, the prime 547 tiles of 1."""
    jm, jp, m, p = _pair()
    B, P, D = 2, 8, 3
    toks = _tokens(5, B, P + D, m.cfg.vocab_size)
    jcache, cache = jm.cache_init(B, depth), m.cache_init(B, depth)
    _, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]), cache=jcache)
    m.apply(p, torch.from_numpy(toks[:, :P]), cache=cache)
    errs = []
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        errs.append(np.abs(got.numpy() - np.asarray(want)).max())
    assert max(errs) < LOGIT_TOL, errs


def test_decode_block_and_cache_depth():
    assert [decode_block(n) for n in (1, 161, 256, 300, 512, 547)] == [
        1, 161, 256, 150, 256, 1]
    assert [cache_depth(n) for n in (24, 161, 256, 257, 300, 545)] == [
        24, 161, 256, 512, 512, 768]


def test_full_forward_matches_jax_and_teacher_forcing():
    jm, jp, m, p = _pair()
    toks = _tokens(3, 2, 12, m.cfg.vocab_size)
    want, _, _ = jm.apply(jp, jnp.asarray(toks))
    full, none = m.apply(p, torch.from_numpy(toks))
    assert none is None
    np.testing.assert_allclose(full.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    cache = m.cache_init(2, 16)
    pre, _ = m.apply(p, torch.from_numpy(toks[:, :8]), cache=cache)
    errs = [(pre - full[:, :8]).abs().max().item()]
    for t in range(8, 12):
        lg, _ = m.apply(p, torch.from_numpy(toks[:, t:t + 1]), cache=cache)
        errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    assert max(errs) < LOGIT_TOL, errs


def test_backends_agree_and_cache_updates_in_place():
    _, _, m, p = _pair()
    mt = Model(m.cfg, RunConfig(backend="torch"), device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 6, m.cfg.vocab_size))
    c1, c2 = m.cache_init(2, 16), mt.cache_init(2, 16)
    a, same = m.apply(p, toks, cache=c1)
    b, _ = mt.apply(p, toks, cache=c2)
    assert same is c1 and c1["len"] == 6
    assert c1["scan"]["pos0"]["attn"]["k"][:, :, :6].abs().sum() > 0
    assert c1["scan"]["pos0"]["attn"]["k"][:, :, 6:].abs().sum() == 0
    a, _ = m.apply(p, toks[:, :1], cache=c1)
    b, _ = mt.apply(p, toks[:, :1], cache=c2)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="backend"):
        Model(m.cfg, RunConfig(backend="xla"), device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_greedy_engine_streams_match_jax(seed):
    jm, jp, m, p = _pair(seed=seed)
    prompts = _tokens(seed + 100, 3, 6, m.cfg.vocab_size)
    want = JaxEngine(jm, jp, JaxEngineConfig(max_len=24)).generate(
        prompts, 10)
    eng = Engine(m, p, EngineConfig(max_len=24))
    got = eng.generate(prompts, 10)
    np.testing.assert_array_equal(got, want)
    assert eng.last_timing["decode_steps"] == 10


def test_greedy_engine_streams_match_jax_past_one_tile():
    """max_len 300: the port's cache is 512 deep, JAX's 300, and decode
    reaches 291 valid positions, past the first 256 tile."""
    jm, jp, m, p = _pair(seed=3)
    prompts = _tokens(103, 2, 280, m.cfg.vocab_size)
    want = JaxEngine(jm, jp, JaxEngineConfig(max_len=300)).generate(
        prompts, 12)
    got = Engine(m, p, EngineConfig(max_len=300)).generate(prompts, 12)
    np.testing.assert_array_equal(got, want)


def test_engine_eos_freezes_rows_and_counts_real_tokens():
    _, _, m, p = _pair()
    prompts = _tokens(9, 2, 4, m.cfg.vocab_size)
    eng = Engine(m, p, EngineConfig(max_len=16))
    free = eng.generate(prompts, 6)
    eos = int(free[0, 5])                    # row 0's second new token
    out = eng.generate(prompts, 6, eos_id=eos)
    first = np.flatnonzero(out[0, 4:] == eos)[0]
    assert (out[0, 4 + first:] == eos).all()
    assert real_token_count(out, 4, eos) <= out[:, 4:].size
    stats = throughput_stats(eng, prompts, 3)
    assert stats["tokens"] == 6 and stats["decode_steps"] == 3


def test_temperature_sampling_is_seeded_and_in_vocab():
    _, _, m, p = _pair()
    prompts = _tokens(1, 2, 4, m.cfg.vocab_size)
    runs = [Engine(m, p, EngineConfig(max_len=16, temperature=1.0,
                                      seed=s)).generate(prompts, 6)
            for s in (3, 3)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] < m.cfg.vocab_size).all()


def test_convert_keeps_keys_and_dtypes():
    tree = {"a": jnp.ones((2, 3), jnp.bfloat16),
            "b": {"c": np.arange(4, dtype=np.int32)}}
    out = to_torch(tree, "cpu")
    assert out["a"].dtype == torch.bfloat16 and out["a"].shape == (2, 3)
    assert (out["a"].float() == 1).all()
    assert out["b"]["c"].dtype == torch.int32
    assert out["b"]["c"].tolist() == [0, 1, 2, 3]


def test_mask_padded_vocab():
    logits = torch.zeros((2, 8))
    out = mask_padded_vocab(logits, 5)
    assert (out[:, 5:] == -1e30).all() and (out[:, :5] == 0).all()
    assert mask_padded_vocab(logits, 8) is logits


@pytest.mark.parametrize("prompt_len", [5, 290])
def test_launcher_runs_reduced_on_cpu(capsys, prompt_len):
    # 290 + 4 + 1 = 295 positions: a cache deeper than one 256 tile
    res = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(prompt_len),
                      "--gen", "4"])
    assert res["tokens"] == 8 and res["decode_steps"] == 4
    assert res["engine"].model.device.type == "cpu"
    assert "tok/s" in capsys.readouterr().out


def test_full_width_param_count_matches_jax():
    """Shape mode at full qwen2-7b width: nothing is allocated.  Both
    packages count the QKV biases and the final norm, which
    ModelConfig.param_count() leaves out."""
    cfg = get_config("qwen2-7b")
    port = Model(cfg).param_count()
    ref = JaxModel(jax_get_config("qwen2-7b")).param_count()
    assert port == ref == 7_615_616_512
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    biases = cfg.num_layers * (H + 2 * KV) * hd
    assert port - cfg.param_count() == biases + cfg.d_model


def test_param_and_cache_trees_match_jax_layout():
    cfg = get_config("qwen2-7b")
    jm = JaxModel(jax_get_config("qwen2-7b"))
    shapes = jax.tree.map(lambda s: tuple(s.shape), jm.param_shapes())
    m = Model(cfg)

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in d.items()}

    assert tree(m.param_shapes()) == shapes
    jc = jax.tree.map(lambda s: tuple(s.shape), jm.cache_shapes(4, 161))
    assert tree(m.cache_shapes(4, 161)) == jc


def test_own_init_is_seeded():
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), **GQA)
    m = Model(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(5))
    b = m.init(torch.Generator().manual_seed(5))
    torch.testing.assert_close(a["scan"]["pos0"]["attn"]["wq"],
                               b["scan"]["pos0"]["attn"]["wq"])
    assert a["scan"]["pos0"]["attn"]["wq"].shape == (
        cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(PORTED)))
def test_unported_kinds_raise(arch):
    with pytest.raises(NotImplementedError):
        Model(get_config(arch), device="cpu").param_shapes()
