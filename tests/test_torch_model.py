"""The whole slice: model, engine and launcher against the JAX package.

reduced(qwen2-7b) with GQA switched on (14 query heads over 2 KV heads,
rep 7) is initialised by the reference, carried over with
``repro_torch.convert`` and run by both packages on the CPU.  The JAX side
runs backend ``pallas``; the port runs backend ``cuda``, which on CPU
tensors takes the kernels' plain versions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

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
    """Every registry config builds in the port now: the recurrent and
    MoE families, pixtral-12b (a frontend) and whisper-base (the
    encoder-decoder, with learned position tables), each with the
    reference's param count."""
    port = Model(get_config(arch), device="cpu").param_count()
    assert port == _jax_count(JaxModel(jax_get_config(arch)))
    if arch in FRONTENDS:
        assert port == FRONTENDS[arch]


# the recurrent and MoE families, reduced so that each stack part exists:
# recurrentgemma-2b's 5 layers are one (rglru, rglru, attn) group and a
# suffix of two; deepseek-v2's and kimi-k2's 3 a dense prefix layer and
# two MoE groups
FAMILIES = {"mamba2_130m": {}, "recurrentgemma_2b": dict(layers=5),
            "deepseek_v2_236b": dict(layers=3), "kimi_k2_1t": dict(layers=3)}


def _family_pair(arch, seed=1, bf16=False):
    dt = "bfloat16" if bf16 else "float32"
    jcfg = jax_reduced(jax_get_config(arch), **FAMILIES[arch])
    cfg = reduced(get_config(arch), **FAMILIES[arch])
    jm = JaxModel(jcfg, JaxRunConfig(max_seq=64, backend="pallas",
                                     param_dtype=dt, cache_dtype=dt))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(cfg, RunConfig(param_dtype=dt, cache_dtype=dt), device="cpu")
    return jm, jp, m, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _tree(d):
    return {k: _tree(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in d.items()}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_prefill_decode_and_full_forward_match_jax(arch):
    """Prefill into a cache, four decode steps and one full forward, each
    against the reference's logits (f32, LOGIT_TOL)."""
    jm, jp, m, p = _family_pair(arch)
    B, P, D, MAX = 2, 9, 4, 32
    toks = _tokens(2, B, P + D, m.cfg.vocab_size)
    jcache, cache = jm.cache_init(B, MAX), m.cache_init(B, MAX)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]), cache=jcache)
    got, same = m.apply(p, torch.from_numpy(toks[:, :P]), cache=cache)
    assert same is cache
    errs = [np.abs(got.numpy() - np.asarray(want)).max()]
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        errs.append(np.abs(got.numpy() - np.asarray(want)).max())
    want, _, _ = jm.apply(jp, jnp.asarray(toks))
    full, _ = m.apply(p, torch.from_numpy(toks))
    errs.append(np.abs(full.numpy() - np.asarray(want)).max())
    assert cache["len"] == P + D == int(jcache["len"])
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_trees_match_jax_layout(arch):
    """Param and cache trees at full width in shape mode (nothing
    allocated): the reference's keys, shapes and dtypes, ``prefix`` /
    ``suffix`` keyed by layer index, each cache leaf in its own dtype
    (bf16 caches: recurrent states f32)."""
    jm = JaxModel(jax_get_config(arch), JaxRunConfig(
        param_dtype="bfloat16", cache_dtype="bfloat16"))
    m = Model(get_config(arch), RunConfig(param_dtype="bfloat16",
                                          cache_dtype="bfloat16"))
    assert _tree(m.param_shapes()) == jax.tree.map(
        lambda s: (tuple(s.shape), s.dtype.name), jm.param_shapes())
    want = jax.tree.map(lambda s: (tuple(s.shape), s.dtype.name),
                        jm.cache_shapes(4, 161))
    assert _tree(m.cache_shapes(4, 161)) == want
    assert m.param_count() == _jax_count(jm)


def _jax_count(jm):
    """The reference's param count in Python ints: its own
    ``Model.param_count()`` takes each leaf's size as a jnp int32 product,
    which wraps above 2**31 elements (a deepseek-v2 or kimi-k2 expert
    stack)."""
    return sum(math.prod(s.shape) for s in jax.tree.leaves(
        jm.param_shapes()))


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "deepseek-v2-236b", "kimi-k2-1t"])
def test_launcher_serves_each_family_on_cpu(capsys, arch, continuous):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--gen", "4"]
    if continuous:
        res = serve.main(argv + ["--continuous", "--requests", "4",
                                 "--prompt-len", "6"])
        assert res["requests"]["completed"] == 4
    else:
        res = serve.main(argv + ["--batch", "2", "--prompt-len", "5"])
        assert res["tokens"] == 8 and res["decode_steps"] == 4
    assert res["engine"].model.device.type == "cpu"
    assert "tok/s" in capsys.readouterr().out


# the configs with a stub frontend, and their full-width param counts
# (whisper-base's at max_seq 4096: a 4096-row decoder position table)
FRONTENDS = {"whisper_base": 100_399_104, "pixtral_12b": 12_247_782_400}


def _frontend_pair(arch, seed=1):
    jm = JaxModel(jax_reduced(jax_get_config(arch)),
                  JaxRunConfig(max_seq=64, backend="pallas"))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(reduced(get_config(arch)), RunConfig(max_seq=64), device="cpu")
    return jm, jp, m, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _embeds(cfg, B, seed=3):
    """Stub frontend input: frames (B, context, d) for whisper, patches
    (B, frontend_len, d) for pixtral."""
    shape = ((B, cfg.encoder.context, cfg.encoder.d_model)
             if cfg.encoder is not None else (B, cfg.frontend_len,
                                              cfg.d_model))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_prefill_decode_and_full_forward_match_jax(arch):
    """Prefill with the stub embeddings (whisper's encoder runs and its
    cross K/V go into the cache; pixtral's patches replace the first
    token embeddings), four decode steps reading the cache, and one full
    forward, each against the reference's logits (f32, LOGIT_TOL)."""
    jm, jp, m, p = _frontend_pair(arch)
    B, P, D, MAX = 2, 10, 4, 32
    toks = _tokens(2, B, P + D, m.cfg.vocab_size)
    ee = _embeds(m.cfg, B)
    jcache, cache = jm.cache_init(B, MAX), m.cache_init(B, MAX)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]),
                               extra_embeds=jnp.asarray(ee), cache=jcache)
    got, same = m.apply(p, torch.from_numpy(toks[:, :P]),
                        extra_embeds=torch.from_numpy(ee), cache=cache)
    assert same is cache
    errs = [np.abs(got.numpy() - np.asarray(want)).max()]
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        errs.append(np.abs(got.numpy() - np.asarray(want)).max())
    want, _, _ = jm.apply(jp, jnp.asarray(toks), extra_embeds=jnp.asarray(ee))
    full, _ = m.apply(p, torch.from_numpy(toks),
                      extra_embeds=torch.from_numpy(ee))
    errs.append(np.abs(full.numpy() - np.asarray(want)).max())
    assert cache["len"] == P + D == int(jcache["len"])
    if m.cfg.encoder is not None:
        assert cache["enc_done"] == 1 == int(jcache["enc_done"])
        np.testing.assert_allclose(
            cache["scan"]["pos0"]["xk"].numpy(),
            np.asarray(jcache["scan"]["pos0"]["xk"]), rtol=1e-5, atol=1e-5)
    assert max(errs) < LOGIT_TOL, errs


def test_whisper_bf16_matches_jax():
    """bf16 params and cache: the encoder runs in f32 on the f32 frames,
    as the reference's promoting products do.  Logits (prefill, decode,
    full forward) within two bf16 steps of their largest magnitude; the
    cross K/V within one, the port storing them in the cache's bf16 where
    the reference's cache keeps its f32 ones."""
    arch, dt = "whisper_base", "bfloat16"
    jm = JaxModel(jax_reduced(jax_get_config(arch)), JaxRunConfig(
        max_seq=64, backend="pallas", param_dtype=dt, cache_dtype=dt))
    jp = jm.init(jax.random.PRNGKey(1))
    m = Model(reduced(get_config(arch)), RunConfig(
        max_seq=64, param_dtype=dt, cache_dtype=dt), device="cpu")
    p = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    B, P, D, MAX = 2, 10, 4, 32
    toks = _tokens(2, B, P + D, m.cfg.vocab_size)
    ee = _embeds(m.cfg, B)
    f32 = lambda a: np.asarray(a, np.float32)          # noqa: E731
    jcache, cache = jm.cache_init(B, MAX), m.cache_init(B, MAX)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]),
                               extra_embeds=jnp.asarray(ee), cache=jcache)
    got, cache = m.apply(p, torch.from_numpy(toks[:, :P]),
                         extra_embeds=torch.from_numpy(ee), cache=cache)
    jxk, xk = f32(jcache["scan"]["pos0"]["xk"]), cache["scan"]["pos0"]["xk"]
    assert np.abs(xk.float().numpy() - jxk).max() <= 2 ** -8 * np.abs(
        jxk).max()
    pairs = [(got, want)]
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        pairs.append((got, want))
    want, _, _ = jm.apply(jp, jnp.asarray(toks), extra_embeds=jnp.asarray(ee))
    full, _ = m.apply(p, torch.from_numpy(toks),
                      extra_embeds=torch.from_numpy(ee))
    pairs.append((full, want))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - f32(want)).max()
        assert err <= 2 ** -7 * np.abs(f32(want)).max(), err


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_greedy_streams_match_jax(arch):
    """Engine.generate with extra_embeds through prefill: the reference's
    greedy streams, on captured-step and eager engines."""
    jm, jp, m, p = _frontend_pair(arch, seed=4)
    prompts = _tokens(104, 2, 9, m.cfg.vocab_size)
    ee = _embeds(m.cfg, 2, seed=5)
    want = JaxEngine(jm, jp, JaxEngineConfig(max_len=24)).generate(
        prompts, 8, extra_embeds=jnp.asarray(ee))
    for graphs in (True, False):
        eng = Engine(m, p, EngineConfig(max_len=24, cuda_graphs=graphs))
        got = eng.generate(prompts, 8, extra_embeds=torch.from_numpy(ee))
        np.testing.assert_array_equal(got, want)
        # the static cache is reset between calls (enc_done, cross K/V)
        again = eng.generate(prompts, 8, extra_embeds=torch.from_numpy(ee))
        np.testing.assert_array_equal(again, want)


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_trees_match_jax_layout(arch):
    """Param and cache trees at full width in shape mode: the reference's
    keys and shapes, whisper's encoder, position tables, ``xk`` / ``xv``
    and ``enc_done``."""
    jm = JaxModel(jax_get_config(arch))
    m = Model(get_config(arch))
    assert _tree(m.param_shapes()) == jax.tree.map(
        lambda s: (tuple(s.shape), s.dtype.name), jm.param_shapes())
    want = jax.tree.map(lambda s: (tuple(s.shape), s.dtype.name),
                        jm.cache_shapes(4, 161))
    assert _tree(m.cache_shapes(4, 161)) == want


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_launcher_serves_each_frontend_on_cpu(capsys, arch):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert res["tokens"] == 8 and res["decode_steps"] == 4
    assert res["engine"].model.device.type == "cpu"
    ee = serve.stub_embeds(res["engine"].model.cfg, 2, "cpu")
    assert ee is not None and bool((ee == 0.1).all())
    assert "tok/s" in capsys.readouterr().out
