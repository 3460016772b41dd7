"""Serving against the JAX package: reduced-precision params and caches
(``RunConfig.param_dtype`` / ``cache_dtype``), the copied load generator
and metrics, per-row-length decode and the continuous engine.

Both packages run on the CPU on the same numpy-seeded inputs; the port
takes the reference's params through ``repro_torch.convert``.  The JAX
side runs backend ``pallas`` (interpret mode); the port runs backend
``cuda``, whose kernels take their plain versions on CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as jax_model
from repro.serve import continuous as jax_continuous
from repro.serve import loadgen as jax_loadgen
from repro.serve import metrics as jax_metrics
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import to_torch
from repro_torch.launch import serve
from repro_torch.models import model as port_model
from repro_torch.models.model import Model, RunConfig
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve import continuous, loadgen, metrics
from repro_torch.serve.engine import cache_depth

GQA = dict(num_heads=14, num_kv_heads=2, head_dim=8)
LOGIT_TOL = 2e-4     # the reference's decode-consistency bound (f32)
# bf16: each package rounds every product and activation to bf16 and may
# sum in another order, so a value can land a bf16 step (2^-8 of it)
# apart and the stack carries it on; held to tests/test_kernels.py's bf16
# bound relative to the logits' largest magnitude
BF16_REL = 5e-2


def _pair(seed=1, bf16=False):
    """(jax model, jax params, port model, port params) on the CPU."""
    dt = "bfloat16" if bf16 else "float32"
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2_7b")), **GQA)
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), **GQA)
    jm = jax_model.Model(jcfg, jax_model.RunConfig(
        max_seq=64, backend="pallas", param_dtype=dt, cache_dtype=dt))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(cfg, RunConfig(param_dtype=dt, cache_dtype=dt), device="cpu")
    return jm, jp, m, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat(v) if isinstance(v, dict) else [(k, v)]
    return out


def test_run_config_fields_and_defaults_match():
    """The reference's fields less ``remat`` (training's); every default
    the same but ``backend``, whose names are the port's."""
    ref = {f.name: f.default for f in
           dataclasses.fields(jax_model.RunConfig)}
    port = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert set(port) == set(ref) - {"remat"}
    for name in set(port) - {"backend"}:
        assert port[name] == ref[name], name
    assert port["backend"] == "cuda"
    assert set(port_model.DTYPES) == set(jax_model.DTYPES)
    m = port_model.build("qwen2-7b", RunConfig(param_dtype="bfloat16"),
                         device="cpu")
    assert (m.pdtype, m.cdtype) == (torch.bfloat16, torch.float32)
    assert m.cfg.name == jax_get_config("qwen2_7b").name


def test_bf16_init_is_the_cast_of_the_f32_init():
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), **GQA)
    f32 = Model(cfg, RunConfig(), device="cpu").init(
        torch.Generator().manual_seed(3))
    bf16 = Model(cfg, RunConfig(param_dtype="bfloat16"), device="cpu").init(
        torch.Generator().manual_seed(3))
    for (k, a), (_, b) in zip(_flat(f32), _flat(bf16)):
        assert b.dtype == torch.bfloat16, k
        assert torch.equal(a.to(torch.bfloat16), b), k
    shapes = Model(cfg, RunConfig(param_dtype="bfloat16"),
                   device="cpu").param_shapes()
    assert {t.dtype for _, t in _flat(shapes)} == {torch.bfloat16}


def test_convert_carries_bf16_params_over():
    jm, jp, m, p = _pair(bf16=True)
    for (k, a), (_, b) in zip(_flat(jax.tree.map(np.asarray, jp)), _flat(p)):
        assert b.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.float32), b.float().numpy(), err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_cache_shapes_match(bf16):
    jm, _, m, _ = _pair(bf16=bf16)
    want = [(k, v.shape, v.dtype.name) for k, v in
            _flat(jm.cache_shapes(3, 40)) if k != "len"]
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in
           _flat(m.cache_shapes(3, 40)) if k != "len"]
    assert got == want
    cache = m.cache_init(3, 40)
    assert {v.dtype for k, v in _flat(cache) if k != "len"} == {
        torch.bfloat16 if bf16 else torch.float32}


def test_bf16_prefill_decode_logits_match_jax():
    """bf16 params and caches in both packages: prefill, then decode
    steps, each within BF16_REL of the logits' largest magnitude."""
    jm, jp, m, p = _pair(bf16=True)
    B, P, D, MAX = 2, 8, 4, 32
    toks = np.random.default_rng(2).integers(0, m.cfg.vocab_size,
                                             (B, P + D)).astype(np.int32)
    jcache, cache = jm.cache_init(B, MAX), m.cache_init(B, MAX)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]), cache=jcache)
    got, cache = m.apply(p, torch.from_numpy(toks[:, :P]), cache=cache)
    pairs = [(got, want)]
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got, cache = m.apply(p, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache)
        pairs.append((got, want))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        w = np.asarray(want).astype(np.float32)
        err = np.abs(got.float().numpy() - w).max()
        assert err <= BF16_REL * np.abs(w).max(), (err, np.abs(w).max())


def test_per_row_decode_equals_row_by_row():
    """A decode step whose rows sit at different lengths (a (B,) numpy
    ``len``) gives each row the logits and cache of a B=1 decode at its
    own length (f32, 1e-5)."""
    _, _, m, p = _pair()
    lens = np.array([3, 7, 5])
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, m.cfg.vocab_size, (n,)) for n in lens]
    nxt = rng.integers(0, m.cfg.vocab_size, (3, 1))
    depth = 16
    batch = m.cache_init(3, depth)
    singles = []
    for b, pr in enumerate(prompts):
        one = m.cache_init(1, depth)
        m.apply(p, torch.from_numpy(pr[None]), cache=one)
        for leaf, src in zip(cache_leaves(batch), cache_leaves(one)):
            leaf[:, b] = src[:, 0]
        singles.append(one)
    batch["len"] = lens.copy()
    got, batch = m.apply(p, torch.from_numpy(nxt), cache=batch)
    np.testing.assert_array_equal(batch["len"], lens + 1)
    for b, one in enumerate(singles):
        want, one = m.apply(p, torch.from_numpy(nxt[b:b + 1]), cache=one)
        np.testing.assert_allclose(got[b].numpy(), want[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        for leaf, src in zip(cache_leaves(batch), cache_leaves(one)):
            np.testing.assert_allclose(leaf[:, b].numpy(), src[:, 0].numpy(),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="KV cache full"):
        batch["len"] = np.array([3, depth, 5])
        m.apply(p, torch.from_numpy(nxt), cache=batch)


def _stream_cfg(mod, vocab=256, process="poisson"):
    return mod.LoadConfig(num_requests=12, vocab_size=vocab, seed=5,
                          process=process, rate=3.0,
                          prompt=mod.LengthDist("uniform", 3, 9),
                          output=mod.LengthDist("lognormal", 1, 6))


@pytest.mark.parametrize("process", ["poisson", "bursty", "uniform"])
def test_loadgen_stream_matches_jax(process):
    want = jax_loadgen.generate_stream(_stream_cfg(jax_loadgen,
                                                   process=process))
    got = loadgen.generate_stream(_stream_cfg(loadgen, process=process))
    assert loadgen.stream_digest(got) == jax_loadgen.stream_digest(want)
    for g, w in zip(got, want):
        assert (g.rid, g.arrival, g.max_new) == (w.rid, w.arrival, w.max_new)
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_virtual_clock_snapshot_matches_jax():
    def run(mod):
        m = mod.ServeMetrics(mod.VirtualClock(), slots=2)
        for rid in range(3):
            m.on_submit(rid, arrival=0.5 * rid)
        m.on_reject(3)
        for t, (rid, kind) in enumerate([(0, "admit"), (0, "tok"),
                                         (1, "admit"), (1, "tok"),
                                         (0, "tok"), (1, "tok"),
                                         (0, "fin"), (2, "admit"),
                                         (2, "tok"), (1, "fin"),
                                         (2, "tok"), (2, "fin")]):
            m.clock.advance(0.25 + 0.1 * t)
            m.on_step(queue_depth=t % 3, active_slots=1 + t % 2)
            {"admit": lambda: m.on_admit(rid, 4 + rid),
             "tok": lambda: m.on_token(rid),
             "fin": lambda: m.on_finish(rid)}[kind]()
        return m.snapshot()
    assert run(metrics) == run(jax_metrics)


def _requests(mod, cfg, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, (4 + i,)).astype(np.int32),
        max_new=int(rng.integers(1, 8))) for i in range(n)]


def test_continuous_engine_matches_jax():
    """The port's ContinuousEngine and the reference's on the same params
    and requests (max_new=1 among them): the same greedy token streams,
    and under a VirtualClock the same metrics snapshot."""
    jm, jp, m, p = _pair()
    jmet = jax_metrics.ServeMetrics(jax_metrics.VirtualClock(), slots=2)
    want = jax_continuous.ContinuousEngine(
        jm, jp, slots=2, max_len=64, metrics=jmet).serve(
            _requests(jax_continuous, m.cfg))
    pmet = metrics.ServeMetrics(metrics.VirtualClock(), slots=2)
    eng = continuous.ContinuousEngine(m, p, slots=2, max_len=64,
                                      metrics=pmet)
    got = eng.serve(_requests(continuous, m.cfg))
    assert sorted(got) == sorted(want)
    assert 1 in {len(v) for v in got.values()}
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")
    assert pmet.snapshot() == jmet.snapshot()
    assert eng.depth == cache_depth(64)


def test_launcher_runs_continuous_on_cpu(capsys):
    res = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--continuous", "--slots", "2", "--requests", "5",
                      "--prompt-len", "6", "--gen", "4", "--queue-limit",
                      "2"])
    out = capsys.readouterr().out
    assert "[serve] continuous: 5 requests" in out
    assert res["requests"]["completed"] == 5
    assert res["clock"] == "wall" and res["tokens_per_s"] > 0
    assert res["engine"].steps > 0
