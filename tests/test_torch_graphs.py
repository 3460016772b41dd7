"""Captured decode steps (``serve/graphs.py``) and the engines built on
them, on the CPU.

On CPU tensors ``DecodeGraph`` runs the body it would capture on the card
(the model's step on static token and lengths buffers, lengths as a (B,)
int32 device tensor), so these tests run exactly what a graph replays:
it must equal ``model.apply`` in every lengths form bit for bit, the
engines that reuse their static caches must give a fresh engine's and
the eager engine's streams, and the JAX package's on the same params.
The launch-accounting arithmetic that a replay adds is checked with a
stand-in graph.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp
from repro.serve import continuous as jax_continuous
from repro.serve import engine as jax_engine
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import gemm
from repro_torch.models import transformer as T
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve import continuous, graphs
from repro_torch.serve.engine import Engine, EngineConfig, SerialSlotEngine

from test_torch_serve import LOGIT_TOL, _pair

DEPTH = 32


def _prefilled(m, p, prompts, depth=DEPTH):
    """A cache whose rows hold ``prompts`` (of different lengths), each
    prefilled at B=1 and copied in; ``len`` the per-row lengths."""
    batch = m.cache_init(len(prompts), depth)
    for b, pr in enumerate(prompts):
        one = m.cache_init(1, depth)
        m.apply(p, torch.from_numpy(pr[None]), cache=one)
        for leaf, src in zip(cache_leaves(batch), cache_leaves(one)):
            leaf[:, b] = src[:, 0]
    batch["len"] = np.array([len(pr) for pr in prompts])
    return batch


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else
            (v.clone() if torch.is_tensor(v) else np.copy(v))
            for k, v in cache.items()}


def _same_cache(a, b):
    return all(torch.equal(x, y) for x, y in zip(cache_leaves(a),
                                                  cache_leaves(b)))


@pytest.mark.parametrize("bf16", [False, True])
def test_captured_body_equals_model_apply(bf16):
    """The helper's step at per-row lengths: bit-equal to ``model.apply``
    with the numpy lengths form, logits and cache; the lengths are left to
    the caller."""
    _, _, m, p = _pair(bf16=bf16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, m.cfg.vocab_size, (n,)) for n in (3, 9, 1, 6)]
    tok = torch.from_numpy(rng.integers(0, m.cfg.vocab_size, (4, 1)))
    cache = _prefilled(m, p, prompts)
    twin = _clone(cache)
    step = graphs.DecodeGraph(m, p, cache, 4)
    got = step(tok.to(torch.int32), cache["len"])
    want, _ = m.apply(p, tok, cache=twin)
    assert torch.equal(got, want[:, -1])
    assert _same_cache(cache, twin)
    np.testing.assert_array_equal(cache["len"], [3, 9, 1, 6])
    assert step.graph is None and step.moves == {}      # no capture on CPU


@pytest.mark.parametrize("bf16", [False, True])
def test_lengths_forms_are_bit_equal(bf16):
    """One decode step from one state with ``len`` an int, a (B,) numpy
    array and a (B,) int32 tensor: the same logits and caches bit for bit,
    and each form advanced in its own type."""
    _, _, m, p = _pair(bf16=bf16)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, m.cfg.vocab_size, (3, 7)))
    base = m.cache_init(3, DEPTH)
    m.apply(p, toks[:, :6], cache=base)
    outs = []
    for form in (6, np.full(3, 6), torch.full((3,), 6, dtype=torch.int32)):
        cache = _clone(base)
        cache["len"] = form
        logits, cache = m.apply(p, toks[:, 6:], cache=cache)
        outs.append((logits, cache))
    for logits, cache in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert _same_cache(cache, outs[0][1])
    assert outs[0][1]["len"] == 7
    np.testing.assert_array_equal(outs[1][1]["len"], [7, 7, 7])
    assert torch.equal(outs[2][1]["len"], torch.full((3,), 7,
                                                     dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        cache = _clone(base)
        cache["len"] = torch.full((3,), 6)                 # int64
        m.apply(p, toks[:, 6:], cache=cache)


def test_captured_step_matches_jax_decode():
    """A prefill, then the helper's decode steps at one length for every
    row, against the reference's jitted decode steps (f32)."""
    jm, jp, m, p = _pair()
    B, P, D = 2, 6, 4
    toks = np.random.default_rng(2).integers(0, m.cfg.vocab_size,
                                             (B, P + D)).astype(np.int32)
    jcache, cache = jm.cache_init(B, DEPTH), m.cache_init(B, DEPTH)
    _, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, :P]), cache=jcache)
    m.apply(p, torch.from_numpy(toks[:, :P]), cache=cache)
    step = graphs.DecodeGraph(m, p, cache, B)
    for t in range(P, P + D):
        want, jcache, _ = jm.apply(jp, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jcache)
        got = step(torch.from_numpy(toks[:, t:t + 1]), cache["len"])
        cache["len"] += 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_captured_step_refuses_a_full_cache():
    _, _, m, p = _pair()
    cache = m.cache_init(2, 8)
    step = graphs.DecodeGraph(m, p, cache, 2)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="KV cache full"):
        step(tok, np.array([3, 8]))
    with pytest.raises(ValueError, match="KV cache full"):
        step(tok, 8)
    step(tok, 7)


@pytest.mark.parametrize("bf16", [False, True])
def test_engine_reuses_its_static_cache(bf16):
    """Two ``generate`` calls on one engine (the second with shorter
    prompts, so stale positions lie past its lengths) give the streams of
    a fresh engine and of the eager engine; one static cache per (batch,
    depth).  In f32 the streams are also the reference's."""
    jm, jp, m, p = _pair(bf16=bf16)
    rng = np.random.default_rng(9)
    first = rng.integers(0, m.cfg.vocab_size, (2, 12)).astype(np.int32)
    second = rng.integers(0, m.cfg.vocab_size, (2, 5)).astype(np.int32)
    cfg = EngineConfig(max_len=24)
    eng = Engine(m, p, cfg)
    eng.generate(first, 6)
    got = eng.generate(second, 6)
    assert list(eng._steps) == [(2, 24)]
    np.testing.assert_array_equal(got, Engine(m, p, cfg).generate(second, 6))
    eager = Engine(m, p, EngineConfig(max_len=24, cuda_graphs=False))
    np.testing.assert_array_equal(got, eager.generate(second, 6))
    assert not eager._steps
    if not bf16:
        want = jax_engine.Engine(jm, jp, jax_engine.EngineConfig(
            max_len=24)).generate(second, 6)
        np.testing.assert_array_equal(got, np.asarray(want))
    # eos: a frozen row keeps emitting eos, as the eager engine's does
    eos = int(got[0, 6])
    np.testing.assert_array_equal(eng.generate(second, 6, eos_id=eos),
                                  eager.generate(second, 6, eos_id=eos))


def _requests(mod, cfg, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, (2 + 3 * i,)).astype(np.int32),
        max_new=int(rng.integers(1, 7))) for i in range(n)]


@pytest.mark.parametrize("bf16", [False, True])
def test_slot_engines_on_captured_steps_match_eager(bf16):
    """The serial engine (a static B=1 cache and step per slot) and the
    continuous engine (one batched step over per-row lengths), each run
    twice on one engine: the eager engines' streams, bit for bit; in f32
    also the reference's continuous engine's."""
    jm, jp, m, p = _pair(bf16=bf16)
    reqs = _requests(continuous, m.cfg)
    serial = SerialSlotEngine(m, p, slots=3, max_len=40)
    assert len(serial._steps) == 3
    got = serial.serve(reqs)
    rerun = serial.serve(reqs)
    want = SerialSlotEngine(m, p, slots=3, max_len=40,
                            cuda_graphs=False).serve(reqs)
    cont = continuous.ContinuousEngine(m, p, slots=3, max_len=40)
    batched = cont.serve(_requests(continuous, m.cfg))
    again = continuous.ContinuousEngine(
        m, p, slots=3, max_len=40, cuda_graphs=False).serve(
            _requests(continuous, m.cfg))
    assert sorted(got) == sorted(rerun) == sorted(want) == sorted(batched)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(rerun[rid], want[rid])
        np.testing.assert_array_equal(batched[rid], again[rid])
    if not bf16:
        ref = jax_continuous.ContinuousEngine(jm, jp, slots=3,
                                              max_len=40).serve(
            _requests(jax_continuous, m.cfg))
        for rid in ref:
            np.testing.assert_array_equal(batched[rid], np.asarray(ref[rid]))


def test_continuous_batched_step_equals_eager_step():
    """One batched step from one engine state: the captured step's logits
    and cache bit-equal to the eager step's (bf16 and f32 alike run the
    same body; f32 here)."""
    _, _, m, p = _pair()
    engines = [continuous.ContinuousEngine(m, p, slots=3, max_len=40,
                                           cuda_graphs=g)
               for g in (True, False)]
    for eng in engines:
        for r in _requests(continuous, m.cfg, n=3):
            eng.submit(continuous.Request(r.rid, r.prompt, 8))
        eng.step()
    a, b = (eng.decode_step() for eng in engines)
    assert torch.equal(a, b)
    assert _same_cache(engines[0]._cache, engines[1]._cache)
    np.testing.assert_array_equal(engines[0]._cache["len"],
                                  engines[1]._cache["len"])


class _Replay:
    """A stand-in for a captured graph: replaying runs nothing."""
    replays = 0

    def replay(self):
        _Replay.replays += 1


def test_launch_accounting():
    """What the counters moved during capture is taken back and kept;
    each replay adds it once; counters not moved are left alone."""
    before = graphs.counters()
    assert set(before) >= {"decode_attention.launches",
                           "decode_attention.narrow_launches",
                           "cuda_gemm.launches", "cuda_gemm.wgmma_launches",
                           "cuda_gemm.ffma_launches",
                           "flash_attention.launches", "ssd_scan.launches",
                           "emit_general.launches"}
    da.decode_attention.launches += 28            # as a capture would
    gemm.cuda_gemm.ffma_launches += 2
    moves = graphs.moved(before, graphs.counters())
    assert moves == {"decode_attention.launches": 28,
                     "cuda_gemm.ffma_launches": 2}
    graphs.add(moves, -1)
    assert graphs.counters() == before
    _, _, m, p = _pair()
    step = graphs.DecodeGraph(m, p, m.cache_init(2, 8), 2)
    step.graph, step.moves, step.logits = _Replay(), moves, torch.zeros(2, 3)
    step._put = lambda tok, lens: None
    step.capture = True                       # takes the replay branch
    for _ in range(5):
        assert step(None, 0) is step.logits
    after = graphs.counters()
    assert after["decode_attention.launches"] == \
        before["decode_attention.launches"] + 5 * 28
    assert after["cuda_gemm.ffma_launches"] == \
        before["cuda_gemm.ffma_launches"] + 5 * 2
    assert {k for k in after if after[k] != before[k]} == set(moves)
    assert step.replays == 5 and _Replay.replays == 5
    graphs.add(moves, -5)
    assert graphs.counters() == before


# ---- the recurrent and MoE families --------------------------------------


def _family(arch, bf16=False, **kw):
    """A port model of a reduced family config with its own seeded
    params (no reference needed: these hold the port to itself)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import Model, RunConfig
    dt = "bfloat16" if bf16 else "float32"
    cfg = reduced(get_config(arch), **kw)
    m = Model(cfg, RunConfig(param_dtype=dt, cache_dtype=dt), device="cpu")
    return m, m.init(torch.Generator().manual_seed(2))


FAMILIES = {"mamba2_130m": {}, "recurrentgemma_2b": dict(layers=5),
            "deepseek_v2_236b": dict(layers=3), "kimi_k2_1t": dict(layers=3)}


def test_cache_depth_of_each_family():
    """The depth comes from a leaf with a sequence axis, wherever it sits
    (stacked keys, an unrolled layer's MLA latents); a mamba2 cache has
    none, and its captured step is bounded by the engine's max_len."""
    from repro_torch.models import transformer as T
    for arch, kw in FAMILIES.items():
        m, p = _family(arch, **kw)
        cache = m.cache_init(2, 24)
        assert T.depth(cache) == (None if arch == "mamba2_130m" else 24)
    m, p = _family("mamba2_130m")
    cache = m.cache_init(2, 24)
    with pytest.raises(ValueError, match="max_len"):
        graphs.DecodeGraph(m, p, cache, 2)
    step = graphs.DecodeGraph(m, p, cache, 2, 20)
    assert step.depth == 20
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="KV cache full"):
        step(tok, np.array([3, 20]))
    step(tok, np.array([3, 19]))
    # a deepseek step is bounded by its latents' depth, not max_len
    m, p = _family("deepseek_v2_236b", layers=3)
    assert graphs.DecodeGraph(m, p, m.cache_init(2, 24), 2, 99).depth == 24


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_captured_body_equals_model_apply(arch, bf16):
    """One captured step at per-row lengths against one eager step from
    the same state: logits and every cache leaf bit-equal, so the step
    advances recurrent states once, in the cache's own tensors."""
    m, p = _family(arch, bf16=bf16, **FAMILIES[arch])
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, m.cfg.vocab_size, (n,)) for n in (5, 2, 7)]
    batch = m.cache_init(3, DEPTH)
    for b, pr in enumerate(prompts):
        one = m.cache_init(1, DEPTH)
        m.apply(p, torch.from_numpy(pr[None]), cache=one)
        T.copy_rows(batch, b, one, 0)
    batch["len"] = np.array([len(pr) for pr in prompts])
    twin = _clone(batch)
    ptrs = [leaf.data_ptr() for leaf in cache_leaves(batch)]
    before = _clone(batch)
    tok = torch.from_numpy(rng.integers(0, m.cfg.vocab_size, (3, 1)))
    step = graphs.DecodeGraph(m, p, batch, 3, DEPTH)
    got = step(tok.to(torch.int32), batch["len"])
    want, _ = m.apply(p, tok, cache=twin)
    assert torch.equal(got, want[:, -1])
    assert _same_cache(batch, twin)
    assert ptrs == [leaf.data_ptr() for leaf in cache_leaves(batch)]
    for (name, leaf, _), (_, old, _) in zip(T.cache_items(batch),
                                            T.cache_items(before)):
        if name in ("h", "state", "conv"):
            assert not torch.equal(leaf, old), name


@pytest.mark.parametrize("arch", ["mamba2_130m", "recurrentgemma_2b"])
def test_family_engine_reuses_its_static_cache(arch):
    """A second ``generate`` on one engine starts from zeroed recurrent
    states (``transformer.reset``), not the first call's: its streams are
    a fresh engine's and the eager engine's; so are the serial slot
    engine's, whose slots reuse their static caches."""
    m, p = _family(arch, **FAMILIES[arch])
    rng = np.random.default_rng(10)
    first = rng.integers(0, m.cfg.vocab_size, (2, 9)).astype(np.int32)
    second = rng.integers(0, m.cfg.vocab_size, (2, 5)).astype(np.int32)
    eng = Engine(m, p, EngineConfig(max_len=24))
    eng.generate(first, 6)
    got = eng.generate(second, 6)
    fresh = Engine(m, p, EngineConfig(max_len=24))
    np.testing.assert_array_equal(got, fresh.generate(second, 6))
    for (name, a, _), (_, b, _) in zip(
            T.cache_items(eng._steps[(2, 24)].cache),
            T.cache_items(fresh._steps[(2, 24)].cache)):
        if name in ("h", "state", "conv"):
            assert torch.equal(a, b), name
    np.testing.assert_array_equal(got, Engine(m, p, EngineConfig(
        max_len=24, cuda_graphs=False)).generate(second, 6))
    reqs = _requests(continuous, m.cfg)
    serial = SerialSlotEngine(m, p, slots=2, max_len=40)
    serial.serve(reqs)
    again = serial.serve(reqs)
    want = SerialSlotEngine(m, p, slots=2, max_len=40,
                            cuda_graphs=False).serve(reqs)
    for rid in want:
        np.testing.assert_array_equal(again[rid], want[rid])


def test_capture_failure_on_a_mesh_raises(monkeypatch):
    """A decode step on a (1, 1) gloo mesh whose capture fails (the CUDA
    graph refused at its end, as a capture that met a host sync is)
    raises that error, each call again, and never hands back the eager
    step's logits: the graph stays unmade, no replay is counted, and the
    launch counters the capture moved are taken back.  Only
    ``cuda_graphs=False`` runs the step eagerly."""
    import _torch_dist_ranks as ranks
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.serve.continuous import serving_params
    _, _, m, p = _pair()

    class Refused:
        def __init__(self, graph, stream=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    with ranks.one_rank_mesh() as mesh, axis_rules(mesh):
        step = graphs.DecodeGraph(m, serving_params(m, p, mesh),
                                  m.cache_init(2, 24, mesh), 2)
        step.capture = True                   # takes the card's branch
        body = step.body

        def launching():
            # the kernel's launch while capturing moves its counter
            graphs.decode_attention.launches += 1
            return body()
        step.body = launching
        monkeypatch.setattr(graphs.DecodeGraph, "_warm",
                            lambda self: (None, None))
        monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", object)
        monkeypatch.setattr(graphs.torch.cuda, "graph", Refused)
        before = graphs.counters()
        tok = torch.zeros((2, 1), dtype=torch.int32)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="stream is capturing"):
                step(tok, 3)
            assert step.graph is None and step.replays == 0
        assert graphs.counters() == before
