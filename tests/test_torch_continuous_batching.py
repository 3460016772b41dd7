"""Continuous batching in the port: results must match single-request
generation exactly (greedy), whatever the slot scheduling order, and the
batched engine (one decode step across all slots, per-row lengths) must
give the serial per-slot engine's token streams.  The port of
``tests/test_continuous_batching.py`` (its attention-model cases; the
SSM ones wait for the port's Mamba-2 layers)."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request, SerialSlotEngine)
from repro_torch.serve.metrics import ServeMetrics, VirtualClock


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2_7b"))
    model = Model(cfg, RunConfig(max_seq=64), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _mixed_requests(cfg, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (4 + i,)).astype(np.int32),
                    max_new=int(rng.integers(1, 8)))
            for i in range(n)]


def test_continuous_matches_sequential(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (4 + i,)).astype(np.int32),
                    max_new=5)
            for i in range(6)]

    ce = ContinuousEngine(model, params, slots=2, max_len=64)
    got = ce.serve(list(reqs))

    eng = Engine(model, params, EngineConfig(max_len=64))
    for r in reqs:
        want = eng.generate(r.prompt[None, :], r.max_new)[0,
                                                          len(r.prompt):]
        np.testing.assert_array_equal(got[r.rid][:r.max_new], want,
                                      err_msg=f"request {r.rid}")


def test_more_requests_than_slots(setup):
    cfg, model, params = setup
    reqs = [Request(rid=i, prompt=np.arange(3, dtype=np.int32),
                    max_new=3) for i in range(7)]
    ce = ContinuousEngine(model, params, slots=3, max_len=32)
    got = ce.serve(reqs)
    assert sorted(got) == list(range(7))
    for v in got.values():
        assert len(v) == 3


def test_batched_bit_identical_to_serial(setup):
    """The batched decode step emits the serial B=1 engine's greedy token
    streams on a mixed request set (different prompt lengths, different
    max_new incl. 1)."""
    cfg, model, params = setup
    reqs = _mixed_requests(cfg)
    batched = ContinuousEngine(model, params, slots=2, max_len=64).serve(
        [Request(r.rid, r.prompt, r.max_new) for r in reqs])
    serial = SerialSlotEngine(model, params, slots=2, max_len=64).serve(
        [Request(r.rid, r.prompt, r.max_new) for r in reqs])
    assert sorted(batched) == sorted(serial) == [r.rid for r in reqs]
    for r in reqs:
        np.testing.assert_array_equal(batched[r.rid], serial[r.rid],
                                      err_msg=f"request {r.rid}")
        assert len(batched[r.rid]) == r.max_new


@pytest.mark.parametrize("engine_cls", [ContinuousEngine, SerialSlotEngine])
def test_max_new_one_emits_exactly_one_token(setup, engine_cls):
    """admit() samples the first token at prefill, so a max_new=1 request
    finishes WITHOUT a decode step."""
    cfg, model, params = setup
    reqs = [Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=1),
            Request(rid=1, prompt=np.arange(5, dtype=np.int32), max_new=3)]
    got = engine_cls(model, params, slots=2, max_len=32).serve(reqs)
    assert len(got[0]) == 1
    assert len(got[1]) == 3
    eng = Engine(model, params, EngineConfig(max_len=32))
    want = eng.generate(reqs[0].prompt[None, :], 1)[0, 4:]
    np.testing.assert_array_equal(got[0], want)


def test_submit_step_api_and_backpressure(setup):
    cfg, model, params = setup
    eng = ContinuousEngine(model, params, slots=2, max_len=32,
                           queue_limit=2)
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32), max_new=4)
            for i in range(5)]
    assert eng.submit(reqs[0])
    assert eng.submit(reqs[1])
    assert not eng.submit(reqs[2])       # queue full -> backpressure
    assert eng.queue_depth == 2
    eng.step()                           # admits into both slots + 1 decode
    assert eng.active_slots == 2 and eng.queue_depth == 0
    assert eng.submit(reqs[2]) and eng.submit(reqs[3])
    eng.drain()
    assert not eng.busy
    assert sorted(eng.results) == [0, 1, 2, 3]
    for v in eng.results.values():
        assert len(v) == 4


def test_batched_engine_records_metrics(setup):
    cfg, model, params = setup
    metrics = ServeMetrics(VirtualClock(), slots=2)
    eng = ContinuousEngine(model, params, slots=2, max_len=32,
                           metrics=metrics)
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new=3) for i in range(4)]
    eng.serve(reqs)
    snap = metrics.snapshot()
    assert snap["requests"]["submitted"] == 4
    assert snap["requests"]["completed"] == 4
    assert snap["tokens"]["decode"] == 4 * 3
    assert snap["tokens"]["prefill"] == sum(3 + i for i in range(4))
    assert snap["ttft"]["count"] == 4
    assert snap["tpot"]["count"] == 4 * 2     # gaps between 3 tokens
    assert snap["slot_utilization"] > 0


def test_max_len_truncates_generation(setup):
    """A request whose prompt+output would overflow max_len finishes at
    the cache boundary instead of writing past it."""
    cfg, model, params = setup
    req = Request(rid=0, prompt=np.arange(8, dtype=np.int32), max_new=50)
    got = ContinuousEngine(model, params, slots=1, max_len=16).serve([req])
    ref = SerialSlotEngine(model, params, slots=1, max_len=16).serve(
        [Request(0, req.prompt, 50)])
    np.testing.assert_array_equal(got[0], ref[0])
    assert len(got[0]) < 50


def test_temperature_sampling_stays_in_vocab(setup):
    cfg, model, params = setup
    eng = ContinuousEngine(model, params, slots=2, max_len=32,
                           temperature=1.0, seed=3)
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32), max_new=4)
            for i in range(3)]
    got = eng.serve(reqs)
    for v in got.values():
        assert v.min() >= 0 and v.max() < cfg.vocab_size

    # per-request generators are seeded from (seed, rid): same seed ->
    # same streams, whatever slot a request lands in
    eng2 = ContinuousEngine(model, params, slots=1, max_len=32,
                            temperature=1.0, seed=3)
    got2 = eng2.serve([Request(i, np.arange(4, dtype=np.int32), 4)
                       for i in reversed(range(3))])
    for rid in got:
        np.testing.assert_array_equal(got[rid], got2[rid])


def test_batched_step_equals_b1_steps_of_its_slots(setup):
    """One batched decode step, its slots at different lengths, gives
    each slot the logits of a B=1 step on the slot's own cache and token
    (``slot_state``), and advances only the occupied slots (f32, 1e-5)."""
    cfg, model, params = setup
    eng = ContinuousEngine(model, params, slots=4, max_len=32)
    rng = np.random.default_rng(2)
    for i, n in enumerate((9, 4, 6)):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, (n,))
                           .astype(np.int32), 8))
    eng.step()
    states = [eng.slot_state(s) for s in range(4)]
    assert [one["len"] for one, _ in states] == [10, 5, 7, 0]
    with torch.no_grad():
        got = eng.decode_step()
        for s, (one, tok) in enumerate(states[:3]):
            want, _ = model.apply(params, tok, cache=one)
            np.testing.assert_allclose(got[s].numpy(), want[0, -1].numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert [eng.slot_state(s)[0]["len"] for s in range(4)] == [11, 6, 8, 0]
