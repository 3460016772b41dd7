"""The serving compile plan (``repro_torch.serve.compiled``) against the
JAX package's ``repro.serve.compiled``.

For every registry config, ``plan_blocks`` gives the reference's rows
(its raiser patched for the installed jax, ``tests/_torch_raise_ref.py``):
the same blocks, status, schedule and modelled cycles, ``cuda`` where the
reference has ``pallas`` (both emitters refuse the same block:
attn_softmax's k-on-grid schedule), and a fallback reason that names the
ATen op where the reference names the jax primitive.  The plan is a
record: ``ContinuousEngine(plan=)`` keeps it and changes no token.
"""

import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _torch_raise_ref
from repro_torch.configs.base import ARCHS, get_config, reduced
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve import compiled
from repro_torch.serve.continuous import ContinuousEngine, Request

# the reference's primitive names -> the ATen ops the port names
_OPS = {"'slice'": "'aten.slice.Tensor'", "'top_k'": "'aten.topk.default'",
        "primitive: slice": "primitive: aten.slice.Tensor",
        "primitive: top_k": "primitive: aten.topk.default"}


def _as_port(text: str) -> str:
    """A reference plan line read as the port's."""
    for old, new in _OPS.items():
        text = text.replace(old, new)
    return (text.replace("pallas=", "cuda=")
            .replace("validated jax backend", "validated torch backend")
            .replace("FALLBACK plain jit", "FALLBACK plain torch"))


@functools.lru_cache(maxsize=None)
def _port_plan(arch):
    return compiled.plan_blocks(arch, device="cpu")


@pytest.fixture(scope="module")
def ref_plans():
    from repro.serve import compiled as ref_compiled
    with _torch_raise_ref.shim():
        yield functools.lru_cache(maxsize=None)(ref_compiled.plan_blocks)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_rows_match_the_reference(arch, ref_plans):
    mine, theirs = _port_plan(arch), ref_plans(arch)
    assert mine.config == theirs.config and mine.machine == theirs.machine
    assert len(mine.choices) == len(theirs.choices)
    for got, want in zip(mine.choices, theirs.choices):
        assert (got.block, got.status, got.schedule, got.cycles) == (
            want.block, want.status, want.schedule, want.cycles)
        assert got.cuda == want.pallas, got.block
        assert got.reason == _as_port(want.reason), got.block
    assert [r["block"] for r in mine.summary_rows()] == [
        r["block"] for r in theirs.summary_rows()]
    assert set(mine.summary_rows()[0]) == {
        "block", "status", "schedule", "cycles", "cuda", "reason"}


def test_describe_matches_the_reference(ref_plans):
    for arch in ("qwen2_7b", "mamba2_130m", "recurrentgemma_2b"):
        assert _port_plan(arch).describe() == _as_port(
            ref_plans(arch).describe())


def test_plan_states_the_compiled_blocks():
    """The rows the smoke checks on the card: qwen2_7b 4 of 5,
    mamba2_130m 3 of 3, recurrentgemma_2b 5 of 6; attn_softmax compiles
    without a CUDA emission (its k-on-grid schedule has an interior @grid
    loop, which both emitters refuse)."""
    rows = {a: {c.block: c for c in _port_plan(a).choices}
            for a in ("qwen2_7b", "mamba2_130m", "recurrentgemma_2b")}
    assert [len(_port_plan(a).compiled) for a in rows] == [4, 3, 5]
    q = rows["qwen2_7b"]
    assert (q["mlp"].schedule, q["mlp"].cycles, q["mlp"].cuda) == (
        "autotuned:tpu_mxu_kgrid", 8544, True)
    assert (q["attn_softmax"].cycles, q["attn_softmax"].cuda) == (1034, False)
    assert q["rope"].status == "fallback"
    assert "aten.slice.Tensor" in q["rope"].reason
    assert (rows["mamba2_130m"]["ssd_core"].schedule,
            rows["mamba2_130m"]["ssd_core"].cycles) == ("nested", 11472)
    assert rows["recurrentgemma_2b"]["rglru_core"].cycles == 6274
    assert rows["recurrentgemma_2b"]["mlp"].cycles == 15843


def test_unvalidated_plan_keeps_the_choices():
    plan = compiled.plan_blocks("mamba2_130m", device="cpu", validate=False)
    assert [c.reason for c in plan.compiled] == ["not validated"] * 3
    assert [(c.schedule, c.cycles) for c in plan.choices] == [
        (c.schedule, c.cycles) for c in _port_plan("mamba2_130m").choices]


def test_schedule_candidates_order():
    import importlib
    raising = importlib.import_module("repro_torch.core.raise")
    rep = {r.block: r for r in raising.raise_model_blocks("qwen2_7b")}
    cands = compiled._schedule_candidates(rep["mlp"].raised.graph)
    assert [c[0] for c in cands] == ["autotuned:tpu_mxu_kgrid", "tpu_mxu",
                                     "nested"]
    assert compiled._first_matmul_shape(rep["mlp"].raised.graph) == (
        8, 128, 64)
    assert compiled._first_matmul_shape(rep["rmsnorm"].raised.graph) is None
    assert [c[0] for c in compiled._schedule_candidates(
        rep["rmsnorm"].raised.graph)] == ["tpu_mxu", "nested"]


def test_plan_keeps_each_compiled_artifact():
    """A compiled choice carries the artifact of its schedule, so a caller
    runs it without compiling again; the row leaves it out."""
    for c in _port_plan("recurrentgemma_2b").choices:
        if c.status != "compiled":
            assert c.kernel is None
            continue
        assert int(c.kernel.cycles.total) == c.cycles
        assert (c.kernel.run_cuda is not None) == c.cuda
        assert "kernel" not in c.row()


def test_compile_first_takes_the_first_candidate_that_passes():
    import importlib
    raising = importlib.import_module("repro_torch.core.raise")
    rg = {r.block: r for r in raising.raise_model_blocks("qwen2_7b")}[
        "mlp"].raised
    label, ck, refusals = compiled.compile_first(rg, device="cpu")
    assert (label, int(ck.cycles.total), refusals) == (
        "autotuned:tpu_mxu_kgrid", 8544, [])
    seen = []

    def once(ck):
        seen.append(ck)
        if len(seen) == 1:
            raise AssertionError("off")
    label, ck, refusals = compiled.compile_first(rg, accept=once,
                                                 device="cpu")
    assert (label, ck, len(seen)) == ("tpu_mxu", seen[-1], 2)
    assert refusals == ["autotuned:tpu_mxu_kgrid: validation failed: off"]

    def never(ck):
        raise AssertionError("off")
    assert compiled.compile_first(rg, accept=never, device="cpu") == (
        None, None, [f"{c}: validation failed: off" for c in (
            "autotuned:tpu_mxu_kgrid", "tpu_mxu", "nested")])


def test_engine_keeps_the_plan_and_changes_no_token():
    cfg = reduced(get_config("qwen2_7b"))
    model = Model(cfg, RunConfig(max_seq=64), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, cfg.vocab_size, (4 + i,)).astype(np.int32),
             int(rng.integers(1, 8))) for i in range(5)]
    plan = _port_plan("qwen2_7b")
    with_plan = ContinuousEngine(model, params, slots=2, max_len=64,
                                 plan=plan)
    plain = ContinuousEngine(model, params, slots=2, max_len=64)
    assert with_plan.plan is plan and plain.plan is None
    a = with_plan.serve([Request(*r) for r in reqs])
    b = plain.serve([Request(*r) for r in reqs])
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
