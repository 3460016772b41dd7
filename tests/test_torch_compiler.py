"""The port's compiler stack against the JAX package's, on the CPU.

The same GEMM goes through ``repro.core`` and ``repro_torch.core``: the
printed LoopIR and HwIR must be byte-identical, the modelled cycles,
resources, flops and HBM bytes equal (both priced on ``TPU_V5E``), the
numpy oracles equal, and the port's eager PyTorch backend must match the
reference's jitted XLA backend.  Inputs are made with numpy from a seed.
"""

import dataclasses
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core as ref_core
from repro.core import passes as ref_passes
import repro_torch.core as core
from repro_torch.core import passes

SIZES = (4, 8, 16)
EPILOGUES = ("none", "relu", "bias_relu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "gemm_4x4x4_nested.v")
TOL = 1e-5      # backend_torch vs emit_jit: f32 sums in another order


def _inputs(n, epilogue, seed=0):
    rng = np.random.default_rng(seed + n)
    xs = [rng.standard_normal((n, n)).astype(np.float32) for _ in range(2)]
    if epilogue == "bias_relu":
        xs.append(rng.standard_normal(n).astype(np.float32))
    return xs


def _fields(report):
    """A report's numbers (the two packages' report classes differ)."""
    return dataclasses.asdict(report)


def _pair(n, schedule, epilogue, *, jax=False):
    want = ref_core.compile_gemm(n, n, n, schedule=schedule,
                                 epilogue=epilogue, want_jax=jax,
                                 want_pallas=False)
    got = core.compile_gemm(n, n, n, schedule=schedule, epilogue=epilogue,
                            device="cpu", want_torch=jax, want_cuda=False)
    return want, got


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("schedule", ref_core.SCHEDULES)
def test_ir_reports_and_backends_match(schedule, n, epilogue):
    want, got = _pair(n, schedule, epilogue, jax=True)
    assert got.schedule == want.schedule
    assert core.print_kernel(got.kernel) == ref_core.print_kernel(want.kernel)
    assert (core.print_hw_module(got.hw_module)
            == ref_core.print_hw_module(want.hw_module))
    assert str(got.graph) == str(want.graph)
    assert _fields(got.cycles) == _fields(want.cycles)
    assert _fields(got.resources) == _fields(want.resources)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)

    xs = _inputs(n, epilogue)
    for a, b in zip(got.run_ref(*xs), want.run_ref(*xs)):
        np.testing.assert_array_equal(a, b)
    port = got.run_torch(*xs)
    ref = want.run_jax(*xs)
    assert len(port) == len(ref) == 1
    assert port[0].device.type == "cpu"
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               rtol=TOL, atol=TOL)


def test_verilog_matches_golden():
    ck = core.compile_gemm(4, 4, 4, schedule="nested", device="cpu",
                           want_torch=False, want_cuda=False)
    with open(GOLDEN) as fh:
        assert core.emit_verilog(ck.hw_module) + "\n" == fh.read()


@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("schedule", ref_core.SCHEDULES)
def test_cosim_reports_match(schedule, n):
    want, got = _pair(n, schedule, "bias_relu")
    xs = _inputs(n, "bias_relu", seed=1)
    w, g = want.simulate(*xs), got.simulate(*xs)
    assert (g.observed_cycles, g.modeled_cycles, g.checked) == (
        w.observed_cycles, w.modeled_cycles, w.checked)
    assert g.max_abs_err == w.max_abs_err
    assert _fields(g.sim.cycles) == _fields(w.sim.cycles)
    assert (g.sim.steps_retired, g.sim.fsm_transitions) == (
        w.sim.steps_retired, w.sim.fsm_transitions)
    for a, b in zip(g.outputs, w.outputs):
        np.testing.assert_array_equal(a, b)
    hw, hr = got.simulate_host(*xs), want.simulate_host(*xs)
    assert hw.summary() == hr.summary()


def _builtin(module, registry):
    return {name: pd.level for name, pd in registry.items()
            if pd.fn.__module__ == module.__name__}


def test_pass_registry_is_the_references_minus_the_deferred_passes():
    """No pass is deferred any more: the port registers every pass of the
    reference, in the reference's order, the two emitters renamed."""
    want = _builtin(ref_passes, ref_passes.PASS_REGISTRY)
    want["emit-torch"] = want.pop("emit-jax")
    want["emit-cuda"] = want.pop("emit-pallas")
    got = _builtin(passes, passes.PASS_REGISTRY)
    assert got == want
    rename = {"emit-jax": "emit-torch", "emit-pallas": "emit-cuda"}
    assert list(got) == [rename.get(n, n) for n in
                         _builtin(ref_passes, ref_passes.PASS_REGISTRY)]
    assert passes.PASS_ALIASES == ref_passes.PASS_ALIASES


def test_pipeline_string_emits_torch_and_cuda_callables():
    """The emit passes take the device the outputs land on."""
    g = core.trace(lambda a, b: core.frontend.relu(core.frontend.matmul(
        a, b)), [core.spec((16, 8)), core.spec((8, 32))], name="mm")
    xs = _inputs(32, "none")
    a, b = xs[0][:16, :8], xs[1][:8, :32]
    want = np.maximum(a @ b, 0)
    for emit in ("emit-torch{device=cpu}", "emit-cuda{device=cpu}"):
        fn = core.run_pipeline(
            g, f"lower{{tile_m=8,tile_n=8,tile_k=8}},fuse-epilogue,"
               f"grid{{vars=3}},{emit}").artifact
        out = fn(a, b)
        out = out[0] if isinstance(out, list) else out
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
