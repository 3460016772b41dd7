"""The search and system layer against the JAX package: autotuning
(``core/autotune.py``, ``ops.matmul(backend="cuda_auto")``), design-space
exploration (``core/dse.py``), resource sharing (``core/sharing.py``) and
the multi-accelerator fabric (``core/fabric.py``).

Both packages build the same graphs on the CPU and price them on the
modelled TPU v5e, so every pick, frontier, report and printed module must
be equal, number for number and byte for byte.  The port's emitted GEMM
runs its plain version on CPU tensors; the reference's runs in Pallas
interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import autotune as ref_autotune
from repro.core import dse as ref_dse
from repro.core import fabric as ref_fabric
from repro.core import frontend as ref_fe
from repro.core import hw_ir as ref_hw_ir
from repro.core import ir_text as ref_ir_text
from repro.core import machine_model as ref_mm
from repro.core import pipeline as ref_pipeline
from repro.core import sharing as ref_sharing
from repro.core.passes import PassManager as RefPassManager
from repro.kernels import ops as ref_ops
from repro_torch.core import autotune, dse, fabric, hw_ir, ir_text
from repro_torch.core import frontend as fe
from repro_torch.core import machine_model, pipeline, sharing
from repro_torch.core.passes import PassManager
from repro_torch.kernels import gemm, ops

# the shapes of tests/test_autotune.py, then qwen2-7b's MLP products for
# 512 prefill tokens and gemm_op's product (chip_smoke.py's)
SHAPES = [(256, 256, 256), (512, 128, 64), (128, 384, 256), (128, 96, 64),
          (1024, 1024, 1024), (96, 56, 24), (64, 64, 64), (512, 512, 512),
          (512, 18944, 3584), (512, 3584, 18944), (512, 1024, 768)]
GEMM_F32, GEMM_BF16 = (1e-4, 1e-3), (5e-2, 5e-1)     # (rtol, atol)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("STAGECC_DSE_CACHE", str(tmp_path / "dse-cache"))


def _cands(cands):
    return [(c.schedule, c.tile, c.cycles, c.vmem_bytes, c.feasible)
            for c in cands]


# ---- autotune ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_autotune_picks_match_reference(shape):
    """Every candidate, its price and the winner, equal number for number
    (the machine is TPU_V5E in both packages)."""
    assert autotune.best_schedule(*shape) == ref_autotune.best_schedule(
        *shape)
    assert _cands(autotune.enumerate_candidates(*shape)) == _cands(
        ref_autotune.enumerate_candidates(*shape))
    assert autotune.family_points(*shape) == ref_autotune.family_points(
        *shape)


def test_autotune_is_machine_keyed_as_the_reference():
    """A VMEM-starved machine moves the pick in both packages alike."""
    for mm, tune in ((machine_model, autotune), (ref_mm, ref_autotune)):
        small = dataclasses.replace(mm.TPU_V5E, name="small_vmem",
                                    vmem_capacity_bytes=1 << 18)
        picks = [tune.best_schedule(512, 512, 512, machine=m)
                 for m in (mm.TPU_V5E, small)]
        assert picks[0] != picks[1]
        if tune is autotune:
            got = picks
        else:
            assert got == picks


def test_qwen2_mlp_picks_are_the_256_tiles():
    """The picks chip_smoke.py runs on the card: tpu_mxu, 256 x 256, all
    of K in one block."""
    for m, n, k in SHAPES[-3:]:
        assert autotune.best_schedule(m, n, k) == ("tpu_mxu", (256, 256, k))


def test_compile_gemm_autotuned_emits_cuda_at_the_searched_tiles():
    ck = autotune.compile_gemm_autotuned(512, 1024, 768, device="cpu")
    ref = ref_autotune.compile_gemm_autotuned(512, 1024, 768)
    assert ck.run_cuda is not None and ck.run_torch is not None
    assert ck.run_cuda.plan.tiles == (256, 256, 768)
    assert ck.schedule == ref.schedule == "tpu_mxu"
    assert ck.cycles.total == ref.cycles.total
    assert ir_text.print_kernel(ck.kernel) == ref_ir_text.print_kernel(
        ref.kernel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 512, 128), (128, 96, 64)])
def test_cuda_auto_matches_pallas_auto(shape, dtype):
    """``ops.matmul(backend="cuda_auto")`` on CPU tensors (the emitted
    GEMM's plain version at the searched tiles) against the reference's
    ``pallas_auto`` in interpret mode, under chip_smoke.py's GEMM bounds;
    compiled once per (m, n, k, dtype), and no launch on the CPU."""
    m, n, k = shape
    rng = np.random.default_rng(5)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(ref_ops.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                     backend="pallas_auto"), np.float32)
    before = gemm.cuda_gemm.launches
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = ops.matmul(ta, tb, backend="cuda_auto")
    hits = gemm._build_auto.cache_info().hits
    again = ops.matmul(ta, tb, backend="cuda_auto")
    assert gemm._build_auto.cache_info().hits == hits + 1
    assert torch.equal(got, again)
    assert gemm.cuda_gemm.launches == before
    rtol, atol = GEMM_F32 if dtype == "float32" else GEMM_BF16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    assert "cuda_auto" in ops.BACKENDS


# ---- sharing ----------------------------------------------------------------


def _mlp(f):
    def mlp(x, w1, w2):
        return f.relu(f.matmul(f.relu(f.matmul(x, w1)), w2))
    return f.trace(mlp, [f.spec((8, 8))] * 3, name="mlp2")


def _modules(pkg):
    """(label, HwModule) pairs of one package: the two-layer MLP, a
    flattened GEMM and the three serving kernels, lowered to hardware."""
    f, pm, pl, hw = pkg
    out = [("mlp", hw.lower_to_hw(pm.parse(
        "lower{tile_m=4,tile_n=4,tile_k=4}").run(_mlp(f)).artifact))]
    kw = ({"want_torch": False, "want_cuda": False} if pl is pipeline
          else {"want_jax": False, "want_pallas": False})
    out.append(("gemm", pl.compile_gemm(8, 8, 8, schedule="inner_flattened",
                                        **kw).hw_module))
    for name, graph in (("flash", f.flash_attention_graph(8, 16, 4)),
                        ("decode", f.decode_attention_graph(4, 16, 4)),
                        ("ssd", f.ssd_scan_graph(16, 2, 4))):
        out.append((name, hw.lower_to_hw(pm.parse("lower").run(
            graph).artifact)))
    return out


PORT = (fe, PassManager, pipeline, hw_ir)
REF = (ref_fe, RefPassManager, ref_pipeline, ref_hw_ir)


@pytest.mark.parametrize("how", ["outline", "share", "share2", "none",
                                 "serialize", "set-share"])
def test_sharing_prints_what_the_reference_prints(how):
    """Each sharing transform on the same modules: the printed HwIR, the
    Verilog, the modelled cycles and resources, byte for byte."""
    fns = {"outline": (sharing.outline_subcircuits,
                       ref_sharing.outline_subcircuits),
           "share": (sharing.share_units, ref_sharing.share_units),
           "share2": (lambda m: sharing.share_units(m, max_copies=2),
                      lambda m: ref_sharing.share_units(m, max_copies=2)),
           "none": (lambda m: sharing.set_sharing(m, "none"),
                    lambda m: ref_sharing.set_sharing(m, "none")),
           "serialize": (lambda m: sharing.set_sharing(m, "serialize"),
                         lambda m: ref_sharing.set_sharing(m, "serialize")),
           "set-share": (lambda m: sharing.set_sharing(m, "share"),
                         lambda m: ref_sharing.set_sharing(m, "share"))}
    port_fn, ref_fn = fns[how]
    for (label, got), (_, want) in zip(_modules(PORT), _modules(REF)):
        got, want = port_fn(got) or got, ref_fn(want) or want
        assert ir_text.print_hw_module(got) == \
            ref_ir_text.print_hw_module(want), label
        assert hw_ir.emit_verilog(got) == ref_hw_ir.emit_verilog(want)
        assert str(machine_model.cycles(got)) == str(ref_mm.cycles(want))
        assert str(machine_model.resources(got)) == str(
            ref_mm.resources(want))


@pytest.mark.parametrize("pipe", [
    "lower{tile_m=4,tile_n=4,tile_k=4},lower-to-hw,outline-subcircuits",
    "lower{tile_m=4,tile_n=4,tile_k=4},lower-to-hw,share-units{max_copies=1}",
    "lower,lower-to-hw,set-sharing{mode=serialize},canonicalize",
])
def test_sharing_passes_match_reference(pipe):
    """The three HwIR passes, registered in the port's PassManager."""
    got = PassManager.parse(pipe).run(_mlp(fe))
    want = RefPassManager.parse(pipe).run(_mlp(ref_fe))
    assert ir_text.print_ir(got.artifact) == ref_ir_text.print_ir(
        want.artifact)
    assert [r.pattern_stats for r in got.records] == [
        r.pattern_stats for r in want.records]


def test_set_sharing_refuses_what_the_reference_refuses():
    mod = _modules(PORT)[0][1]
    ref_mod = _modules(REF)[0][1]
    with pytest.raises(ValueError) as got:
        sharing.set_sharing(mod, "bogus")
    with pytest.raises(ValueError) as want:
        ref_sharing.set_sharing(ref_mod, "bogus")
    assert str(got.value) == str(want.value)
    assert sharing.SHARING_MODES == ref_sharing.SHARING_MODES


# ---- design-space exploration -----------------------------------------------


def _gemm(f, s, epilogue="none"):
    if epilogue == "none":
        fn, specs = (lambda a, b: f.matmul(a, b)), [f.spec((s, s))] * 2
    else:
        specs = [f.spec((s, s)), f.spec((s, s)), f.spec((s,))]
        fn = lambda a, b, c: f.relu(f.matmul(a, b) + c)   # noqa: E731
    return f.trace(fn, specs, name=f"gemm_{s}x{s}x{s}_{epilogue}")


@pytest.mark.parametrize("s,epilogue,validate", [
    (8, "none", 64), (16, "none", 4), (8, "bias_relu", 4), (32, "none", 2)])
def test_dse_frontier_matches_reference(s, epilogue, validate, tmp_path):
    """The explored space, every price, the frontier, the dedupe log and
    the co-simulations, as the table and the CSV print them."""
    got = dse.explore(_gemm(fe, s, epilogue), validate_top=validate,
                      use_cache=False)
    want = ref_dse.explore(_gemm(ref_fe, s, epilogue),
                           validate_top=validate, use_cache=False)
    assert got.table() == want.table()
    assert got.to_csv() == want.to_csv()
    assert [c.point.spec for c in got.frontier] == [
        c.point.spec for c in want.frontier]
    assert all(v.ok for v in got.validations)


def test_dse_points_and_budget_match_reference():
    g, rg = _gemm(fe, 8), _gemm(ref_fe, 8)
    assert [(p.family, p.spec) for p in dse.enumerate_points(g)] == [
        (p.family, p.spec) for p in ref_dse.enumerate_points(rg)]
    tight = dict(max_lanes=1, max_vmem_bytes=1 << 20, max_reg_bits=1 << 20)
    got = dse.explore(g, budget=dse.ResourceBudget(**tight), use_cache=False)
    want = ref_dse.explore(rg, budget=ref_dse.ResourceBudget(**tight),
                           use_cache=False)
    assert got.table() == want.table()
    assert any(not c.feasible for c in got.candidates)


def test_dse_cache_is_the_ports_own(tmp_path):
    """A cache directory the reference filled gives the port no hit: its
    entries sit under a ``torch`` directory, keyed with the package's
    name; the port's own second run hits every point."""
    ref_dse.explore(_gemm(ref_fe, 8), cache_dir=str(tmp_path))
    first = dse.explore(_gemm(fe, 8), cache_dir=str(tmp_path))
    assert not any(c.cached for c in first.candidates)
    second = dse.explore(_gemm(fe, 8), cache_dir=str(tmp_path))
    assert all(c.cached for c in second.candidates)
    assert second.table().split("\n")[1:] == first.table().split("\n")[1:]
    assert dse._default_cache_dir().endswith("/torch")
    pt = dse.enumerate_points(_gemm(fe, 8))[0]
    budget = dse.ResourceBudget.from_machine(machine_model.TPU_V5E)
    text = ir_text.print_graph(_gemm(fe, 8))
    assert dse._cache_key(text, machine_model.TPU_V5E, pt, budget) != \
        ref_dse._cache_key(text, ref_mm.TPU_V5E, pt, budget)


def test_dse_pass_and_compiled_kernel_explore_match_reference():
    got = PassManager.parse("dse").run(_gemm(fe, 16))
    want = RefPassManager.parse("dse").run(_gemm(ref_fe, 16))
    assert ir_text.print_ir(got.artifact) == ref_ir_text.print_ir(
        want.artifact)
    ck = pipeline.compile_gemm(8, 8, 8, want_torch=False, want_cuda=False)
    ref = ref_pipeline.compile_gemm(8, 8, 8, want_jax=False,
                                    want_pallas=False)
    assert ck.explore(validate_top=1, use_cache=False).table() == \
        ref.explore(validate_top=1, use_cache=False).table()


# ---- the fabric -------------------------------------------------------------


def _kernels(pl):
    kw = ({"want_torch": False, "want_cuda": False} if pl is pipeline
          else {"want_jax": False, "want_pallas": False})
    return [pl.compile_gemm(8, 8, 8, schedule="nested", epilogue=e, **kw)
            for e in ("none", "relu")]


def _mix(fab, cks, requests=12, process="poisson", copies_per=2):
    mix = fab.TrafficMix("mix", tuple((ck.name, 1.0) for ck in cks),
                         num_requests=requests, process=process, rate=1.0,
                         seed=0)
    mean = sum(fab.transaction_cost(ck.hw_module, fab.AXI4,
                                    ck.cycles.total).total
               for ck in cks) / len(cks)
    return dataclasses.replace(mix, cycles_per_unit=(
        fab.saturating_cycles_per_unit(mix, mean,
                                       load_factor=2.0 * copies_per
                                       * len(cks))))


@pytest.mark.parametrize("process", ["poisson", "bursty", "uniform"])
@pytest.mark.parametrize("policy", ["round_robin", "priority"])
def test_fabric_reports_match_reference(process, policy):
    """The same fleet and stream: the model's serialized and overlapped
    reports and the event simulation, as they print."""
    out = []
    for fab, pl in ((fabric, pipeline), (ref_fabric, ref_pipeline)):
        cks = _kernels(pl)
        mix = _mix(fab, cks, process=process)
        stream = fab.fabric_stream(mix)
        fleet = fab.make_fleet({ck.name: (ck.hw_module, ck.kernel)
                                for ck in cks},
                               copies={ck.name: 2 for ck in cks},
                               crossbar=fab.AXI4, policy=policy)
        out.append(([(r.rid, r.kernel, r.arrival) for r in stream],
                    fleet.model(stream, overlap=False).summary(),
                    fleet.model(stream, overlap=True).summary(),
                    fleet.simulate(stream, overlap=True, seed=0).summary()))
    assert out[0] == out[1]


def test_explore_fleet_matches_reference():
    got_cks, want_cks = _kernels(pipeline), _kernels(ref_pipeline)
    got = fabric.explore_fleet({got_cks[0].name: got_cks[0].graph},
                               _mix(fabric, got_cks[:1], requests=8),
                               per_kernel=2, max_copies=2, validate_top=2)
    want = ref_fabric.explore_fleet({want_cks[0].name: want_cks[0].graph},
                                    _mix(ref_fabric, want_cks[:1],
                                         requests=8),
                                    per_kernel=2, max_copies=2,
                                    validate_top=2)
    assert got.table() == want.table()
    assert got.validations and all(v.ok for v in got.validations)
    assert dse.explore_fleet is not None
    # CompiledKernel.explore_fleet: the even mix it makes itself
    got = got_cks[0].explore_fleet([got_cks[1]], per_kernel=1, max_copies=1,
                                   validate_top=1)
    want = want_cks[0].explore_fleet([want_cks[1]], per_kernel=1,
                                     max_copies=1, validate_top=1)
    assert got.table() == want.table()
    with pytest.raises(ValueError, match="unique"):
        got_cks[0].explore_fleet([got_cks[0]])
