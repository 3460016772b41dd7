"""The serving kernels compiled through the port's stack, against the
reference's: the differential matrix of ``tests/test_compiled_kernels.py``
with the general emitter's CUDA stages (``backend_cuda.emit_general``)
in place of ``backend_pallas.emit_general``.

Every cell compiles the same graph under the same pipeline in both
packages and runs the port's ``run_ref``, ``run_torch`` and ``run_cuda``
(on CPU tensors, the plain version ``general_plain``) on numpy-seeded
inputs.  Each is held, within the reference test's 1e-4, to the numpy
oracle, to the reference's ``run_pallas`` (Pallas in interpret mode) and
to the port's hand kernel (its CPU version) on the same slice.  The
emitters must also refuse the same kernels and cut them into the same
stages (``reads`` / ``writes``).
"""

import itertools

import numpy as np
import pytest
import torch

import repro.core.frontend as ref_fe
import repro_torch.core.frontend as fe
from repro.core import backend_pallas
from repro.core import ir_text as ref_ir_text
from repro.core import pipeline as ref_pipeline
from repro_torch.core import backend_cuda, compile_gemm, compile_traced
from repro_torch.core import ir_text
from repro_torch.core.passes import PassManager
from repro_torch.kernels import gemm
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

import _torch_stage_cases as cases

TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_compiled_kernels.py's
TOL_BF16 = 5e-2                         # tests/test_kernels.py's bf16 bound


# --------------------------------------------------------------------------
# oracles, and the hand kernels on the inputs of _torch_stage_cases
# --------------------------------------------------------------------------


def _softmax_oracle(qs, kt, v, mask):
    s = qs.astype(np.float64) @ kt + mask
    m = s.max(axis=1, keepdims=True)
    p = np.exp(s - m)
    return ((p @ v) / p.sum(axis=1, keepdims=True)).astype(np.float32)


def _scan_oracle(a, u, ct, g):
    h = np.zeros_like(u[0], dtype=np.float64)
    hs = np.empty(u.shape, np.float64)
    for t in range(u.shape[0]):
        h = a[t] * h + u[t]
        hs[t] = h
    return ((hs * ct) @ g).astype(np.float32)


def _flash_case(sq, sk, d, seed=0, window=None):
    """Inputs of the flash graph and the port's flash_attention (its CPU
    version) on the same data."""
    qkv, inputs = cases.flash_inputs(sq, sk, d, seed, window)
    hand = flash_attention(*(torch.from_numpy(x) for x in qkv),
                           causal=True, window=window)[0].numpy()
    return inputs, hand


def _ssd_case(s, p, n, head, chunk, seed=0):
    """Per-head inputs of the SSD graph and the port's ssd_scan (its CPU
    version) on the same data."""
    raw, inputs = cases.ssd_inputs(s, p, n, head, seed)
    hand = ssd_scan(*(torch.from_numpy(t) for t in raw), None,
                    chunk=chunk)[:, head, :].numpy()
    return inputs, hand


def _same_stages(port_fn, ref_fn):
    assert [(s.reads, s.writes) for s in port_fn.stages] == \
        [(s.reads, s.writes) for s in ref_fn.stages]


def _check_cell(kind, dims, inputs, hand, pipe):
    """One matrix cell: both stacks compile ``pipe``; every port backend
    against the oracle, ``run_cuda`` against the reference's
    ``run_pallas`` and the hand kernel."""
    oracle = (_softmax_oracle(*inputs) if kind != "ssd"
              else _scan_oracle(*inputs))
    np.testing.assert_allclose(hand, oracle, **TOL)
    build = {"flash": "flash_attention_graph",
             "decode": "decode_attention_graph", "ssd": "ssd_scan_graph"}
    ck = compile_traced(getattr(fe, build[kind])(*dims), pipeline=pipe,
                        device="cpu")
    rck = ref_pipeline.compile_traced(getattr(ref_fe, build[kind])(*dims),
                                      pipeline=pipe, want_jax=False)
    assert ir_text.print_ir(ck.kernel) == ref_ir_text.print_ir(rck.kernel)
    assert (ck.run_cuda is None) == (rck.run_pallas is None)
    assert ck.run_cuda is not None, f"no CUDA emission for {pipe!r}"
    assert ck.run_cuda.plan is None and rck.run_pallas.plan is None
    _same_stages(ck.run_cuda, rck.run_pallas)

    (ref,) = ck.run_ref(*inputs)
    np.testing.assert_allclose(ref, oracle, **TOL)
    (tch,) = ck.run_torch(*inputs)
    np.testing.assert_allclose(tch.numpy(), oracle, **TOL)
    launches = backend_cuda.emit_general.launches
    got = ck.run_cuda(*inputs)
    assert backend_cuda.emit_general.launches == launches   # plain on CPU
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, np.asarray(rck.run_pallas(*inputs)),
                               **TOL)
    np.testing.assert_allclose(got, hand, **TOL)
    return ck


def _pipe(template, tile):
    tm, tn, tk = tile
    return template.format(t=f"tile_m={tm},tile_n={tn},tile_k={tk}")


ATTN_PIPES = [
    "lower{{{t}}}",
    "lower{{{t}}},fuse-epilogue",
    "lower{{{t}}},fuse-epilogue,grid{{vars=1}}",
    "lower{{{t}}},fuse-epilogue,grid{{vars=2}}",
]
SSD_PIPES = ATTN_PIPES[:3]

FLASH_SIZES = [
    pytest.param((8, 16, 4), (4, 4, 4), id="small"),
    pytest.param((16, 32, 8), (8, 8, 4), id="medium",
                 marks=pytest.mark.slow),
]
SSD_SIZES = [
    pytest.param((8, 2, 2), (4, 4, 4), id="small"),
    pytest.param((16, 2, 4), (8, 8, 8), id="medium",
                 marks=pytest.mark.slow),
]


# --------------------------------------------------------------------------
# the differential matrix
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dims,tile", FLASH_SIZES)
@pytest.mark.parametrize("sched", ATTN_PIPES)
def test_flash_matrix(dims, tile, sched):
    inputs, hand = _flash_case(*dims)
    _check_cell("flash", dims, inputs, hand, _pipe(sched, tile))


def test_flash_window_mask_is_data():
    inputs, hand = _flash_case(8, 16, 4, window=4)
    _check_cell("flash", (8, 16, 4), inputs, hand,
                _pipe(ATTN_PIPES[1], (4, 4, 4)))


@pytest.mark.parametrize("sched", [ATTN_PIPES[0], ATTN_PIPES[3]])
def test_decode_matrix(sched):
    """Per-(batch, kv group) slices of the port's decode_attention against
    the compiled graph, the cache's validity arriving as mask data."""
    B, KV, rep, smax, hd = 2, 2, 4, 16, 4
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, KV, rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, smax, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, smax, hd)).astype(np.float32)
    valid = np.array([smax, smax // 2 + 1], np.int32)
    hand = decode_attention(*(torch.from_numpy(x) for x in (q, k, v,
                                                             valid))).numpy()
    for b, g in ((0, 0), (1, 1)):
        inputs = [q[b, g] / np.sqrt(hd).astype(np.float32),
                  k[b, g].T.copy(), v[b, g],
                  cases.attn_mask(rep, smax, causal=False, valid=valid[b])]
        _check_cell("decode", (rep, smax, hd), inputs, hand[b, g],
                    _pipe(sched, (4, 4, 4)))


@pytest.mark.parametrize("dims,tile", SSD_SIZES)
@pytest.mark.parametrize("sched", SSD_PIPES)
def test_ssd_matrix(dims, tile, sched):
    inputs, hand = _ssd_case(*dims, head=1, chunk=dims[0] // 2)
    _check_cell("ssd", dims, inputs, hand, _pipe(sched, tile))


# --------------------------------------------------------------------------
# refusals and stages, by analysis
# --------------------------------------------------------------------------


@pytest.mark.parametrize("epilogue", ["none", "relu", "bias_relu"])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("schedule", ref_pipeline.SCHEDULES)
def test_gemm_refusals_and_stages_match_the_reference(schedule, n,
                                                      epilogue):
    """The port emits a kernel exactly where the reference does: the GEMM
    template for the contraction schedules, the general stages for
    ``nested`` / ``inner_flattened`` at 4 and 8, and nothing at 16 (a
    stage over 4096 traced statements)."""
    ck = compile_gemm(n, n, n, schedule=schedule, epilogue=epilogue,
                      device="cpu", want_torch=False)
    rck = ref_pipeline.compile_gemm(n, n, n, schedule=schedule,
                                    epilogue=epilogue, want_jax=False)
    assert (ck.run_cuda is None) == (rck.run_pallas is None)
    if ck.run_cuda is None:
        with pytest.raises(backend_cuda.EmitError, match="4096|trace"):
            backend_cuda.emit(ck.kernel, device="cpu")
        return
    general = rck.run_pallas.plan is None
    assert (ck.run_cuda.plan is None) == general
    if general:
        _same_stages(ck.run_cuda, rck.run_pallas)


GRID1 = "lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue,grid{vars=1}"
GRID2 = "lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue,grid{vars=2}"
# per stage: the reference's Pallas grid, then the launch layout: the loops
# spread over blocks and the parts each tile's rows are cut into
FULL = [("flash_attention_graph", (2048, 2048, 128), GRID2,
         [[16, 16], [], [], [], []],
         [([], 1), (["i7"], 16), (["e10", "e11"], 1), (["i14"], 16),
          (["i17", "j18"], 16)]),
        ("flash_attention_graph", (4096, 4096, 256), GRID2,
         [[32, 32], [], [], [], []],
         [([], 1), (["i7"], 8), (["e10", "e11"], 1), (["i14"], 8),
          (["i17", "j18"], 4)]),
        ("decode_attention_graph", (7, 161, 128), GRID2,
         [[1, 7], [], [], [], []],
         [([], 1), (["i7"], 1), (["e10", "e11"], 1), (["i14"], 1),
          (["i17", "j18"], 1)]),
        ("ssd_scan_graph", (4096, 64, 128), GRID1, [[64], [], []],
         [([], 1), (["e4", "e5"], 1), (["i6", "j7"], 8)])]


@pytest.mark.parametrize("graph,dims,pipe,grids,layouts", FULL,
                         ids=["qwen2-7b", "gemma3-4b", "decode", "mamba2"])
def test_full_width_stages_match_the_reference(graph, dims, pipe, grids,
                                               layouts):
    """The chip smoke's four graphs at full width, by analysis only: both
    emitters accept them and cut them into the same stages with the same
    Pallas grids.  On the card every nest after the first spreads its
    outer loops over blocks, a matmul or reduction nest is cut by rows as
    well, each stage launches the grid's programs times the spread loops'
    iterations times the parts, the flash P V and SSD (h.C) G stages at
    least 128 blocks, and every temporary is written whole before it is
    read, so none is filled first."""
    ck = compile_traced(getattr(fe, graph)(*dims), pipeline=pipe,
                        device="cpu", want_torch=False)
    rck = ref_pipeline.compile_traced(getattr(ref_fe, graph)(*dims),
                                      pipeline=pipe, want_jax=False)
    _same_stages(ck.run_cuda, rck.run_pallas)
    stages = ck.run_cuda.stages
    assert [list(s.grid) for s in stages] == grids
    assert [(s.spread_vars, s.parts) for s in stages] == layouts
    assert all(st.programs == int(np.prod(st.grid)) * int(np.prod(st.spread))
               * st.parts for st in stages)
    if graph != "decode_attention_graph":
        assert stages[-1].programs >= 128
    assert all(st.covered == set(st.writes) for st in stages)


@pytest.mark.parametrize("pipe,refused", [
    ("lower{tile_m=128,tile_n=128,tile_k=128}", False),
    ("lower{tile_m=128,tile_n=128,tile_k=128},fuse-epilogue", True)],
    ids=["unfused", "fused"])
def test_gemma_width_without_a_grid(pipe, refused):
    """flash 4096 x 4096 x 256 without ``grid``, by analysis only (no
    inputs): unfused, every nest traces at most 4096 statements; fused,
    stage 1 traces 5120, and both emitters refuse it."""
    ck = compile_traced(fe.flash_attention_graph(4096, 4096, 256),
                        pipeline=pipe, device="cpu", want_torch=False)
    rck = ref_pipeline.compile_traced(
        ref_fe.flash_attention_graph(4096, 4096, 256), pipeline=pipe,
        want_jax=False)
    assert (ck.run_cuda is None) == (rck.run_pallas is None) == refused
    if refused:
        with pytest.raises(backend_cuda.EmitError, match="5120 statements"):
            backend_cuda.emit_general(ck.kernel, device="cpu")
    else:
        _same_stages(ck.run_cuda, rck.run_pallas)


def test_emit_dispatch_keeps_the_gemm_template_first():
    """A contraction the classifier takes gets the GEMM template (its own
    launch counter), in every element type the reference emits (f16 here,
    which the template once refused); a contraction whose tiles the
    template cannot index (a rank-3 lhs tile, which the reference's GEMM
    emitter reads as jnp.dot does) goes to the general path, which sums
    the same k tiles in the same order."""
    ck = compile_gemm(16, 16, 16, schedule="tpu_mxu", device="cpu")
    assert ck.run_cuda.plan is not None and not hasattr(ck.run_cuda,
                                                        "stages")
    g = fe.trace(lambda a, b: fe.matmul(a, b),
                 [fe.spec((16, 16), "float16"), fe.spec((16, 16), "float16")],
                 name="mm_f16")
    ck = compile_traced(g, schedule="tpu_mxu", device="cpu")
    rck = ref_pipeline.compile_traced(
        ref_fe.trace(lambda a, b: ref_fe.matmul(a, b),
                     [ref_fe.spec((16, 16), "float16"),
                      ref_fe.spec((16, 16), "float16")], name="mm_f16"),
        schedule="tpu_mxu", want_jax=False)
    assert ck.run_cuda.plan is not None and rck.run_pallas is not None
    assert "launch<16, 16, 16, false, __half, __half, float>" in \
        ck.run_cuda.source
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((16, 16)).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(ck.run_cuda(*xs).numpy(),
                               np.asarray(rck.run_pallas(*xs)), **TOL)
    fn, rfn = _both(cases.rank3_text((1,), "grid"))
    assert rfn.plan is not None and fn.plan is None and fn.stages
    with pytest.raises(backend_cuda.EmitError, match="rank other than 2"):
        backend_cuda._emit_gemm(ir_text.parse_ir(
            cases.rank3_text((1,), "grid")), device="cpu")


def _placement(fn):
    """Where each repaired kernel went: the GEMM template's route on the
    CPU inputs' strides, or the general path."""
    return "gemm" if fn.plan is not None else "general"


@pytest.mark.parametrize("case", sorted(cases.REPAIRS))
def test_port_only_refusals(case):
    """Each kernel the port once refused where the reference did not
    (ROADMAP C: f16, int32 and int8 elements in both emitters; scratch
    above a block's 227 KB; rank-3 matmul tiles; the GEMM template's
    epilogue layouts other than (N,) or (M, N) and grids that cover part
    of the problem) has a kernel in both packages now, in the same
    emitter, and the port's plain version, which CPU tensors run, agrees
    with the reference's Pallas kernel in interpret mode within 1e-4, its
    dtype and its unwritten elements included."""
    text, inputs = cases.REPAIRS[case]
    fn, rfn = _both(text())
    assert fn is not None and rfn is not None
    assert _placement(fn) == ("general" if case == "rank3_gemm" else
                              "gemm" if rfn.plan is not None else "general")
    xs = inputs(np.random.default_rng(0))
    want = np.asarray(rfn(*xs))
    launches = (backend_cuda.emit_general.launches, gemm.cuda_gemm.launches)
    got = fn(*xs)
    assert (backend_cuda.emit_general.launches,
            gemm.cuda_gemm.launches) == launches        # plain on CPU
    assert str(got.dtype).split(".")[1] == want.dtype.name
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               **TOL)
    if case == "big_scratch":
        # the 256 KB accumulator in the block's global workspace, the
        # 1 KB carry in shared memory
        st = fn.stages[0]
        assert st.ws_bytes == 256 * 256 * 4 and st.ws_blocks == 1
        assert "wsp" in fn.source


def test_row_split_keeps_scratch_in_shared_memory():
    """A 256 x 256 matmul accumulator is row-local: each block keeps only
    its part's rows, so it fits in shared memory and needs no
    workspace."""
    g = fe.trace(lambda a, b: fe.exp(fe.matmul(a, b)),
                 [fe.spec((256, 256)), fe.spec((256, 256))], name="big")
    k = PassManager.parse("lower{tile_m=256,tile_n=256,tile_k=4}") \
        .run(g).artifact
    st = backend_cuda.emit_general(k, device="cpu").stages[0]
    assert (st.parts, [b.shape for b in st.block_scratch]) == (32, [(8, 256)])
    assert st.ws_bytes == 0


@pytest.mark.parametrize("dtypes,want", [
    (("float32",), "float32"), (("bfloat16", "float32"), "float32"),
    (("bfloat16", "float16"), "float32"), (("int32", "float16"), "float16"),
    (("int8", "bfloat16"), "bfloat16"), (("int8", "int32"), "int32"),
    (("int8",), "int8")])
def test_promotion_is_the_references(dtypes, want):
    """The stage and epilogue renderers type each value by JAX's
    promotion lattice over TensorIR's five types."""
    import jax.numpy as jnp
    assert backend_cuda._promote(*dtypes) == want
    assert jnp.result_type(*(getattr(jnp, d) for d in dtypes)).name == want


# --------------------------------------------------------------------------
# every statement and op through the plain version
# --------------------------------------------------------------------------


def _both(text):
    return (backend_cuda.emit(ir_text.parse_ir(text), device="cpu"),
            backend_pallas.emit(ref_ir_text.parse_ir(text), interpret=True))


@pytest.mark.parametrize("case", ["all_ops", "alias", "partial"])
def test_every_statement_through_the_plain_version(case):
    """general_plain against the reference's Pallas stages: every
    elementwise op, ``ones``, ``copy1``, a ``cast`` to bf16, both scans
    and both reductions; statements that write their own operands; and a
    stage that reads its own fresh output and writes part of another (NaN
    in both where nothing was written)."""
    text, nin = cases.TEXT_CASES[case]
    fn, rfn = _both(text())
    _same_stages(fn, rfn)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((8, 8)).astype(np.float32)
          for _ in range(nin)]
    want = np.asarray(rfn(*xs)).astype(np.float32)
    out = fn(*xs)
    got = out.float().numpy()
    np.testing.assert_array_equal(
        got, backend_cuda.general_plain(fn, *xs).float().numpy())
    if case == "all_ops":
        # the bf16 output rounds f32 values that may differ within 1e-4,
        # so a value may land one bf16 step (2^-7 of it at most) away
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-4)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if case == "partial":
        assert np.isnan(got).all()      # half never written, half NaN + x
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               **TOL)


@pytest.mark.parametrize("sched", SSD_PIPES)   # its first nest is a reduction
def test_bf16_graph_matches_the_reference(sched):
    """bf16 buffers, a bf16 scratch accumulator and bf16 arithmetic: the
    port rounds where the reference does.  Both compute each bf16 value in
    f32 and round it, but may sum in another order and so round a value
    one bf16 step apart, which the chain carries on: held to
    tests/test_kernels.py's bf16 bound."""
    pipe = _pipe(sched, (4, 4, 4))
    ck = compile_traced(cases.bf16_graph(fe, 8), pipeline=pipe,
                        device="cpu", want_torch=False)
    rck = ref_pipeline.compile_traced(cases.bf16_graph(ref_fe, 8),
                                      pipeline=pipe, want_jax=False)
    assert (ck.run_cuda is None) == (rck.run_pallas is None) is False
    _same_stages(ck.run_cuda, rck.run_pallas)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(3)]
    got = ck.run_cuda(*xs)
    assert got.dtype == torch.bfloat16
    want = np.asarray(rck.run_pallas(*xs)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL_BF16,
                               atol=TOL_BF16)
    np.testing.assert_allclose(got.float().numpy(), ck.run_ref(*xs)[0]
                               .astype(np.float32), rtol=TOL_BF16,
                               atol=TOL_BF16)


def test_plain_version_runs_without_touching_the_counters():
    inputs, _ = _flash_case(8, 16, 4)
    ck = compile_traced(fe.flash_attention_graph(8, 16, 4),
                        pipeline=_pipe(ATTN_PIPES[3], (4, 4, 4)),
                        device="cpu", want_torch=False)
    before = (backend_cuda.emit_general.launches, gemm.cuda_gemm.launches)
    ck.run_cuda(*inputs)
    assert (backend_cuda.emit_general.launches,
            gemm.cuda_gemm.launches) == before
    assert "__global__" in ck.run_cuda.source
    assert ck.run_cuda.source.count("extern \"C\" int stagecc_stage") == 5


# --------------------------------------------------------------------------
# the launch layout: spread loops and row splits, on the CPU
# --------------------------------------------------------------------------


def _blocks_plain(stage, env):
    """The stage as the card runs it: every block of its launch layout
    through ``_run_plain`` with its own statements (rows cut to its part)
    and fresh zeroed scratch, the last block first."""
    outs = backend_cuda._fresh(stage, torch.device("cpu"))
    hbm = {**{n: env[n] for n in stage.params if n not in outs}, **outs}
    names = [v for v, _ in stage.launch_vars]
    blocks = list(itertools.product(*(range(e)
                                      for _, e in stage.launch_vars)))
    assert len(blocks) == stage.programs
    for pid in reversed(blocks):
        mem = dict(hbm)
        mem.update({b.name: torch.zeros(b.shape, dtype=backend_cuda
                                        ._TORCH_DTYPE[b.type.dtype])
                    for b in stage.block_scratch})
        backend_cuda._run_plain(stage.body, dict(zip(names, pid)), mem, "cpu")
    env.update(outs)


def _blocks_match_stage_plain(fn, xs):
    """Every stage's blocks, last first, against ``stage_plain``: the same
    bits, NaN where it has NaN."""
    env, blocks = fn.environment(*xs), fn.environment(*xs)
    for st in fn.stages:
        backend_cuda.stage_plain(st, env)
        _blocks_plain(st, blocks)
        for n in st.writes:
            torch.testing.assert_close(blocks[n], env[n], rtol=0, atol=0,
                                       equal_nan=True)
    return env[fn.out_name]


SPLIT_GRAPHS = [
    ("flash_attention_graph", (32, 32, 8), (16, 16, 8), ATTN_PIPES),
    ("flash_attention_graph", (32, 64, 8), (16, 16, 16), ATTN_PIPES),
    ("decode_attention_graph", (4, 16, 4), (4, 4, 4), ATTN_PIPES),
    ("ssd_scan_graph", (32, 2, 4), (16, 16, 8), SSD_PIPES),
]


@pytest.mark.parametrize("graph,dims,tile,sched", [
    pytest.param(g, d, t, p, id=f"{g.split('_')[0]}-{'x'.join(map(str, d))}"
                 f"-{i}")
    for g, d, t, ps in SPLIT_GRAPHS for i, p in enumerate(ps)])
def test_blocks_in_reverse_equal_the_plain_version(graph, dims, tile, sched):
    """Spread and row-split stages, their blocks run last first, each with
    fresh zeroed scratch, give ``stage_plain``'s bits; at 16-row tiles the
    later flash nests spread and split."""
    ck = compile_traced(getattr(fe, graph)(*dims),
                        pipeline=_pipe(sched, tile), device="cpu",
                        want_torch=False)
    stages = ck.run_cuda.stages
    if tile[0] == 16 and graph == "flash_attention_graph":
        assert stages[-1].spread_vars and stages[-1].parts == 2
    if graph == "ssd_scan_graph":
        inputs, _ = _ssd_case(*dims, head=1, chunk=dims[0] // 2)
    elif graph == "flash_attention_graph":
        inputs, _ = _flash_case(*dims)
    else:
        _, inputs = cases.flash_inputs(*dims, seed=3)
    got = _blocks_match_stage_plain(ck.run_cuda,
                                    [torch.from_numpy(x) for x in inputs])
    oracle = (_scan_oracle(*inputs) if graph == "ssd_scan_graph"
              else _softmax_oracle(*inputs))
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


@pytest.mark.parametrize("case", sorted(cases.TEXT_CASES)
                         + sorted(cases.NOT_SPREAD) + sorted(cases.ROW_SPLIT))
def test_hand_written_blocks_in_reverse(case):
    """The hand-written kernels (every statement, aliasing, partial writes
    and early reads, the nests that must not spread or split): their
    blocks, last first, give ``stage_plain``'s bits."""
    if case in cases.TEXT_CASES:
        text, nin = cases.TEXT_CASES[case]
        text, shape = text(), (8, 8)
    else:
        text = cases.NOT_SPREAD.get(case) or cases.ROW_SPLIT[case][0]
        nin, shape = 2, None
    fn = backend_cuda.emit(ir_text.parse_ir(text), device="cpu")
    rng = np.random.default_rng(0)
    params = [b for b in ir_text.parse_ir(text).params][:nin]
    xs = [torch.from_numpy(rng.standard_normal(shape or b.shape)
                           .astype(np.float32)) for b in params]
    _blocks_match_stage_plain(fn, xs)


@pytest.mark.parametrize("case", sorted(cases.NOT_SPREAD))
def test_nests_that_must_not_spread(case):
    """A reduction or a matmul carried across iterations, scratch read
    before the iteration writes it, an HBM tile every iteration writes,
    a tile another iteration writes, a scan along the loop: the loop is
    not spread, and the nest runs as one block."""
    fn = backend_cuda.emit_general(ir_text.parse_ir(cases.NOT_SPREAD[case]),
                                   device="cpu")
    (st,) = fn.stages
    assert backend_cuda._spread_reason(st.inner[0]) is not None
    assert (st.spread_vars, st.parts, st.programs) == ([], 1, 1)


@pytest.mark.parametrize("case", sorted(cases.ROW_SPLIT))
def test_row_split_only_where_every_statement_is_row_local(case):
    """Fill, reduce along the columns, a (rows, 1) column operand and a
    matmul by its rows split a 16-row nest into two blocks of 8 rows; an
    operand broadcast along the rows, a scan down the rows or a matmul
    whose right operand the nest writes do not."""
    text, parts = cases.ROW_SPLIT[case]
    fn = backend_cuda.emit_general(ir_text.parse_ir(text), device="cpu")
    (st,) = fn.stages
    assert (st.parts, st.programs) == (parts, parts)
    if parts > 1:
        assert st.threads == 256 and st.rows == 16
        # the block's accumulator holds its own 8 rows only
        assert [b.shape for b in st.block_scratch] == [(8, 1)]
        assert "row split 16 rows in 2 parts: 2 blocks" in fn.source


def test_fills_only_where_the_caller_could_see_them():
    """Fresh outputs start as NaN only where a block may read or leave an
    element unwritten: in ``partial`` the half-written output and the
    buffer read before its write keep the fill on the kernels' path, the
    wholly written temporary does not; and the environment holds zeros
    only for what a stage reads before any stage writes it."""
    fn = backend_cuda.emit(ir_text.parse_ir(cases.PARTIAL), device="cpu")
    assert [st.covered for st in fn.stages] == [{"t"}, set()]
    fresh = backend_cuda._fresh(fn.stages[1], torch.device("cpu"),
                                fill=False)
    assert all(bool(t.isnan().all()) for t in fresh.values())
    env = fn.environment(np.ones((8, 8), np.float32))
    assert sorted(env) == ["arg0"]
    ck = compile_traced(fe.flash_attention_graph(8, 16, 4),
                        pipeline=_pipe(ATTN_PIPES[3], (4, 4, 4)),
                        device="cpu", want_torch=False)
    inputs, _ = _flash_case(8, 16, 4)
    assert sorted(ck.run_cuda.environment(*inputs)) == [
        "arg0", "arg1", "arg2", "arg3"]
    # with the mask not passed, the graph reads zeros for it
    assert sorted(ck.run_cuda.environment(*inputs[:3])) == [
        "arg0", "arg1", "arg2", "arg3"]
