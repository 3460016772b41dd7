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
FULL = [("flash_attention_graph", (2048, 2048, 128), GRID2,
         [[16, 16], [], [], [], []]),
        ("flash_attention_graph", (4096, 4096, 256), GRID2,
         [[32, 32], [], [], [], []]),
        ("decode_attention_graph", (7, 161, 128), GRID2,
         [[1, 7], [], [], [], []]),
        ("ssd_scan_graph", (4096, 64, 128), GRID1, [[64], [], []])]


@pytest.mark.parametrize("graph,dims,pipe,grids", FULL,
                         ids=["qwen2-7b", "gemma3-4b", "decode", "mamba2"])
def test_full_width_stages_match_the_reference(graph, dims, pipe, grids):
    """The chip smoke's four graphs at full width, by analysis only: both
    emitters accept them and cut them into the same stages."""
    ck = compile_traced(getattr(fe, graph)(*dims), pipeline=pipe,
                        device="cpu", want_torch=False)
    rck = ref_pipeline.compile_traced(getattr(ref_fe, graph)(*dims),
                                      pipeline=pipe, want_jax=False)
    _same_stages(ck.run_cuda, rck.run_pallas)
    assert [list(s.grid) for s in ck.run_cuda.stages] == grids
    assert all(st.programs == int(np.prod(st.grid))
               for st in ck.run_cuda.stages)


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
    launch counter); a contraction the template refuses gets no kernel,
    not the general path."""
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
    # a port-only refusal (the template's element types)
    assert ck.run_cuda is None and rck.run_pallas is not None
    with pytest.raises(backend_cuda.EmitError, match="float16"):
        backend_cuda.emit(ck.kernel, device="cpu")


def test_port_only_refusals():
    """Element types other than f32 / bf16 and scratch beyond a block's
    shared memory refuse in the port alone (ROADMAP C)."""
    g = fe.trace(lambda a: fe.exp(a), [fe.spec((8, 8), "float16")],
                 name="exp_f16")
    k = PassManager.parse("lower{tile_m=4,tile_n=4,tile_k=4}").run(g) \
        .artifact
    with pytest.raises(backend_cuda.EmitError, match="float16"):
        backend_cuda.emit_general(k, device="cpu")
    # a 256 x 256 f32 accumulator (256 KB) exceeds a block's 227 KB
    g = fe.trace(lambda a, b: fe.exp(fe.matmul(a, b)),
                 [fe.spec((256, 256)), fe.spec((256, 256))], name="big")
    k = PassManager.parse("lower{tile_m=256,tile_n=256,tile_k=4}") \
        .run(g).artifact
    with pytest.raises(backend_cuda.EmitError, match="shared memory"):
        backend_cuda.emit_general(k, device="cpu")


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
