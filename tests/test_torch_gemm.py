"""The port's compiled GEMM against the JAX package's, on the CPU.

On CPU tensors the emitted CUDA callable (``run_cuda``) runs
``gemm_plain``, the plain PyTorch version of the kernel's arithmetic; the
reference runs its emitted Pallas kernel in interpret mode.  Both are
held to ``tests/test_kernels.py``'s bounds, and to ``bracket``: the range
that every run of the plan's arithmetic lands in, whatever order it sums
each k tile in.  The CUDA kernel itself is held against ``gemm_plain`` on
a GPU, in test_torch_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.core.frontend as ref_fe
from repro.core import integrate as ref_integrate
from repro.kernels import ops as ref_ops
import repro_torch.core as core
import repro_torch.core.frontend as fe
from repro_torch.core import backend_cuda, integrate
from repro_torch.kernels import gemm, ops

# tests/test_kernels.py:17-18 and its bounds (rtol, atol) for f32 and bf16
SHAPES = [(128, 128, 128), (256, 128, 64), (64, 192, 256), (96, 96, 96)]
TOLS = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-1)}
TOL_GRAD = 1e-4


def _tile(m, n, k):
    return {"m": gemm._pick_tile(m), "n": gemm._pick_tile(n),
            "k": gemm._pick_tile(k)}


def _inputs(m, n, k, epilogue, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((m, k)).astype(np.float32),
          rng.standard_normal((k, n)).astype(np.float32)]
    if epilogue == "bias_relu":
        xs.append(rng.standard_normal(n).astype(np.float32))
    return xs


def _held(got, want, lo, hi, dtype):
    rtol, atol = TOLS[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert (got >= lo).all() and (got <= hi).all()
    assert (want >= lo).all() and (want <= hi).all()


@pytest.mark.parametrize("schedule,dtype,epilogue", list(itertools.product(
    ("tpu_mxu", "tpu_mxu_kgrid"), ("float32", "bfloat16"),
    ("none", "relu", "bias_relu"))))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas(shape, schedule, dtype, epilogue):
    m, n, k = shape
    kw = dict(schedule=schedule, dtype=dtype, epilogue=epilogue,
              tile=_tile(m, n, k))
    want_ck = ref_core.compile_gemm(m, n, k, want_jax=False, **kw)
    ck = core.compile_gemm(m, n, k, device="cpu", want_torch=False, **kw)
    xs = _inputs(m, n, k, epilogue, seed=sum(shape))
    want = np.asarray(want_ck.run_pallas(*xs)).astype(np.float32)
    got = ck.run_cuda(*xs)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    ts = [torch.from_numpy(x) for x in xs]
    ts[:2] = [t.to(backend_cuda._TORCH_DTYPE[dtype]) for t in ts[:2]]
    lo, hi = backend_cuda.bracket(ck.run_cuda.plan, *ts)
    _held(got.numpy(), want, lo.numpy(), hi.numpy(), dtype)


def _bf16_out_graph(frontend, m, n, k, epilogue):
    """A GEMM whose TensorIR matmul accumulates in bf16 (``acc_dtype``), so
    that its output, and the k-grid schedule's running sum, are bf16."""
    def f(a, b, *bias):
        y = a._emit("matmul", [b], acc_dtype="bfloat16")
        return frontend.relu(y + bias[0]) if bias else y
    specs = [frontend.spec((m, k), "bfloat16"),
             frontend.spec((k, n), "bfloat16")]
    if epilogue == "bias_relu":
        specs.append(frontend.spec((n,), "float32"))
    return frontend.trace(f, specs, name=f"gemm_bf16_{epilogue}")


@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_bf16_output_rounds_where_the_reference_does(schedule, epilogue):
    """With a bf16 output the k-grid schedule rounds its running sum after
    every k tile.  The plain version must land in the bracket of those
    roundings, bit for bit wherever no rounding boundary is near, and
    agree with the reference's Pallas kernel as closely."""
    m, n, k = 64, 96, 512
    tile = {"m": 32, "n": 32, "k": 64}
    want_ck = ref_core.compile_traced(
        _bf16_out_graph(ref_fe, m, n, k, epilogue), schedule=schedule,
        tile=tile, want_jax=False)
    ck = core.compile_traced(_bf16_out_graph(fe, m, n, k, epilogue),
                             schedule=schedule, tile=tile, device="cpu",
                             want_torch=False)
    xs = _inputs(m, n, k, epilogue, seed=7)
    want = np.asarray(want_ck.run_pallas(*xs)).astype(np.float32)
    got = ck.run_cuda(*xs)
    assert got.dtype == torch.bfloat16
    ts = [torch.from_numpy(x) for x in xs]
    ts[:2] = [t.to(torch.bfloat16) for t in ts[:2]]
    lo, hi = backend_cuda.bracket(ck.run_cuda.plan, *ts)
    _held(got.float().numpy(), want, lo.numpy(), hi.numpy(), "bfloat16")
    # most elements have a single possible value, and there both agree
    exact = (lo == hi).numpy()
    assert exact.mean() > 0.5
    np.testing.assert_array_equal(got.float().numpy()[exact], want[exact])


def test_kgrid_rounding_is_not_the_f32_sum():
    """A plain version that summed the k tiles in f32 and rounded once
    would leave the bracket: it is the per-tile rounding that is held."""
    m, n, k = 64, 96, 512
    ck = core.compile_traced(_bf16_out_graph(fe, m, n, k, "none"),
                             schedule="tpu_mxu_kgrid",
                             tile={"m": 32, "n": 32, "k": 64}, device="cpu",
                             want_torch=False)
    a, b = [torch.from_numpy(x).to(torch.bfloat16)
            for x in _inputs(m, n, k, "none", seed=7)]
    lo, hi = backend_cuda.bracket(ck.run_cuda.plan, a, b)
    once = (a.float() @ b.float()).to(torch.bfloat16).float()
    assert ((once < lo) | (once > hi)).float().mean() > 0.1


def test_ops_matmul_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96, 48)).astype(np.float32)
    want = np.asarray(ref_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                                     backend="pallas"))
    before = gemm.cuda_gemm.launches
    for backend in ops.BACKENDS:
        got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                         backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert gemm.cuda_gemm.launches == before     # CPU tensors: no launch
    with pytest.raises(ValueError):
        ops.matmul(torch.from_numpy(a), torch.from_numpy(b), backend="xla")


@pytest.mark.parametrize("backend", integrate.BACKENDS)
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_op_gradients_match_jax(schedule, backend):
    m, n, k = 32, 48, 64
    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal(s).astype(np.float32)
            for s in ((m, k), (k, n)))
    w = rng.standard_normal((m, n)).astype(np.float32)

    op_ref = ref_integrate.gemm_op(m, n, k, schedule=schedule,
                                   backend="pallas")
    loss = lambda x, y: jnp.sum(op_ref(x, y) * w)
    want_a, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                                    jnp.asarray(b))

    op = integrate.gemm_op(m, n, k, schedule=schedule, backend=backend)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = op(ta, tb)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(op_ref(a, b)), rtol=TOL_GRAD,
                               atol=TOL_GRAD)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_a),
                               rtol=TOL_GRAD, atol=TOL_GRAD)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b),
                               rtol=TOL_GRAD, atol=TOL_GRAD)


@pytest.mark.parametrize("schedule", ["nested", "inner_flattened"])
def test_no_cuda_emission_outside_the_contraction_subset(schedule):
    ck = core.compile_gemm(16, 16, 16, schedule=schedule, device="cpu")
    assert ck.run_cuda is None and ck.run_torch is not None
    with pytest.raises(backend_cuda.EmitError):
        backend_cuda.emit(ck.kernel)
    with pytest.raises(ValueError, match="no cuda emission"):
        integrate.gemm_op(16, 16, 16, schedule=schedule, backend="cuda")


def test_numpy_inputs_go_to_the_device_asked_for():
    """No fallback hides the device: a compile for "cuda" sends numpy
    inputs there, which fails on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ck = core.compile_gemm(16, 16, 16, schedule="tpu_mxu")
    xs = _inputs(16, 16, 16, "none", seed=0)
    for fn in (ck.run_cuda, ck.run_torch):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*xs)


def test_products_that_share_tiles_share_one_source():
    """M, N and K are runtime arguments of the emitted kernel: qwen2-7b's
    up and down MLP products render to one CUDA text."""
    up = core.compile_gemm(512, 18944, 3584, schedule="tpu_mxu_kgrid",
                           device="cpu", want_torch=False)
    down = core.compile_gemm(512, 3584, 18944, schedule="tpu_mxu_kgrid",
                             device="cpu", want_torch=False)
    src = up.run_cuda.source
    assert src == down.run_cuda.source
    assert "launch<128, 128, 128, true, float, float, float>" in src
    bf = core.compile_gemm(96, 96, 96, schedule="tpu_mxu", dtype="bfloat16",
                           epilogue="bias_relu", device="cpu",
                           tile={"m": 96, "n": 96, "k": 96},
                           want_torch=False).run_cuda.source
    assert ("launch<96, 96, 96, false, __nv_bfloat16, __nv_bfloat16, "
            "float>") in bf
    assert "in0[col]" in bf and "fmaxf(" in bf


# every elementwise op the emitters take, fused as the epilogue of the
# product y = a @ b.  The ops that need a positive operand get positive a
# and b (so y is far from 0, where rsqrt would magnify the sum order),
# and the binary ones take an (M, N) input q >= 1.
UNARY = ("relu", "gelu", "exp", "neg", "tanh", "sigmoid", "abs")
POSITIVE = ("sqrt", "rsqrt", "log1p")
BINARY = ("add", "sub", "mul", "div", "maximum")


def epilogue_graph(frontend, op, m=32, n=48, k=64):
    def f(a, b, *q):
        return frontend.matmul(a, b)._emit(op, list(q))
    specs = [frontend.spec((m, k)), frontend.spec((k, n))]
    specs += [frontend.spec((m, n))] if op in BINARY else []
    return frontend.trace(f, specs, name=f"gemm_{op}")


def epilogue_inputs(op, m=32, n=48, k=64, seed=5):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((m, k)), rng.standard_normal((k, n)) / 8]
    if op in POSITIVE:
        xs = [np.abs(x) for x in xs]
    if op in BINARY:
        xs.append(1 + np.abs(rng.standard_normal((m, n))))
    return [x.astype(np.float32) for x in xs]


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
@pytest.mark.parametrize("op", UNARY + POSITIVE + BINARY)
def test_every_epilogue_op_matches_pallas(op, schedule):
    tile = {"m": 16, "n": 16, "k": 32}
    want_ck = ref_core.compile_traced(epilogue_graph(ref_fe, op),
                                      schedule=schedule, tile=tile,
                                      want_jax=False)
    ck = core.compile_traced(epilogue_graph(fe, op), schedule=schedule,
                             tile=tile, device="cpu", want_torch=False)
    assert want_ck.run_pallas.plan is not None      # the GEMM emitter's
    xs = epilogue_inputs(op)
    want = np.asarray(want_ck.run_pallas(*xs))
    got = ck.run_cuda(*xs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
