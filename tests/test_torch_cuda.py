"""The port's CUDA kernels (hand-written, and emitted by the compiler)
against their plain versions, on a GPU.  Every test here is marked ``cuda`` and skips where no card is
present.  The file imports no JAX, so it runs on a machine with PyTorch
alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro_torch.core.frontend as fe
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import backend_cuda, compile_gemm, compile_traced
from repro_torch.core import integrate, ir_text
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import gemm
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import Engine, EngineConfig

import _torch_stage_cases as stage_cases

TOL, TOL_BF16 = 2e-5, 5e-2      # tests/test_kernels.py's bounds
# bf16 output rounding: half a bf16 ulp, at most 2^-8 of the value, over
# the plain version in f32 on the same bf16 inputs (the kernel's
# statistics are f32, so it rounds once, at the output)
BF16_ROUND = 2.0 ** -8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain GEMM's f32 products must be full f32, as PyTorch's default
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _inputs(dev, dtype, B, KV, rep, hd, Smax, valid, seed=0):
    """q and a (B, Smax, KV, hd) cache read through transposed views, as
    the model passes them."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd))).to(dev, dtype)
    cache = torch.from_numpy(rng.standard_normal((2, B, Smax, KV, hd)))
    cache = cache.to(dev, dtype)
    valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    return q, cache[0].transpose(1, 2), cache[1].transpose(1, 2), valid


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("shape,valid,block_k", [
    ((4, 4, 7, 128, 161), [0, 1, 129, 161], 256),   # the serving smoke's
    ((3, 2, 4, 32, 512), [17, 256, 511], 128),      # several tiles
    ((2, 1, 9, 64, 96), [96, 40], 32),              # rep above one chunk
    ((1, 2, 2, 256, 64), [70, ], 64),               # hd 256, valid > Smax
    ((2, 2, 7, 128, 300), [257, 300], 150),         # partial last tile
])
def test_kernel_matches_plain(cuda, dtype, tol, shape, valid, block_k):
    q, k, v, valid = _inputs(cuda, dtype, *shape, valid)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, valid, block_k=block_k)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = da.decode_attention_ref(q, k, v, valid)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        want32 = da.decode_attention_ref(q.float(), k.float(), v.float(),
                                         valid)
        assert ((got.float() - want32).abs()
                <= BF16_ROUND * want32.abs() + TOL).all()


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, valid = _inputs(cuda, torch.float32, 1, 1, 2, 16, 32, [4])
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, v, valid.long())
    wide = torch.zeros((1, 1, 32, 32), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        da.decode_attention(q, wide, wide, valid)


def _models(cuda):
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), num_heads=14,
                              num_kv_heads=2, head_dim=8)
    m = Model(cfg, RunConfig(backend="cuda"), cuda)
    plain = Model(cfg, RunConfig(backend="torch"), cuda)
    return cfg, m, plain, m.init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.parametrize("depth", [16, 300, 547])
def test_model_decode_runs_the_kernel(cuda, depth):
    """Cache depths of one tile, of tiles of 150 (300) and of tiles of 1
    (the prime 547)."""
    cfg, m, plain, params = _models(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    c1, c2 = m.cache_init(2, depth), plain.cache_init(2, depth)
    m.apply(params, toks[:, :8], cache=c1)
    plain.apply(params, toks[:, :8], cache=c2)
    before = da.decode_attention.launches
    a, _ = m.apply(params, toks[:, 8:], cache=c1)
    b, _ = plain.apply(params, toks[:, 8:], cache=c2)
    assert da.decode_attention.launches == before + cfg.num_layers
    assert (a - b).abs().max().item() < 1e-4


def test_engine_serves_past_one_tile(cuda):
    """max_len 300 (a 512-deep cache), decode reaching 291 valid
    positions: the kernel's greedy stream is the plain version's."""
    cfg, m, plain, params = _models(cuda)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 280)).astype(np.int32)
    before = da.decode_attention.launches
    got = Engine(m, params, EngineConfig(max_len=300)).generate(prompts, 12)
    assert da.decode_attention.launches == before + cfg.num_layers * 12
    want = Engine(plain, params, EngineConfig(max_len=300)).generate(
        prompts, 12)
    np.testing.assert_array_equal(got, want)


# ---- the compiler-emitted GEMM ----------------------------------------------

# tests/test_kernels.py's GEMM bound in f32.  compile_gemm's bf16 products
# have an f32 output (TensorIR's matmul accumulates in f32), so after the
# bf16 inputs nothing rounds coarser than f32 and the same bound holds.
GEMM_RTOL, GEMM_ATOL = 1e-4, 1e-3


def _gemm_inputs(dev, m, n, k, epilogue, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((m, k)), rng.standard_normal((k, n))]
    if epilogue == "bias_relu":
        xs.append(rng.standard_normal(n))
    return [torch.from_numpy(x).to(dev, torch.float32) for x in xs]


def _check_gemm(fn, xs, exact=False):
    """Launch ``fn`` once on ``xs``; hold it to gemm_plain and to the
    bracket of its roundings."""
    before = gemm.cuda_gemm.launches
    got = fn(*xs)
    torch.cuda.synchronize()
    assert gemm.cuda_gemm.launches == before + 1
    plan = fn.plan
    args = [x.to(backend_cuda._TORCH_DTYPE[plan.dtypes[n]])
            for n, x in zip(plan.in_buffers, xs)]
    want = backend_cuda.gemm_plain(plan, *args)
    lo, hi = backend_cuda.bracket(plan, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert ((got >= lo) & (got <= hi)).all()
    if exact:       # bf16 output: equal wherever only one value can be
        assert torch.equal(got[lo == hi], want[lo == hi])
    else:
        torch.testing.assert_close(got, want, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    return got


@pytest.mark.parametrize("schedule,dtype,epilogue", list(itertools.product(
    ("tpu_mxu", "tpu_mxu_kgrid"), ("float32", "bfloat16"),
    ("none", "relu", "bias_relu"))))
def test_gemm_kernel_matches_plain(cuda, schedule, dtype, epilogue):
    ck = compile_gemm(256, 384, 640, schedule=schedule, dtype=dtype,
                      epilogue=epilogue, want_torch=False)
    _check_gemm(ck.run_cuda, _gemm_inputs(cuda, 256, 384, 640, epilogue))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
@pytest.mark.parametrize("shape", [(96, 96, 96), (131, 96, 64),
                                   (64, 127, 257)])
def test_gemm_kernel_odd_tiles(cuda, schedule, shape):
    """cuda_gemm's tiles are the largest divisors up to 128: 96, and 1
    for a prime dimension (131, 127, 257)."""
    m, n, k = shape
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (x.to(dtype) for x in _gemm_inputs(cuda, m, n, k, "none"))
        ck = gemm._build(m, n, k, schedule, str(dtype)[6:],
                         gemm._pick_tile(m), gemm._pick_tile(n),
                         gemm._pick_tile(k))
        got = _check_gemm(ck.run_cuda, [a, b])
        assert torch.equal(got, gemm.cuda_gemm(a, b, schedule=schedule))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_kernel_reads_transposed_views(cuda, schedule):
    """The backward of gemm_op passes transposed views; the kernel reads
    them through their strides."""
    ck = compile_gemm(192, 320, 256, schedule=schedule, want_torch=False)
    rng = np.random.default_rng(3)
    at, bt = (torch.from_numpy(rng.standard_normal(s)).to(cuda,
                                                          torch.float32).t()
              for s in ((256, 192), (320, 256)))   # (192, 256), (256, 320)
    assert not at.is_contiguous() and not bt.is_contiguous()
    a, b = at.contiguous(), bt.contiguous()
    want = ck.run_cuda(a, b)
    for x, y in ((at, bt), (at, b), (a, bt)):
        # the order of the sums does not depend on how tiles are loaded
        assert torch.equal(_check_gemm(ck.run_cuda, [x, y]), want)


@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
def test_gemm_kernel_bf16_output(cuda, epilogue):
    """A matmul that accumulates in bf16: the k-grid kernel rounds its
    running sum after every k tile, as the reference does."""
    m, n, k = 128, 256, 1024

    def f(a, b, *bias):
        y = a._emit("matmul", [b], acc_dtype="bfloat16")
        return fe.relu(y + bias[0]) if bias else y
    specs = [fe.spec((m, k), "bfloat16"), fe.spec((k, n), "bfloat16")]
    specs += [fe.spec((n,), "float32")] if epilogue == "bias_relu" else []
    ck = compile_traced(fe.trace(f, specs, name="g"),
                        schedule="tpu_mxu_kgrid",
                        tile={"m": 64, "n": 128, "k": 128}, want_torch=False)
    got = _check_gemm(ck.run_cuda, _gemm_inputs(cuda, m, n, k, epilogue),
                      exact=True)
    assert got.dtype == torch.float32     # _check_gemm widened it


@pytest.mark.parametrize("op", ["relu", "gelu", "exp", "neg", "tanh",
                                "sigmoid", "abs", "sqrt", "rsqrt", "log1p",
                                "add", "sub", "mul", "div", "maximum"])
def test_gemm_kernel_every_epilogue_op(cuda, op):
    """Each op of the generated epilogue against the plain version's
    PyTorch op, the binary ones on an (M, N) input.  The products agree
    bit for bit, so only the ops' own last bits may differ."""
    m, n, k = 64, 96, 128
    binary = op in ("add", "sub", "mul", "div", "maximum")
    specs = [fe.spec((m, k)), fe.spec((k, n))]
    specs += [fe.spec((m, n))] if binary else []
    g = fe.trace(lambda a, b, *q: fe.matmul(a, b)._emit(op, list(q)),
                 specs, name=f"gemm_{op}")
    ck = compile_traced(g, schedule="tpu_mxu", tile={"m": 32, "n": 32,
                                                     "k": 64},
                        want_torch=False)
    a, b = _gemm_inputs(cuda, m, n, k, "none", seed=6)
    b = b / 8
    if op in ("sqrt", "rsqrt", "log1p"):       # positive, far from 0
        a, b = a.abs(), b.abs()
    xs = [a, b]
    if binary:
        xs.append(1 + _gemm_inputs(cuda, m, n, n, "none", seed=7)[0].abs())
    got = ck.run_cuda(*xs)
    want = backend_cuda.gemm_plain(ck.run_cuda.plan, *xs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_gemm_nested_schedule_has_no_kernel(cuda):
    assert compile_gemm(32, 32, 32, schedule="nested").run_cuda is None


def test_gemm_kernel_refuses_what_it_does_not_take(cuda):
    ck = compile_gemm(64, 64, 64, schedule="tpu_mxu", want_torch=False)
    a, b = _gemm_inputs(cuda, 64, 64, 64, "none")
    with pytest.raises(ValueError, match="several devices"):
        ck.run_cuda(a, b.cpu())
    with pytest.raises(ValueError, match="shape"):
        ck.run_cuda(a[:32], b)


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_op_gradients_on_the_card(cuda, schedule):
    """Forward and backward are three emitted-GEMM launches; the gradients
    match autograd through the plain version."""
    m, n, k = 128, 192, 256
    a, b = _gemm_inputs(cuda, m, n, k, "none", seed=9)
    w = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (m, n))).to(cuda, torch.float32)
    op = integrate.gemm_op(m, n, k, schedule=schedule, backend="cuda")
    plan = compile_gemm(m, n, k, schedule=schedule).run_cuda.plan
    grads = []
    for fn in (op, lambda x, y: backend_cuda.gemm_plain(plan, x, y)):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        before = gemm.cuda_gemm.launches
        (fn(x, y) * w).sum().backward()
        grads.append((x.grad, y.grad, gemm.cuda_gemm.launches - before))
    (ga, gb, n_op), (pa, pb, n_plain) = grads
    assert (n_op, n_plain) == (3, 0)
    torch.testing.assert_close(ga, pa, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    torch.testing.assert_close(gb, pb, rtol=GEMM_RTOL, atol=GEMM_ATOL)


# ---- flash attention ---------------------------------------------------------


def _qkv(dev, dtype, bh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dev, dtype)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("shape,causal,window", [
    ((3, 128, 128, 64), True, None),
    ((3, 128, 128, 64), False, None),
    ((2, 64, 128, 32), True, 32),            # Sk > Sq, a window
    ((2, 256, 256, 64), True, 128),          # tiles skipped on both sides
    ((2, 128, 256, 128), True, None),
    ((2, 128, 64, 32), True, None),          # rows masked everywhere
    ((2, 256, 256, 256), True, 40),          # hd 256
    ((1, 100, 70, 20), True, None),          # ragged tiles, hd not 4k
    ((2, 96, 96, 130), False, 16),           # a window without causal
    ((1, 64, 64, 16), True, 0),              # every row masked
])
def test_flash_kernel_matches_plain(cuda, dtype, tol, shape, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, dtype, *shape)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
        assert ((got.float() - want32).abs()
                <= BF16_ROUND * want32.abs() + TOL).all()


def test_flash_kernel_ignores_the_reference_blocks(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, torch.float32, 2, 128, 128, 32, seed=42)
    want = fa.flash_attention(q, k, v)
    for bq, bk in ((32, 32), (32, 128), (128, 64)):
        got = fa.flash_attention(q, k, v, block_q=bq, block_k=bk)
        assert torch.equal(got, want)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, torch.float32, 1, 32, 32, 16)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                           v)
    wide = _qkv(cuda, torch.float32, 1, 32, 32, 264)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*wide)


def test_ops_attention_one_launch(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q, k, v = (t.reshape(2, 3, *t.shape[1:])
               for t in _qkv(cuda, torch.float32, 6, 64, 96, 32, seed=9))
    before = fa.flash_attention.launches
    got = ops.attention(q, k, v, window=24, backend="cuda")
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.attention(q, k, v, window=24, backend="torch")
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL


# ---- SSD scan ----------------------------------------------------------------

SSD_TOL = dict(rtol=1e-3, atol=1e-4)      # tests/test_kernels.py:97


def _ssd(dev, dtype, batch, S, H, P, N, seed=0):
    """tests/test_kernels.py's draw: dt = |N(0,1)| 0.1, A = -|N(0,1)|."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, S, H, P))
    dt = np.abs(rng.standard_normal((batch, S, H))) * 0.1
    A = -np.abs(rng.standard_normal(H))
    B = rng.standard_normal((batch, S, N))
    C = rng.standard_normal((batch, S, N))
    D = rng.standard_normal(H)
    return ([torch.from_numpy(a).to(dev, dtype) for a in (x, dt)]
            + [torch.from_numpy(A).to(dev, torch.float32)]
            + [torch.from_numpy(a).to(dev, dtype) for a in (B, C)]
            + [torch.from_numpy(D).to(dev, torch.float32)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk,with_d", [
    ((1, 128, 4, 16, 8), 16, True),
    ((1, 128, 4, 16, 8), 32, False),
    ((2, 256, 3, 64, 128), 64, True),        # mamba2-130m's P, N, chunk
    ((1, 96, 2, 6, 5), 32, True),            # widths not 4k
    ((2, 8, 2, 3, 4), 64, True),             # one chunk shorter than 64
])
def test_ssd_kernel_matches_plain(cuda, dtype, shape, chunk, with_d):
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C, D = _ssd(cuda, dtype, *shape)
    D = D if with_d else None
    before = ss.ssd_scan.launches
    got = ss.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ss.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **SSD_TOL)
    else:
        lo, hi = ss.bracket(x, dt, A, B, C, D, chunk=chunk, **SSD_TOL)
        assert ((got >= lo) & (got <= hi)).all()


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C, D = _ssd(cuda, torch.float32, 1, 256, 2, 8, 4)
    with pytest.raises(ValueError, match="chunk 128"):
        ss.ssd_scan(x, dt, A, B, C, D, chunk=128)
    with pytest.raises(TypeError):
        ss.ssd_scan(x.half(), dt.half(), A, B.half(), C.half(), D)
    with pytest.raises(TypeError):
        ss.ssd_scan(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2),
                    C, D)
    for P, N in ((65, 4), (8, 129)):
        big = _ssd(cuda, torch.float32, 1, 64, 1, P, N)
        with pytest.raises(ValueError, match="the kernel takes"):
            ss.ssd_scan(*big)


def test_ops_ssd_one_launch_and_backends(cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C, D = _ssd(cuda, torch.float32, 3, 256, 4, 32, 16, seed=5)
    before = ss.ssd_scan.launches
    got = ops.ssd(x, dt, A, B, C, D, chunk=64, backend="cuda")
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    want = ops.ssd(x, dt, A, B, C, D, chunk=64, backend="torch")
    torch.testing.assert_close(got, want, **SSD_TOL)


# --------------------------------------------------------------------------
# the general emitter's stage kernels (backend_cuda.emit_general)
# --------------------------------------------------------------------------

STAGE_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_compiled_kernels.py's
ATTN_PIPES = ["lower{{{t}}}", "lower{{{t}}},fuse-epilogue",
              "lower{{{t}}},fuse-epilogue,grid{{vars=1}}",
              "lower{{{t}}},fuse-epilogue,grid{{vars=2}}"]
# (graph, dims, tile, pipelines): tests/test_compiled_kernels.py's matrix at
# its small size and at a mid size; flash at tile 16 gives grid{vars=2}
# 512 programs, so its first stage runs 256-thread blocks
STAGE_CELLS = [
    ("flash_attention_graph", (8, 16, 4), (4, 4, 4), ATTN_PIPES),
    ("flash_attention_graph", (256, 512, 64), (16, 16, 16), ATTN_PIPES),
    ("decode_attention_graph", (4, 16, 4), (4, 4, 4),
     [ATTN_PIPES[0], ATTN_PIPES[3]]),
    ("decode_attention_graph", (7, 161, 128), (128, 128, 128),
     [ATTN_PIPES[0], ATTN_PIPES[3]]),
    ("ssd_scan_graph", (8, 2, 2), (4, 4, 4), ATTN_PIPES[:3]),
    ("ssd_scan_graph", (512, 8, 16), (64, 64, 64), ATTN_PIPES[:3]),
]


def _stage_graph_inputs(graph, dims, cuda):
    if graph == "ssd_scan_graph":
        _, xs = stage_cases.ssd_inputs(*dims, head=1)
    elif graph == "flash_attention_graph":
        _, xs = stage_cases.flash_inputs(*dims)
    else:
        rep, smax, hd = dims
        (q, k, v), xs = stage_cases.flash_inputs(rep, smax, hd, seed=3)
        xs[3] = stage_cases.attn_mask(rep, smax, causal=False,
                                      valid=smax // 2 + 1)
    return [torch.from_numpy(x).to(cuda) for x in xs]


@pytest.mark.parametrize("graph,dims,tile,pipe", [
    pytest.param(g, d, t, p.format(t="tile_m={},tile_n={},tile_k={}"
                                   .format(*t)),
                 id=f"{g.split('_')[0]}-{'x'.join(map(str, d))}-{i}")
    for g, d, t, ps in STAGE_CELLS for i, p in enumerate(ps)])
def test_stage_kernels_match_the_plain_version(cuda, graph, dims, tile,
                                               pipe):
    """Every graph and schedule of the compiled-kernel matrix: one launch
    per stage, no GEMM launch, and the kernels within 1e-4 of
    general_plain."""
    ck = compile_traced(getattr(fe, graph)(*dims), pipeline=pipe,
                        want_torch=False)
    fn = ck.run_cuda
    assert fn is not None and fn.plan is None
    xs = _stage_graph_inputs(graph, dims, cuda)
    before = (backend_cuda.emit_general.launches, gemm.cuda_gemm.launches)
    got = fn(*xs)
    torch.cuda.synchronize()
    assert (backend_cuda.emit_general.launches, gemm.cuda_gemm.launches) \
        == (before[0] + len(fn.stages), before[1])
    assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, backend_cuda.general_plain(fn, *xs),
                               **STAGE_TOL)


@pytest.mark.parametrize("case", sorted(stage_cases.TEXT_CASES))
def test_stage_kernels_run_every_statement(cuda, case):
    """Every op and statement kind, statements staged in shared memory
    because they write their own operands, and a stage that reads its
    fresh (NaN) output and writes part of another: the kernels against
    general_plain, NaN where it has NaN."""
    text, nin = stage_cases.TEXT_CASES[case]
    fn = backend_cuda.emit(ir_text.parse_ir(text()))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
          .to(cuda) for _ in range(nin)]
    before = backend_cuda.emit_general.launches
    got = fn(*xs)
    torch.cuda.synchronize()
    assert backend_cuda.emit_general.launches == before + len(fn.stages)
    want = backend_cuda.general_plain(fn, *xs)
    assert got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    # all_ops ends in a bf16 cast of f32 values that may differ within
    # 1e-4, so a value may land one bf16 step (2^-7 of it at most) away
    tol = (dict(rtol=2 ** -7, atol=1e-4) if case == "all_ops"
           else STAGE_TOL)
    torch.testing.assert_close(got[~got.isnan()], want[~want.isnan()],
                               **tol)


@pytest.mark.parametrize("pipe", ATTN_PIPES[:3])
def test_stage_kernels_in_bf16(cuda, pipe):
    """bf16 buffers, a bf16 shared-memory accumulator and bf16 roundings:
    within tests/test_kernels.py's bf16 bound of general_plain."""
    ck = compile_traced(stage_cases.bf16_graph(fe, 64),
                        pipeline=pipe.format(t="tile_m=16,tile_n=16,"
                                               "tile_k=16"),
                        want_torch=False)
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(cuda) for _ in range(3)]
    got = ck.run_cuda(*xs)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), backend_cuda.general_plain(ck.run_cuda, *xs).float(),
        rtol=TOL_BF16, atol=TOL_BF16)


def test_stage_kernels_are_deterministic(cuda):
    """Two calls give bit-identical outputs (no atomics, a fixed order)."""
    ck = compile_traced(fe.flash_attention_graph(256, 512, 64),
                        pipeline=ATTN_PIPES[3].format(
                            t="tile_m=16,tile_n=16,tile_k=16"),
                        want_torch=False)
    xs = _stage_graph_inputs("flash_attention_graph", (256, 512, 64), cuda)
    assert torch.equal(ck.run_cuda(*xs), ck.run_cuda(*xs))


def test_stage_kernels_refuse_what_they_do_not_take(cuda):
    ck = compile_traced(fe.flash_attention_graph(8, 16, 4),
                        pipeline=ATTN_PIPES[3].format(
                            t="tile_m=4,tile_n=4,tile_k=4"),
                        want_torch=False)
    xs = _stage_graph_inputs("flash_attention_graph", (8, 16, 4), cuda)
    before = backend_cuda.emit_general.launches
    with pytest.raises(ValueError, match="several devices"):
        ck.run_cuda(xs[0], xs[1].cpu(), *xs[2:])
    with pytest.raises(ValueError, match="shape"):
        ck.run_cuda(xs[0][:4], *xs[1:])
    with pytest.raises(ValueError, match="inputs"):
        ck.run_cuda(*xs, xs[0], xs[0], xs[0], xs[0], xs[0], xs[0], xs[0],
                    xs[0], xs[0])
    assert backend_cuda.emit_general.launches == before
