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


def _check_decode(q, k, v, valid, dtype, splits=None, **kw):
    """The kernel against the plain version: through ``decode_attention``,
    or, given ``splits``, through its launcher in that many ranges."""
    if splits is None:
        got = da.decode_attention(q, k, v, valid, **kw)
    else:
        got = da._launch(q, k, v, valid, da.split_plan(
            k.shape[2], q.shape[0] * q.shape[1], splits))
    torch.cuda.synchronize()
    want = da.decode_attention_ref(q, k, v, valid)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.isfinite(got).all()
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid,splits", [
    ([5, 20], 8),            # ranges of 8: later ranges wholly past valid
    ([15, 16], 4),           # ranges of 16: a boundary at valid +- 1
    ([17, 47], 4),
    ([0, 0], 4),             # an empty cache: the mean of V
    ([0, 33], 3),
    ([40, 64], 80),          # more ranges than positions
    ([64, 1], 1),            # one range: no merge kernel
    ([64, 63], 2),           # ranges of 32: each a whole tile
])
def test_kernel_split_edges(cuda, dtype, valid, splits):
    """The split ranges and the merge at their edges, against the plain
    version and the plain version of the split itself."""
    q, k, v, valid = _inputs(cuda, dtype, 2, 2, 3, 64, 64, valid, seed=3)
    got = _check_decode(q, k, v, valid, dtype, splits=splits)
    want = da.decode_attention_split_ref(q, k, v, valid, splits)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["shifted", "hd_6", "odd_stride"])
def test_kernel_narrow_copies(cuda, dtype, case):
    """K/V rows the 16-byte copies cannot read (data 1 element past a
    16-byte boundary, hd 6, hd 30 of rows 32 wide) take the
    element-by-element instantiation, at several split counts."""
    hd = 6 if case == "hd_6" else 32
    q, k, v, valid = _inputs(cuda, dtype, 2, 3, 4, hd, 150, [150, 37],
                             seed=4)
    if case == "shifted":
        k, v = shifted(k), shifted(v)
    elif case == "odd_stride":
        k, v = k[..., :-2], v[..., :-2]
        q = q[..., :-2]
    assert not da.wide(k, v)
    for splits in (None, 1, 5):
        before = (da.decode_attention.launches,
                  da.decode_attention.narrow_launches)
        _check_decode(q, k, v, valid, dtype, splits=splits)
        assert (da.decode_attention.launches - before[0],
                da.decode_attention.narrow_launches - before[1]) == (1, 1)


def shifted(x):
    """A copy of ``x`` whose data starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("splits", [None, 3])
def test_kernel_above_65535_groups(cuda, splits):
    """B * KV = 66000 blocks of groups (x splits), past a grid's 65535 on
    any axis but x, through the split and the merge kernels."""
    q, k, v, valid = _inputs(cuda, torch.float32, 33000, 2, 2, 8, 24,
                             list(range(24)) * 1375, seed=5)
    _check_decode(q, k, v, valid, torch.float32, splits=splits)


@pytest.mark.parametrize("depth", [547, 4096])
def test_kernel_deep_caches(cuda, depth):
    """A prime depth at block_k 1 (the kernel's ranges ignore it) and a
    long cache whose ranges span many tiles (two tile buffers)."""
    q, k, v, valid = _inputs(cuda, torch.float32, 2, 2, 7, 128, depth,
                             [depth, depth // 3], seed=6)
    block_k = 1 if depth == 547 else 256
    _check_decode(q, k, v, valid, torch.float32, block_k=block_k)


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


def _bf16_models(cuda):
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), num_heads=14,
                              num_kv_heads=2, head_dim=8)
    run = dict(param_dtype="bfloat16", cache_dtype="bfloat16")
    m = Model(cfg, RunConfig(backend="cuda", **run), cuda)
    plain = Model(cfg, RunConfig(backend="torch", **run), cuda)
    return cfg, m, plain, m.init(torch.Generator(device=cuda).manual_seed(0))


def _rows_at(m, params, prompts, depth):
    """A cache whose rows hold ``prompts`` (of different lengths), each
    prefilled at B=1 and copied in, with per-row lengths; and the B=1
    caches."""
    from repro_torch.models.transformer import cache_leaves
    batch = m.cache_init(len(prompts), depth)
    ones = []
    for b, pr in enumerate(prompts):
        one = m.cache_init(1, depth)
        m.apply(params, pr[None], cache=one)
        for leaf, src in zip(cache_leaves(batch), cache_leaves(one)):
            leaf[:, b] = src[:, 0]
        ones.append(one)
    batch["len"] = np.array([len(p) for p in prompts])
    return batch, ones


@pytest.mark.parametrize("bf16", [False, True])
def test_model_per_row_decode_runs_the_kernel(cuda, bf16):
    """One decode step whose rows sit at different lengths (the continuous
    engine's step) launches the kernel once a layer with a per-row
    ``valid``, and gives each row its B=1 decode's logits (bf16 params
    and caches: within tests/test_kernels.py's bf16 bound of the logits'
    largest magnitude, and of the plain version's)."""
    cfg, m, plain, params = (_bf16_models if bf16 else _models)(cuda)
    tol = TOL_BF16 if bf16 else 1e-4
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), device=cuda,
                             generator=gen) for n in (5, 12, 1, 9)]
    nxt = torch.randint(0, cfg.vocab_size, (4, 1), device=cuda,
                        generator=gen)
    batch, ones = _rows_at(m, params, prompts, 16)
    twin, _ = _rows_at(plain, params, prompts, 16)
    before = da.decode_attention.launches
    got, _ = m.apply(params, nxt, cache=batch)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + cfg.num_layers
    want, _ = plain.apply(params, nxt, cache=twin)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    for b, one in enumerate(ones):
        row, _ = m.apply(params, nxt[b:b + 1], cache=one)
        err = (got[b].float() - row[0].float()).abs().max().item()
        assert err <= tol * scale, (b, err)


def test_continuous_engine_on_the_card(cuda):
    """The continuous engine on the card completes a mixed request set
    (max_new 1 among it), one kernel launch a layer per batched step; its
    greedy streams are the serial engine's except where a batched product
    rounds a near tie another way than a B=1 one (counted, not
    asserted)."""
    from repro_torch.serve.engine import (ContinuousEngine, Request,
                                          SerialSlotEngine)
    cfg, m, _, params = _models(cuda)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (4 + i,)).astype(
        np.int32), int(rng.integers(1, 8))) for i in range(6)]
    eng = ContinuousEngine(m, params, slots=3, max_len=64)
    before = da.decode_attention.launches
    got = eng.serve([Request(r.rid, r.prompt, r.max_new) for r in reqs])
    assert da.decode_attention.launches == before + cfg.num_layers * \
        eng.steps
    assert sorted(got) == [r.rid for r in reqs]
    for r in reqs:
        assert len(got[r.rid]) == r.max_new
    serial = SerialSlotEngine(m, params, slots=3, max_len=64).serve(reqs)
    same = sum(np.array_equal(got[r.rid], serial[r.rid]) for r in reqs)
    print(f"{same} of {len(reqs)} greedy streams bit-identical")


# ---- the general emitter's and the GEMM template's repaired refusals --------


@pytest.mark.parametrize("case", sorted(stage_cases.REPAIRS))
def test_repaired_emitters_match_plain(cuda, case):
    """Each kernel the port once refused (f16, int32 and int8 elements;
    scratch above a block's 227 KB, in a global workspace; rank-3 matmul
    tiles; the GEMM template's epilogue layouts and partial grids) runs
    on the card and matches its plain version on the same inputs within
    1e-4, its unwritten elements included."""
    text, inputs = stage_cases.REPAIRS[case]
    fn = backend_cuda.emit(ir_text.parse_ir(text()), device="cuda")
    xs = inputs(np.random.default_rng(0))
    counter = (gemm.cuda_gemm if fn.plan is not None
               else backend_cuda.emit_general)
    before = counter.launches
    got = fn(*xs)
    torch.cuda.synchronize()
    assert counter.launches == before + (1 if fn.plan is not None
                                         else len(fn.stages))
    if fn.plan is not None:
        want = backend_cuda.gemm_plain(fn.plan, *(
            torch.as_tensor(x).to(cuda, dtype=backend_cuda._TORCH_DTYPE[
                fn.plan.dtypes[n]])
            for x, n in zip(xs, fn.plan.in_buffers)))
    else:
        want = backend_cuda.general_plain(fn, *xs)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-4,
                               atol=1e-4, equal_nan=True)


# ---- the compiler-emitted GEMM ----------------------------------------------

# tests/test_kernels.py's GEMM bound in f32.  compile_gemm's bf16 products
# have an f32 output (TensorIR's matmul accumulates in f32), so after the
# bf16 inputs nothing rounds coarser than f32 and the same bound holds.
GEMM_RTOL, GEMM_ATOL = 1e-4, 1e-3
GEMM_BF16 = (5e-2, 5e-1)        # and its bf16 bound (rtol, atol)


def _gemm_inputs(dev, m, n, k, epilogue, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((m, k)), rng.standard_normal((k, n))]
    if epilogue == "bias_relu":
        xs.append(rng.standard_normal(n))
    return [torch.from_numpy(x).to(dev, torch.float32) for x in xs]


def _shifted(x):
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary: only the simt kernels read it."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


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
    """Tiles 128: f32 on the register-tiled route, bf16 on the tensor
    cores."""
    ck = compile_gemm(256, 384, 640, schedule=schedule, dtype=dtype,
                      epilogue=epilogue, want_torch=False)
    before = (gemm.cuda_gemm.wgmma_launches, gemm.cuda_gemm.ffma_launches)
    _check_gemm(ck.run_cuda, _gemm_inputs(cuda, 256, 384, 640, epilogue))
    assert (gemm.cuda_gemm.wgmma_launches - before[0],
            gemm.cuda_gemm.ffma_launches - before[1]) == (
        (1, 0) if dtype == "bfloat16" else (0, 1))


@pytest.mark.parametrize("schedule,epilogue", list(itertools.product(
    ("tpu_mxu", "tpu_mxu_kgrid"), ("none", "relu", "bias_relu"))))
def test_simt_gemm_kernel_matches_plain(cuda, schedule, epilogue):
    """test_gemm_kernel_matches_plain's f32 products on operands 4 bytes
    past a 16-byte boundary: the plain CUDA-core template
    (stagecc_gemm.cuh) at tiles 128."""
    fn = compile_gemm(256, 384, 640, schedule=schedule, epilogue=epilogue,
                      want_torch=False).run_cuda
    xs = [_shifted(x) for x in _gemm_inputs(cuda, 256, 384, 640, epilogue)]
    assert fn.route(*xs)[0] == "simt"
    before = (gemm.cuda_gemm.wgmma_launches, gemm.cuda_gemm.ffma_launches)
    _check_gemm(fn, xs)
    assert (gemm.cuda_gemm.wgmma_launches,
            gemm.cuda_gemm.ffma_launches) == before


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
        # f32 on the plain CUDA-core template (stagecc_gemm.cuh); bf16
        # where tk is a multiple of 16 on the tensor cores, else there too
        route = ck.run_cuda.route(a, b)[0]
        assert route == ("wgmma" if dtype == torch.bfloat16
                         and ck.run_cuda.plan.tiles[2] % 16 == 0 else "simt")
        got = _check_gemm(ck.run_cuda, [a, b])
        assert torch.equal(got, gemm.cuda_gemm(a, b, schedule=schedule))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_kernel_reads_transposed_views(cuda, schedule):
    """The backward of gemm_op passes transposed views; the kernel reads
    them through their strides."""
    ck = compile_gemm(192, 320, 256, schedule=schedule, want_torch=False)
    assert ck.run_cuda.plan.tiles[:2] == (96, 80)      # the simt template
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


FLASH_CASES = [
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
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, tol, shape, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, dtype, *shape)
    before = (fa.flash_attention.launches, fa.flash_attention.ffma_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before[0] + 1
    # f32 at a head dim that is a multiple of 4 runs flash_attention_ffma.cu
    ffma = dtype == torch.float32 and shape[3] % 4 == 0
    assert fa.flash_attention.ffma_launches == before[1] + ffma
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
        assert ((got.float() - want32).abs()
                <= BF16_ROUND * want32.abs() + TOL).all()


@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_simt_flash_kernel_matches_plain(cuda, shape, causal, window):
    """test_flash_kernel_matches_plain's f32 cases on q, k and v 4 bytes
    past a 16-byte boundary: the simt kernel (flash_attention.cu) at every
    head dim, with its masks, skipped tiles and ragged tiles."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (_shifted(t) for t in _qkv(cuda, torch.float32, *shape))
    assert fa.route(q.dtype, q.shape[2], q.data_ptr())[0] == "simt"
    before = (fa.flash_attention.launches, fa.flash_attention.wgmma_launches,
              fa.flash_attention.ffma_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.wgmma_launches - before[1],
            fa.flash_attention.ffma_launches - before[2]) == (1, 0, 0)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (got - want).abs().max().item() <= TOL


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
    # a head dim above 256 is no longer refused: it runs in column slices
    wide = _qkv(cuda, torch.float32, 1, 32, 32, 264)
    torch.testing.assert_close(fa.flash_attention(*wide),
                               fa.flash_attention_plain(*wide),
                               rtol=0, atol=TOL)


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


# ---- the tensor-core (wgmma) routes -------------------------------------------


def _bf16_gemm(schedule, epilogue, tk, m=256, n=384, k=640, tm=128, tn=128):
    return compile_gemm(m, n, k, schedule=schedule, dtype="bfloat16",
                        epilogue=epilogue, tile={"m": tm, "n": tn, "k": tk},
                        want_torch=False).run_cuda


def _check_wgmma(fn, xs, exact=False):
    """_check_gemm, and the launch went down the tensor-core route."""
    before = gemm.cuda_gemm.wgmma_launches
    got = _check_gemm(fn, xs, exact)
    assert fn.route(*xs)[0] == "wgmma"
    assert gemm.cuda_gemm.wgmma_launches == before + 1
    return got


@pytest.mark.parametrize("tk", [16, 64, 128])
@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_wgmma_gemm_matches_plain(cuda, schedule, epilogue, tk):
    """bf16 operands, tk 16 / 64 / 128: the tensor-core kernel inside the
    bracket of the plan's roundings and within the f32 bound of
    gemm_plain."""
    fn = _bf16_gemm(schedule, epilogue, tk)
    _check_wgmma(fn, _gemm_inputs(cuda, 256, 384, 640, epilogue, seed=tk))


@pytest.mark.parametrize("tk,k", [(48, 480), (112, 448), (256, 1024),
                                  (512, 1024)])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_wgmma_gemm_k_tiles_across_stages(cuda, schedule, tk, k):
    """k tiles that end inside a 64-wide ring stage (48, 112) or span
    several stages (256, 512): part starts afresh at every tile's first
    k16 step wherever it falls."""
    fn = _bf16_gemm(schedule, "none", tk, m=256, n=384, k=k)
    _check_wgmma(fn, _gemm_inputs(cuda, 256, 384, k, "none", seed=tk))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_wgmma_gemm_ragged_edges(cuda, schedule):
    """131 x 200 outputs (tiles 131 x 200 x 64): the kernel's 128 x 128
    blocks overhang M and N; TMA fills the overhang with zeros and the
    epilogue stores none of it."""
    fn = _bf16_gemm(schedule, "bias_relu", 64, m=131, n=200, k=256, tm=131,
                    tn=200)
    _check_wgmma(fn, _gemm_inputs(cuda, 131, 200, 256, "bias_relu", seed=5))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_wgmma_gemm_reads_transposed_views(cuda, schedule):
    """A and B K-major or MN-major (transposed views, read through the
    transpose bits): every combination gives the same bits."""
    fn = _bf16_gemm(schedule, "none", 64, m=192, n=320, k=256)
    rng = np.random.default_rng(3)
    at, bt = (torch.from_numpy(rng.standard_normal(s)).to(
        cuda, torch.bfloat16).t() for s in ((256, 192), (320, 256)))
    a, b = at.contiguous(), bt.contiguous()
    want = fn(a, b)
    for x, y in ((at, bt), (at, b), (a, bt)):
        got = _check_wgmma(fn, [x, y])
        assert torch.equal(got, want.float())


@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
def test_wgmma_gemm_bf16_output(cuda, epilogue):
    """A matmul that accumulates in bf16 on the tensor cores: each k tile's
    f32 sum rounded to bf16 and added to the bf16 running sum, equal to
    gemm_plain wherever only one value can be."""
    m, n, k = 128, 256, 1024

    def f(a, b, *bias):
        y = a._emit("matmul", [b], acc_dtype="bfloat16")
        return fe.relu(y + bias[0]) if bias else y
    specs = [fe.spec((m, k), "bfloat16"), fe.spec((k, n), "bfloat16")]
    specs += [fe.spec((n,), "float32")] if epilogue == "bias_relu" else []
    ck = compile_traced(fe.trace(f, specs, name="g"),
                        schedule="tpu_mxu_kgrid",
                        tile={"m": 128, "n": 128, "k": 64}, want_torch=False)
    _check_wgmma(ck.run_cuda, _gemm_inputs(cuda, m, n, k, epilogue, seed=8),
                 exact=True)


@pytest.mark.parametrize("case", ["f32", "tk1", "unaligned", "stride"])
def test_gemm_route_stays_simt(cuda, case):
    """f32 operands on tiles of 96, tk = 1 (a prime K), an operand at an
    odd address and one whose row stride is not 16 bytes run the plain
    CUDA-core kernel (stagecc_gemm.cuh), and it matches the plain version."""
    rng = np.random.default_rng(4)
    if case == "f32":
        fn = compile_gemm(96, 96, 96, want_torch=False).run_cuda
        xs = _gemm_inputs(cuda, 96, 96, 96, "none")
    elif case == "tk1":
        fn = gemm._build(64, 96, 131, "tpu_mxu_kgrid", "bfloat16", 64, 96,
                         1).run_cuda
        xs = [x.bfloat16() for x in _gemm_inputs(cuda, 64, 96, 131, "none")]
    else:
        fn = _bf16_gemm("tpu_mxu", "none", 64, m=64, n=128, k=128)
        wide = torch.from_numpy(rng.standard_normal((64, 129 if case ==
                                                     "stride" else 136)))
        wide = wide.to(cuda, torch.bfloat16)
        a = wide[:, 1:129] if case == "unaligned" else wide[:, :128]
        xs = [a, torch.from_numpy(rng.standard_normal((128, 128))).to(
            cuda, torch.bfloat16)]
    before = (gemm.cuda_gemm.wgmma_launches, gemm.cuda_gemm.ffma_launches)
    _check_gemm(fn, xs)
    assert fn.route(*xs)[0] == "simt"
    assert (gemm.cuda_gemm.wgmma_launches,
            gemm.cuda_gemm.ffma_launches) == before


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_op_bf16_on_the_tensor_cores(cuda, schedule):
    """gemm_op in bf16: forward and backward are three tensor-core
    launches (the backward reads b.t() K-major and a.t() M-major); the
    gradients match autograd through the plain version within
    tests/test_kernels.py's bf16 bound."""
    m, n, k = 128, 192, 256
    a, b = (x.bfloat16() for x in _gemm_inputs(cuda, m, n, k, "none",
                                               seed=9))
    w = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (m, n))).to(cuda, torch.float32)
    op = integrate.gemm_op(m, n, k, schedule=schedule, backend="cuda")
    plan = compile_gemm(m, n, k, schedule=schedule,
                        dtype="bfloat16").run_cuda.plan
    grads = []
    for fn in (op, lambda x, y: backend_cuda.gemm_plain(plan, x, y)):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        before = (gemm.cuda_gemm.launches, gemm.cuda_gemm.wgmma_launches)
        (fn(x, y) * w).sum().backward()
        grads.append((x.grad, y.grad,
                      gemm.cuda_gemm.launches - before[0],
                      gemm.cuda_gemm.wgmma_launches - before[1]))
    (ga, gb, *n_op), (pa, pb, *n_plain) = grads
    assert (n_op, n_plain) == ([3, 3], [0, 0])
    assert ga.dtype == gb.dtype == torch.bfloat16
    rtol, atol = GEMM_BF16
    torch.testing.assert_close(ga.float(), pa.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(gb.float(), pb.float(), rtol=rtol, atol=atol)


def _flash_bf16(cuda, bh, sq, sk, d, causal, window, seed=0, path="wgmma"):
    """One bf16 flash_attention call against the plain version at the
    smoke's two gates; asserts which kernel ran."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, torch.bfloat16, bh, sq, sk, d, seed=seed)
    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention.launches, fa.flash_attention.wgmma_launches)
    got = fa.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.wgmma_launches - before[1]) == (
        1, int(path == "wgmma"))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() <= TOL_BF16
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert ((got.float() - want32).abs()
            <= BF16_ROUND * want32.abs() + TOL).all()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_wgmma_flash_matches_plain(cuda, d, causal, window):
    """The tensor-core kernel at head dims 64, 128 and 256, Sq != Sk (a
    ragged last query tile of 192 rows against 320 keys)."""
    _flash_bf16(cuda, 3, 192, 320, d, causal, window, seed=d)


@pytest.mark.parametrize("shape,causal,window,path", [
    ((2, 128, 64, 64), True, None, "wgmma"),    # rows masked everywhere
    ((2, 64, 64, 64), True, 0, "wgmma"),        # every row masked
    ((2, 128, 128, 80), True, None, "wgmma"),   # zero-filled to 128 columns
    ((2, 128, 128, 72), True, None, "simt"),    # not a multiple of 16
    ((2, 100, 70, 16), True, 24, "wgmma"),      # ragged, no divisible tiles
])
def test_wgmma_flash_edges(cuda, shape, causal, window, path):
    _flash_bf16(cuda, *shape, causal, window, seed=sum(shape), path=path)


def test_wgmma_flash_at_65536_heads(cuda):
    """BH = 65536 on the tensor-core kernel, past the 65535 blocks of a
    grid's second axis."""
    _flash_bf16(cuda, 65536, 64, 64, 32, True, None, seed=11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_head_dims_above_256(cuda, dtype, d):
    """Head dims above 256 run flash_attention.cu in column slices of the
    output, each computing S over all of D."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, dtype, 2, 128, 192, d, seed=d)
    before = (fa.flash_attention.launches, fa.flash_attention.wgmma_launches,
              fa.flash_attention.ffma_launches)
    got = fa.flash_attention(q, k, v, causal=True, window=100, block_k=64)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.wgmma_launches - before[1],
            fa.flash_attention.ffma_launches - before[2]) == (1, 0, 0)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=100)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:     # and _flash_bf16's gate in f32
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=True, window=100)
        assert ((got.float() - want32).abs()
                <= BF16_ROUND * want32.abs() + TOL).all()


# ---- the register-tiled CUDA-core (ffma) routes ----------------------------


def _check_ffma(fn, xs, exact=False):
    """_check_gemm, and the launch went down the ffma route."""
    before = gemm.cuda_gemm.ffma_launches
    got = _check_gemm(fn, xs, exact=exact)
    assert fn.route(*xs)[0] == "ffma"
    assert gemm.cuda_gemm.ffma_launches == before + 1
    return got


@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
@pytest.mark.parametrize("mnk", [(256, 384, 640), (2048, 2176, 256)])
def test_ffma_gemm_matches_plain(cuda, schedule, epilogue, mnk):
    """f32 at tiles 128: 6 and 272 plan tiles (24 and 1088 blocks of
    64 x 64), inside the bracket and the f32 bound."""
    fn = compile_gemm(*mnk, schedule=schedule, epilogue=epilogue,
                      want_torch=False).run_cuda
    _check_ffma(fn, _gemm_inputs(cuda, *mnk, epilogue, seed=mnk[0]))


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_ffma_gemm_operand_majors(cuda, schedule):
    """A and B K-major or MN-major (gemm_op's backward passes a.t() and
    b.t()): every major gives the same bits."""
    m, n, k = 256, 384, 512
    fn = compile_gemm(m, n, k, schedule=schedule, want_torch=False).run_cuda
    a, b = _gemm_inputs(cuda, m, n, k, "none", seed=21)
    at, bt = a.t().contiguous().t(), b.t().contiguous().t()
    want = _check_ffma(fn, [a, b])
    for x, y in ((at, b), (a, bt), (at, bt)):
        assert torch.equal(_check_ffma(fn, [x, y]), want)


@pytest.mark.parametrize("tk", [8, 24])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_ffma_gemm_bf16_operands(cuda, schedule, tk):
    """bf16 operands that the tensor cores do not take (tk not a multiple
    of 16) run on ffma, widened on load; f32 output, every major."""
    m, n, k = 128, 192, 384
    fn = _bf16_gemm(schedule, "none", tk, m=m, n=n, k=k, tm=64, tn=64)
    a, b = (x.bfloat16() for x in _gemm_inputs(cuda, m, n, k, "none",
                                               seed=tk))
    want = _check_ffma(fn, [a, b])
    for x, y in ((a.t().contiguous().t(), b), (a, b.t().contiguous().t())):
        assert torch.equal(_check_ffma(fn, [x, y]), want)


def test_ffma_gemm_bf16_output(cuda):
    """A matmul that accumulates in bf16, tk 8 (off the tensor cores): the
    k-grid kernel rounds its running sum after every k tile, equal to the
    plain version wherever only one value can be."""
    m, n, k = 128, 256, 512
    specs = [fe.spec((m, k), "bfloat16"), fe.spec((k, n), "bfloat16")]
    ck = compile_traced(fe.trace(
        lambda a, b: a._emit("matmul", [b], acc_dtype="bfloat16"), specs,
        name="g"), schedule="tpu_mxu_kgrid",
        tile={"m": 64, "n": 128, "k": 8}, want_torch=False)
    xs = [x.bfloat16() for x in _gemm_inputs(cuda, m, n, k, "none", seed=23)]
    _check_ffma(ck.run_cuda, xs, exact=True)


def test_ffma_gemm_op_on_the_register_tiles(cuda):
    """gemm_op at the smoke's 512 x 1024 x 768 (tiles 128): forward and
    backward are three ffma launches, the gradients as autograd through
    the plain version gives them."""
    m, n, k = 512, 1024, 768
    a, b = _gemm_inputs(cuda, m, n, k, "none", seed=24)
    w = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (m, n))).to(cuda, torch.float32)
    op = integrate.gemm_op(m, n, k, backend="cuda")
    plan = compile_gemm(m, n, k).run_cuda.plan
    grads = []
    for fn in (op, lambda x, y: backend_cuda.gemm_plain(plan, x, y)):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        before = gemm.cuda_gemm.ffma_launches
        (fn(x, y) * w).sum().backward()
        grads.append((x.grad, y.grad, gemm.cuda_gemm.ffma_launches - before))
    (ga, gb, n_op), (pa, pb, n_plain) = grads
    assert (n_op, n_plain) == (3, 0)
    torch.testing.assert_close(ga, pa, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    torch.testing.assert_close(gb, pb, rtol=GEMM_RTOL, atol=GEMM_ATOL)


def _flash_ffma(cuda, bh, sq, sk, d, causal, window, seed=0):
    """One f32 flash_attention call on the ffma kernel against the plain
    version, within tests/test_kernels.py's 2e-5."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, torch.float32, bh, sq, sk, d, seed=seed)
    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention.launches, fa.flash_attention.ffma_launches)
    got = fa.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.ffma_launches - before[1]) == (1, 1)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_ffma_flash_matches_plain(cuda, d, causal, window):
    """Head dims 64, 128 and 256 (tiles 128 x 64, and 64 x 64), Sq and Sk
    not multiples of the tiles, Sk > Sq."""
    _flash_ffma(cuda, 3, 200, 330, d, causal, window, seed=d)


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 128, 64, 64), True, None),     # rows masked everywhere
    ((2, 64, 64, 64), True, 0),         # every row masked: mean of V
    ((2, 130, 130, 20), True, None),    # zero-filled to 64 columns
    ((2, 96, 96, 132), False, 16),      # 132 columns on the D = 256 tiles
    ((1, 100, 70, 16), True, 24),       # ragged, Sk < Sq
])
def test_ffma_flash_edges(cuda, shape, causal, window):
    _flash_ffma(cuda, *shape, causal, window, seed=sum(shape))


def test_ffma_flash_at_65536_heads(cuda):
    """BH = 65536 at D = 128, past the 65535 blocks of a grid's second
    axis."""
    _flash_ffma(cuda, 65536, 64, 64, 128, True, None, seed=12)


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
    # chunk above 64, P above 64 and N above 128, which the reference's
    # kernel takes
    ((1, 256, 2, 8, 4), 128, True),
    ((1, 512, 2, 8, 4), 256, True),
    ((1, 128, 1, 65, 4), 64, True),
    ((1, 128, 1, 128, 16), 64, True),
    ((1, 128, 1, 8, 129), 64, True),
    ((1, 128, 1, 8, 256), 64, True),
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
    with pytest.raises(ValueError, match="must divide chunk"):
        ss.ssd_scan(x, dt, A, B, C, D, chunk=96)
    with pytest.raises(TypeError):
        ss.ssd_scan(x.half(), dt.half(), A, B.half(), C.half(), D)
    with pytest.raises(TypeError):
        ss.ssd_scan(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2),
                    C, D)


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


def test_spread_and_row_split_stages(cuda):
    """flash 256 x 256 x 64 on 64-row tiles: the nests after the first
    spread their row-tile loops over blocks, and every nest, the gridded
    first too, cuts each tile's 64 rows over 8 blocks; within 1e-4 of
    general_plain, the float64 oracle and flash_attention on the same
    slice."""
    from repro_torch.kernels.flash_attention import flash_attention
    ck = compile_traced(fe.flash_attention_graph(256, 256, 64),
                        pipeline=ATTN_PIPES[3].format(
                            t="tile_m=64,tile_n=64,tile_k=64"),
                        want_torch=False)
    fn = ck.run_cuda
    assert [(st.spread_vars, st.parts) for st in fn.stages] == [
        ([], 8), (["i7"], 8), (["e10", "e11"], 8), (["i14"], 8),
        (["i17", "j18"], 8)]
    (q, k, v), host = stage_cases.flash_inputs(256, 256, 64)
    xs = [torch.from_numpy(x).to(cuda) for x in host]
    got = fn(*xs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, backend_cuda.general_plain(fn, *xs),
                               **STAGE_TOL)
    qs, kt, vv, mask = (x.double() for x in xs)
    s = qs @ kt + mask
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    torch.testing.assert_close(got, ((p @ vv) / p.sum(dim=1, keepdim=True))
                               .float(), **STAGE_TOL)
    hand = flash_attention(*(torch.from_numpy(x).to(cuda)
                             for x in (q, k, v)), causal=True)[0]
    torch.testing.assert_close(got, hand, **STAGE_TOL)


@pytest.mark.parametrize("case", sorted(stage_cases.NOT_SPREAD)
                         + sorted(stage_cases.ROW_SPLIT))
def test_nests_not_spread_or_split_match_the_plain_version(cuda, case):
    """The hand-written nests that must not spread (a carried reduction or
    matmul, scratch read first, a shared or another iteration's tile, a
    scan along the loop) and those that must not split by rows, beside
    one that does: one launch each, equal to general_plain, NaN where it
    has NaN."""
    text = (stage_cases.NOT_SPREAD.get(case)
            or stage_cases.ROW_SPLIT[case][0])
    fn = backend_cuda.emit(ir_text.parse_ir(text))
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(cuda) for s in ((16, 8), (8, 8))]
    before = backend_cuda.emit_general.launches
    got = fn(*xs)
    torch.cuda.synchronize()
    assert backend_cuda.emit_general.launches == before + 1
    want = backend_cuda.general_plain(fn, *xs)
    torch.testing.assert_close(got, want, equal_nan=True, **STAGE_TOL)


def test_flash_kernel_at_65536_heads(cuda):
    """BH = 65536, past the 65535 blocks of a grid's second axis, on
    flash_attention.cu (f32 at a head dim that is not a multiple of 4)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, torch.float32, 65536, 64, 64, 30, seed=11)
    assert fa.route(q.dtype, 30, q.data_ptr())[0] == "simt"
    before = (fa.flash_attention.launches, fa.flash_attention.wgmma_launches,
              fa.flash_attention.ffma_launches)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.wgmma_launches - before[1],
            fa.flash_attention.ffma_launches - before[2]) == (1, 0, 0)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert (got - want).abs().max().item() <= TOL


def test_ssd_kernel_at_65536_sequences(cuda):
    """A batch of 65536 sequences, past the 65535 blocks of a grid's
    second axis."""
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C, D = _ssd(cuda, torch.float32, 65536, 16, 1, 4, 4,
                             seed=12)
    got = ss.ssd_scan(x, dt, A, B, C, D, chunk=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ss.ssd_scan_plain(x, dt, A, B, C, D,
                                                      chunk=16), **SSD_TOL)
