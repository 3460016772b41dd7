"""The tensor-core (sm_90a) routes of the port, rehearsed on the CPU.

The bf16 emitted GEMM and bf16 flash attention run on Hopper's tensor
cores (``wgmma`` fed by TMA), which only the card executes; their card
tests are in test_torch_cuda.py.  Here: the route rules that pick those
kernels (pure functions of the plan, strides and pointers), the sources
the compiler renders for them, and the arithmetic the attention kernel
uses for P V (P split into two bf16 halves), emulated in PyTorch against
the JAX package's Pallas kernel in interpret mode.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.core import backend_cuda, compile_gemm, integrate
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# chip_smoke.py's gate for bf16 attention: half a bf16 ulp of the value
# (at most 2^-8 of it) plus the f32 bound, against the f32 version
BF16_ROUND, TOL = 2.0 ** -8, 2e-5


@pytest.fixture(scope="module")
def smoke_gemms():
    """chip_smoke.GEMMS compiled as the smoke compiles them (phase 2)."""
    return smoke.compile_gemms(torch.device("cpu"))


def _bf16_in(ck):
    plan = ck.run_cuda.plan
    return plan.dtypes[plan.matmul.lhs.buffer.name] == "bfloat16"


@pytest.mark.parametrize("i", range(len(smoke.GEMMS)),
                         ids=[" ".join(g) for g in smoke.GEMMS])
def test_route_of_each_smoke_gemm(smoke_gemms, i):
    """Every bf16 product of the smoke takes the tensor-core route at tiles
    128, on contiguous operands; every f32 one the register-tiled CUDA-core
    (ffma) route, whose launcher every source holds."""
    prod, _, ck = smoke_gemms[i]
    m, n, k = smoke.MLP[prod]
    plan = ck.run_cuda.plan
    route, why = backend_cuda._gemm_route(plan, (k, 1), (n, 1), 256, 512)
    want = "wgmma" if _bf16_in(ck) else "ffma"
    assert route == want, why
    assert ("stagecc_gemm_sm90.cuh" in ck.run_cuda.source) == (want == "wgmma")
    assert ("stagecc_gemm_wgmma_launch" in ck.run_cuda.source) == (
        want == "wgmma")
    assert "stagecc_gemm_ffma_launch" in ck.run_cuda.source


def test_smoke_gemms_share_sources(smoke_gemms):
    """Products that share tk, types, schedule and epilogue share one
    source whatever their sizes: up and down render the same text."""
    by_key = {}
    for (prod, sched, dtype, epi), (_, _, ck) in zip(smoke.GEMMS,
                                                    smoke_gemms):
        by_key.setdefault((sched, dtype, epi), set()).add(ck.run_cuda.source)
    assert all(len(v) == 1 for v in by_key.values())
    assert len({ck.run_cuda.source for _, _, ck in smoke_gemms}) == len(
        by_key)


def _plan(dtype="bfloat16", tk=128, m=256, n=384, k=640, schedule="tpu_mxu"):
    return compile_gemm(m, n, k, schedule=schedule, dtype=dtype,
                        tile={"m": 128, "n": 128, "k": tk},
                        want_torch=False).run_cuda


def _route(fn, dtype=torch.bfloat16, m=256, n=384, k=640):
    """fn.route on contiguous (m, k) and (k, n) zeros."""
    return fn.route(torch.zeros(m, k, dtype=dtype),
                    torch.zeros(k, n, dtype=dtype))


@pytest.mark.parametrize("tk", [16, 64, 128])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_route_bf16_tiles(tk, schedule):
    fn = _plan(tk=tk, schedule=schedule)
    assert _route(fn)[0] == "wgmma"
    assert f"launch_wgmma<{tk}, {str(schedule.endswith('kgrid')).lower()}," \
        in fn.source


@pytest.mark.parametrize("dtype,tk,reason", [
    ("float32", 128, "float32, not bfloat16"),
    ("bfloat16", 8, "tk 8 is not a multiple of 16"),
])
def test_route_plan_refusals(dtype, tk, reason):
    """Plans the tensor cores refuse; at tiles 128 and tk a multiple of 8
    they take the register-tiled CUDA-core route instead."""
    fn = _plan(dtype=dtype, tk=tk)
    route, why = _route(fn, getattr(torch, dtype))
    assert route == "ffma" and reason in why
    assert backend_cuda._gemm_route(fn.plan, (640, 1), (384, 1)) == (
        route, why)
    assert "stagecc_gemm_sm90.cuh" not in fn.source
    assert "stagecc_gemm_wgmma_launch" not in fn.source


def test_route_prime_k_takes_tile_one():
    """A prime K gets tk = 1 (gemm._pick_tile), which stays on the CUDA
    cores."""
    a = torch.zeros(64, 131, dtype=torch.bfloat16)
    b = torch.zeros(131, 96, dtype=torch.bfloat16)
    gemm.cuda_gemm(a, b)
    ck = gemm._build(64, 96, 131, "tpu_mxu_kgrid", "bfloat16", 64, 96, 1)
    assert ck.run_cuda.plan.tiles[2] == 1
    assert ck.run_cuda.route(a, b)[0] == "simt"


@pytest.mark.parametrize("a_strides,b_strides,a_ptr,want", [
    ((640, 1), (384, 1), 0, "wgmma: A K-major, B N-major"),
    ((1, 256), (384, 1), 0, "wgmma: A M-major, B N-major"),   # a.t() view
    ((640, 1), (1, 640), 0, "wgmma: A K-major, B K-major"),   # b.t() view
    ((1, 256), (1, 640), 0, "wgmma: A M-major, B K-major"),
    ((640, 1), (384, 1), 2, "simt: A's base is not 16-byte aligned"),
    ((644, 1), (384, 1), 0, "simt: A's stride 644 is not 16 bytes apart"),
    ((640, 2), (384, 1), 0, "simt: A has no unit stride"),
    ((640, 1), (0, 1), 0, "simt: B's stride 0 is not 16 bytes apart"),
])
def test_route_operand_rules(a_strides, b_strides, a_ptr, want):
    plan = _plan().plan
    route, why = backend_cuda._gemm_route(plan, a_strides, b_strides, a_ptr,
                                          0)
    assert f"{route}: {why}".startswith(want.split(": ")[0])
    assert want.split(": ")[1] in why


def test_cpu_run_launches_nothing():
    """On CPU tensors the callable runs gemm_plain: no launch, no route
    change, the bracket holds."""
    fn = _plan(tk=64)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 640))).bfloat16()
    b = torch.from_numpy(rng.standard_normal((640, 384))).bfloat16()
    before = (gemm.cuda_gemm.launches, gemm.cuda_gemm.wgmma_launches)
    got = fn(a, b)
    assert (gemm.cuda_gemm.launches, gemm.cuda_gemm.wgmma_launches) == before
    assert fn.route(a, b)[0] == "wgmma"
    lo, hi = backend_cuda.bracket(fn.plan, a, b)
    assert ((got >= lo) & (got <= hi)).all()


@pytest.mark.parametrize("a_dtype,b_dtype,plan_dtype", [
    (torch.bfloat16, torch.bfloat16, "bfloat16"),
    (torch.float32, torch.bfloat16, "float32"),
    (torch.float32, torch.float32, "float32"),
])
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_gemm_op_compiles_for_the_operands_type(schedule, a_dtype, b_dtype,
                                                plan_dtype):
    """gemm_op has no type option: each product's plan takes its operands'
    type (bf16 only when both are), and gives what the f32 plan gives on
    the widened operands, bit for bit: forward, and the gradients of
    sum(C * W), whose dC = W is cast to each operand's type first."""
    m, n, k = 64, 96, 128
    rng = np.random.default_rng(6)
    a0, b0, w = (torch.from_numpy(rng.standard_normal(s)).float()
                 for s in ((m, k), (k, n), (m, n)))
    a0, b0 = a0.to(a_dtype).float(), b0.to(b_dtype).float()
    x = a0.to(a_dtype).requires_grad_()
    y = b0.to(b_dtype).requires_grad_()
    assert integrate._dtype(x, y) == plan_dtype
    c = integrate.gemm_op(m, n, k, schedule=schedule, backend="cuda")(x, y)
    (c * w).sum().backward()

    def f32(mm, nn, kk):
        return integrate._compiled(mm, nn, kk, schedule, "cuda")
    wants = (f32(m, n, k)(a0, b0),
             f32(m, k, n)(w.to(a_dtype).float(), b0.t()).to(a_dtype),
             f32(k, n, m)(a0.t(), w.to(b_dtype).float()).to(b_dtype))
    for got, want in zip((c, x.grad, y.grad), wants):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype,d,ptr,want", [
    (torch.bfloat16, 64, 0, "wgmma"),
    (torch.bfloat16, 128, 0, "wgmma"),
    (torch.bfloat16, 256, 0, "wgmma"),
    (torch.bfloat16, 80, 0, "wgmma"),       # zero-filled to 128 columns
    (torch.bfloat16, 72, 0, "simt"),        # not a multiple of 16
    (torch.bfloat16, 320, 0, "simt"),       # above 256: column slices
    (torch.bfloat16, 128, 8, "simt"),       # not 16-byte aligned
    (torch.float32, 128, 0, "ffma"),        # the register-tiled kernel
])
def test_flash_route(dtype, d, ptr, want):
    assert fa.route(dtype, d, 0, ptr, 256)[0] == want


# ---- split P ------------------------------------------------------------------


def _tiles(q, k, v, *, causal, window, split, bk=64):
    """The tensor-core attention kernel's arithmetic in PyTorch: key tiles
    of 64, f32 statistics, O = O corr + P V per tile with P either split
    into bf16(P) + bf16(P - bf16(P)) (the kernel) or rounded to bf16 once,
    then one rounding of the output to bf16."""
    q, k, v = (t.float() for t in (q, k, v))
    bh, sq, d = q.shape
    sk = k.shape[1]
    qpos = torch.arange(sq)[:, None] + sk - sq
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, sk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = q @ kt.transpose(1, 2) / math.sqrt(d)
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        keep = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = torch.where(keep, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt + ((p - hi).bfloat16().float() @ vt if split else 0)
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)).bfloat16()


@pytest.mark.parametrize("bh,s,d,window", [(2, 128, 64, None),
                                           (1, 256, 32, 96)])
def test_split_p_keeps_the_bf16_gate(bh, s, d, window):
    """Why the kernel computes P V twice: on bf16 inputs, split P stays
    within 2^-8 |want| + 2e-5 of the JAX kernel in f32 (interpret mode) at
    a small causal case; P rounded to bf16 once is far outside."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).bfloat16() for _ in range(3))
    want = torch.from_numpy(np.array(jax_flash(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=True,
        window=window, block_q=64, block_k=64)))
    ratio = {}
    for split in (True, False):
        got = _tiles(q, k, v, causal=True, window=window, split=split)
        ratio[split] = ((got.float() - want).abs()
                        / (BF16_ROUND * want.abs() + TOL)).max().item()
    assert ratio[True] <= 1 < 10 <= ratio[False], ratio
    # and the emulation agrees with the port's plain version within the
    # output's rounding
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(
        _tiles(q, k, v, causal=True, window=window, split=True).float(),
        plain.float(), rtol=2 ** -7, atol=TOL)
