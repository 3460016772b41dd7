"""The register-tiled CUDA-core (ffma) routes of the port, rehearsed on the
CPU.

The f32 emitted GEMM (csrc/stagecc_gemm_ffma.cuh) and f32 flash attention
(csrc/flash_attention_ffma.cu) run only on the card; their card tests are
in test_torch_cuda.py.  Here: the three-way route rules that pick them
(pure functions of the plan or dtype, strides and pointers), the sources
the compiler renders, the GEMM's 64 x 64 blocks, chip_smoke.py's simt rows
and resources lines, and the attention kernel's order of sums (P V added into
the rescaled running output key by key) emulated in numpy against the JAX
package's Pallas kernel in interpret mode.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.core import backend_cuda, compile_gemm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TOL = 2e-5      # tests/test_kernels.py's f32 bound for flash attention


def _fn(dtype="float32", tiles=(128, 128, 128), m=256, n=384, k=640,
        schedule="tpu_mxu"):
    tm, tn, tk = tiles
    return compile_gemm(m, n, k, schedule=schedule, dtype=dtype,
                        tile={"m": tm, "n": tn, "k": tk},
                        want_torch=False).run_cuda


@pytest.mark.parametrize("prod", sorted(smoke.MLP))
@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
def test_smoke_f32_products_take_ffma(prod, schedule):
    """The smoke's f32 MLP products at tiles 128 go to ffma on contiguous
    operands, and on gemm_op's backward views (a.t(), b.t())."""
    m, n, k = smoke.MLP[prod]
    plan = _fn(m=m, n=n, k=k, schedule=schedule).plan
    for a_strides, b_strides, majors in (((k, 1), (n, 1), "A K-major, B N"),
                                         ((1, m), (n, 1), "A M-major, B N"),
                                         ((k, 1), (1, k), "A K-major, B K")):
        route, why = backend_cuda._gemm_route(plan, a_strides, b_strides,
                                              256, 512)
        assert route == "ffma" and majors in why, why


@pytest.mark.parametrize("dtype,tiles,a_strides,b_strides,a_ptr,want,why", [
    ("float32", (128, 128, 128), (640, 1), (384, 1), 0, "ffma", "K-major"),
    ("float32", (64, 64, 8), (640, 1), (384, 1), 0, "ffma", "tk % 8"),
    ("float32", (128, 128, 128), (644, 1), (384, 1), 0, "ffma", "A K-major"),
    ("float32", (128, 128, 128), (642, 1), (384, 1), 0, "simt",
     "A's stride 642 is not 16 bytes apart"),
    ("float32", (128, 128, 128), (640, 1), (384, 1), 4, "simt",
     "A's base is not 16-byte aligned"),
    ("float32", (128, 128, 128), (640, 2), (384, 1), 0, "simt",
     "A has no unit stride"),
    ("float32", (128, 128, 128), (640, 1), (384, 3), 0, "simt",
     "B has no unit stride"),
    ("float32", (128, 128, 4), (640, 1), (384, 1), 0, "simt",
     "tk 4 is not a multiple of 8"),
    ("bfloat16", (128, 128, 64), (640, 1), (384, 1), 0, "wgmma", "bf16"),
    ("bfloat16", (128, 128, 8), (640, 1), (384, 1), 0, "ffma",
     "tk 8 is not a multiple of 16"),
    ("bfloat16", (128, 128, 64), (640, 1), (384, 1), 8, "simt",
     "A's base is not 16-byte aligned"),
])
def test_gemm_route_three_ways(dtype, tiles, a_strides, b_strides, a_ptr,
                               want, why):
    """wgmma first, then ffma (tiles multiples of 64, tk of 8, one unit
    stride per operand and the other 16 bytes apart, 16-byte bases), then
    simt; the reason names what refused."""
    plan = _fn(dtype=dtype, tiles=tiles).plan
    route, reason = backend_cuda._gemm_route(plan, a_strides, b_strides,
                                             a_ptr, 0)
    assert route == want and why in reason, reason


@pytest.mark.parametrize("m,n,k", [(96, 96, 96), (131, 96, 64),
                                   (64, 127, 257)])
def test_odd_tiles_stay_simt(m, n, k):
    """cuda_gemm's tiles are the largest divisors up to 128: 96, or 1 for
    a prime dimension.  They take the plain CUDA-core template
    (stagecc_gemm.cuh), whose launcher alone the rendered source holds."""
    ck = gemm._build(m, n, k, "tpu_mxu_kgrid", "float32",
                     gemm._pick_tile(m), gemm._pick_tile(n),
                     gemm._pick_tile(k))
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    route, why = ck.run_cuda.route(a, b)
    assert route == "simt" and "not multiples of 64" in why
    assert "stagecc_gemm_ffma" not in ck.run_cuda.source


@pytest.mark.parametrize("schedule", ["tpu_mxu", "tpu_mxu_kgrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rendered_source_holds_the_ffma_launcher(schedule, dtype):
    """A plan at tiles 128 renders the ffma template's include, its
    launcher at the plan's tk and schedule and the smem query; the simt
    launcher stays beside it."""
    src = _fn(dtype=dtype, schedule=schedule).source
    kgrid = str(schedule.endswith("kgrid")).lower()
    t = "float" if dtype == "float32" else "__nv_bfloat16"
    assert '#include "stagecc_gemm_ffma.cuh"' in src
    assert "stagecc_gemm_ffma_launch" in src
    assert "stagecc_gemm_ffma_smem" in src
    assert f"launch_ffma<128, {kgrid}, {t}, {t}, float>" in src
    assert "stagecc::ffma::smem_bytes<128>()" in src
    assert "stagecc_gemm_launch" in src


def test_ffma_blocks_divide_what_the_route_takes():
    """The ffma route takes tiles that are multiples of 64, so the
    kernel's 64 x 64 blocks divide M and N of any product it takes."""
    fn = _fn(tiles=(64, 192, 8), m=128, n=384, k=64)
    assert backend_cuda._gemm_route(fn.plan, (64, 1), (384, 1))[0] == "ffma"
    assert "launch_ffma<8, false, float, float, float>" in fn.source


def test_shifted_inputs_are_contiguous_and_off_16_bytes():
    """chip_smoke.shifted: the same values, contiguous, one element past a
    16-byte boundary, so the 16-byte routes refuse them."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(24, dtype=dtype).reshape(2, 3, 4)
        y = smoke.shifted(x)
        assert torch.equal(y, x) and y.is_contiguous()
        assert y.data_ptr() % 16 == x.element_size()


def test_smoke_simt_gemm_row_routes_to_simt():
    """Phase 8's simt row: the product SIMT_GEMM names, an f32 one on the
    ffma route when aligned, goes to simt on shifted operands."""
    prod, schedule, dtype, epilogue = smoke.SIMT_GEMM
    assert smoke.SIMT_GEMM in smoke.GEMMS and dtype == "float32"
    m, n, k = smoke.MLP[prod]
    fn = _fn(m=m, n=n, k=k, schedule=schedule)
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    assert fn.route(a, b)[0] == "ffma"
    route, why = fn.route(smoke.shifted(a), smoke.shifted(b))
    assert route == "simt" and "not 16-byte aligned" in why, why


def test_smoke_simt_attention_row_routes_to_simt():
    """Phase 9's simt row: qwen2-7b's f32 call on shifted inputs."""
    from repro_torch.configs.base import get_config
    hd = get_config(smoke.ATTN[0][0]).resolved_head_dim
    q = smoke.shifted(torch.zeros(2, 8, hd))
    out = torch.empty_like(q)
    assert fa.route(torch.float32, hd, 0, 0, 0, out.data_ptr())[0] == "ffma"
    assert fa.route(torch.float32, hd, q.data_ptr(), q.data_ptr(),
                    q.data_ptr(), out.data_ptr())[0] == "simt"


def test_cpu_run_on_the_ffma_route_launches_nothing():
    """On CPU tensors the callable runs gemm_plain: no counter moves, the
    route the card would take is ffma, and the bracket holds."""
    fn = _fn()
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((256, 640))).float()
    b = torch.from_numpy(rng.standard_normal((640, 384))).float()
    cg = gemm.cuda_gemm
    before = (cg.launches, cg.wgmma_launches, cg.ffma_launches)
    got = fn(a, b)
    assert (cg.launches, cg.wgmma_launches, cg.ffma_launches) == before
    assert fn.route(a, b)[0] == "ffma"
    assert torch.equal(got, backend_cuda.gemm_plain(fn.plan, a, b))


@pytest.mark.parametrize("dtype,d,ptrs,want", [
    (torch.float32, 128, (0, 0, 0, 0), "ffma"),
    (torch.float32, 256, (0, 0, 0, 0), "ffma"),
    (torch.float32, 20, (0, 0, 0, 0), "ffma"),       # zero-filled to 64
    (torch.float32, 130, (0, 0, 0, 0), "simt"),      # not a multiple of 4
    (torch.float32, 264, (0, 0, 0, 0), "simt"),      # above 256: slices
    (torch.float32, 128, (0, 0, 0, 4), "simt"),      # out not aligned
    (torch.bfloat16, 128, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 72, (0, 0, 0, 0), "simt"),      # off the tensor cores
    (torch.float16, 128, (0, 0, 0, 0), "simt"),
])
def test_flash_route_three_ways(dtype, d, ptrs, want):
    assert fa.route(dtype, d, *ptrs)[0] == want


def test_route_of_reads_the_counter_that_moved():
    class W:
        wgmma_launches = ffma_launches = 0
    w = W()
    assert smoke.route_of(w, (0, 0)) == "simt"
    w.ffma_launches = 1
    assert smoke.route_of(w, (0, 0)) == "ffma"
    w.wgmma_launches = 1
    assert smoke.route_of(w, (0, 1)) == "wgmma"


def test_ptxas_rows_reads_every_kind(tmp_path, monkeypatch):
    """chip_smoke.ptxas_rows finds the tensor-core and ffma kernels of a
    build log (nvcc -Xptxas -v) by their mangled names."""
    names = [
        "_ZN7stagecc4ffma16gemm_ffma_kernelILi128ELb1EffN12_GLOBAL__N_1"
        "8EpilogueEEEvPKT1_",
        "_ZN12_GLOBAL__N_117flash_ffma_kernelILi256EEEvPKfS2_S2_Pf",
        "_ZN12_GLOBAL__N_117flash_sm90_kernelILi128EEEvv",
        "_ZN7stagecc11gemm_kernelILi96ELi96ELi96ELb0EffEEvv",   # simt: no row
    ]
    log = "".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {n}\n"
        f"    0 bytes stack frame, {i} bytes spill stores, {2 * i} bytes "
        f"spill loads\n"
        f"ptxas info    : Used {100 + i} registers, used 1 barriers\n"
        for i, n in enumerate(names))
    lib = tmp_path / "libx.so"
    lib.with_suffix(".ptxas.txt").write_text(log)
    assert smoke.ptxas_rows(lib) == [
        ("gemm_ffma", (128, 1), 100, 0, 0),
        ("flash_ffma", (256,), 101, 1, 2),
        ("flash_sm90", (128,), 102, 2, 4)]


def _ffma_attention(q, k, v, *, causal, window, bk=64):
    """The ffma attention kernel's arithmetic in numpy, f32: key tiles of
    64, scores scaled by scale log2(e) with exp2, statistics per row, and
    per tile acc = acc corr, then acc += p_j v_j key by key (no separate
    per-tile P V sum); output acc / max(l, 1e-30)."""
    f32 = np.float32
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale2 = f32(1.0 / math.sqrt(d)) * f32(1.4426950408889634)
    qpos = np.arange(sq)[:, None] + sk - sq
    m = np.full((bh, sq, 1), -1e30, f32)
    l = np.zeros((bh, sq, 1), f32)
    acc = np.zeros((bh, sq, d), f32)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = np.einsum("bqd,bkd->bqk", q, kt).astype(f32)
        kpos = np.arange(k0, k0 + kt.shape[1])[None, :]
        keep = np.ones((sq, kt.shape[1]), bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = np.where(keep, s * scale2, f32(-1e30)).astype(f32)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        p = np.exp2(s - m_new).astype(f32)
        corr = np.exp2(m - m_new).astype(f32)
        l = (l * corr + p.sum(-1, keepdims=True, dtype=f32)).astype(f32)
        acc = (acc * corr).astype(f32)
        for j in range(kt.shape[1]):
            acc = (acc + p[:, :, j:j + 1] * vt[:, j:j + 1, :]).astype(f32)
        m = m_new
    return acc / np.maximum(l, f32(1e-30))


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", [
    (2, 128, 192, 64, True, None),       # Sk > Sq, causal
    (1, 256, 256, 32, True, 96),         # a window: tiles skipped
    (1, 128, 128, 128, False, None),     # non-causal
    (1, 64, 128, 16, True, 0),           # every row masked: mean of V
])
def test_ffma_attention_order_against_jax(bh, sq, sk, d, causal, window):
    """The kernel's order of sums (P V folded into the rescaled output,
    key by key) stays within the 2e-5 gate of the JAX kernel in f32
    (interpret mode), and of the port's plain version."""
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d)))
    got = _ffma_attention(q, k, v, causal=causal, window=window)
    want = np.array(jax_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window,
                              block_q=64, block_k=64))
    assert np.abs(got - want).max() <= TOL
    plain = fa.flash_attention_plain(*(torch.from_numpy(x)
                                       for x in (q, k, v)),
                                     causal=causal, window=window)
    assert np.abs(got - plain.numpy()).max() <= TOL
