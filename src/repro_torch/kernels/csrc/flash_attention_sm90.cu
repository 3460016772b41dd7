// Blocked (flash) attention for Hopper's tensor cores (sm_90a), bf16.
//
// Replaces, for bf16 inputs with a head dim D that is a multiple of 16 up
// to 256, the TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (wrapper `flash_attention`, pallas_call at line 97); flash_attention.cu
// keeps f32 and the other head dims.  The function is that file's: q (BH,
// Sq, D), k/v (BH, Sk, D), contiguous; query row i at position
// i + (Sk - Sq); causal and window masks; masked logits -1e30, keys past
// Sk weight 0; online softmax with f32 statistics; output
// acc / max(l, 1e-30) in bf16.
//
// Arithmetic: S = Q K^T by wgmma, bf16 products summed in f32; scale, mask
// and the softmax update in f32 registers, on S's accumulator fragment, in
// base 2 (scores scaled by scale log2(e), exp2f: one MUFU.EX2 each); a
// tile that every row of a warpgroup sees whole skips the mask.
// P V must keep P's f32 accuracy (the bf16 gate holds the output to
// 2^-8 |want| + 2e-5 of the f32 version, and rounding P to bf16 alone
// moves near-zero outputs by ~4e-5), so P = P_hi + P_lo with P_hi =
// bf16(P), P_lo = bf16(P - P_hi), and O = O corr + P_hi V + P_lo V: two
// register-sourced wgmmas per k16 step, an error near 2^-17 of P.
//
// What bounds it: at qwen2-7b's widths the function does 120 GFLOP of
// unmasked pairs on 470 MB, so the least time is the flops over the
// bf16 tensor-core rate; split P makes P V twice the tensor work.
// Design: one block of 384 threads per (bh, 128-row query tile), the
// query tiles walked from the last (the longest under a causal mask).
// Warpgroup 0 is the producer: one thread loads the block's Q once and
// streams K and V tiles of 64 keys through a 2-stage ring by TMA (3-D
// tensor maps over (D, S, BH), 128-byte swizzle, boxes of 64 columns; a
// head dim that is not a multiple of 64 is zero-filled to the next, whose
// columns add nothing to S and are not stored), with full / empty
// mbarriers.  Warpgroups 1 and 2 own 64 query rows each: S (64 x 64) by
// m64n64k16 wgmmas from shared memory, the softmax on its fragment (a row
// spread over the 4 lanes of a quad), then P_hi / P_lo repacked from that
// fragment as the A operand of m64n64k16 wgmmas over each 64-column chunk
// of O, with V read MN-major through the transpose bit.  Each warpgroup
// waits for its S and its P V in turn; the other warpgroup keeps the
// tensor cores busy meanwhile.  (Issuing the next tile's S before the
// softmax, into a second register set, ran slower on an H100.)
//
// Kept from flash_attention.cu (attention_mask.cuh): the masks, the exact
// whole-tile skips (a row masked everywhere averages all of V, so then
// every tile is walked), and the bh axis in launches of at most 65535
// blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mask.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWG = 2;                 // consumer warpgroups
constexpr int kBQ = 64 * kWG;          // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kStages = 2;             // K / V ring stages
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kQChunk = kBQ * 128;     // bytes of 64 columns of Q
constexpr int kKVChunk = kBK * 128;    // bytes of 64 columns of a K / V tile

using attn::allowed;
using attn::kNeg;
using attn::Mask;

// the score of key `key` for the query at `qpos`, scaled and masked
__device__ __forceinline__ float masked(float s, long long qpos,
                                        long long key, int sk, float scale,
                                        const Mask& mk) {
  return key >= sk ? -INFINITY : allowed(qpos, key, mk) ? s * scale : kNeg;
}

// whether every query in [q_first, q_last] may attend every key of the
// tile at k0, all of them below sk: then the tile needs no mask
__device__ __forceinline__ bool whole_tile(long long q_first,
                                           long long q_last, int k0, int sk,
                                           const Mask& mk) {
  return k0 + kBK <= sk && (!mk.causal || k0 + kBK - 1 <= q_first) &&
         (!mk.has_window || k0 > q_last - mk.window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DP>
constexpr int smem_bytes() {
  return (DP / 64) * (kQChunk + 2 * kStages * kKVChunk) +
         (1 + 2 * kStages) * 8 + 1024;
}

// DP: the head dim rounded up to 64, 128 or 256
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int bh0, int sq,
                      int sk, int d, float scale, Mask mk) {
  constexpr int kC = DP / 64;          // 64-column chunks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                              // [kC][kBQ][64]
  uint8_t* k_s = q_s + kC * kQChunk;                // [kStages][kC][kBK][64]
  uint8_t* v_s = k_s + kStages * kC * kKVChunk;     // likewise
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kC * kKVChunk);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = bh0 + blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int nch = (d + 63) / 64;

  // the key tiles to walk (attention_mask.cuh)
  const int rows = min(kBQ, sq - q0);
  int k_begin, k_end;
  attn::key_tiles<kBK>(q0, rows, sk, mk, k_begin, k_end);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kWG);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(qbar, nch * kQChunk);
      for (int c = 0; c < nch; ++c)
        sm90::tma_load_3d(q_s + c * kQChunk, &tq, qbar, 64 * c, q0, bh);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], 2 * nch * kKVChunk);
        const int k0 = k_begin + i * kBK;
        for (int c = 0; c < nch; ++c) {
          const int off = (s * kC + c) * kKVChunk;
          sm90::tma_load_3d(k_s + off, &tk, &full[s], 64 * c, k0, bh);
          sm90::tma_load_3d(v_s + off, &tv, &full[s], 64 * c, k0, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w = wg - 1 owns query rows q0 + 64 w ..
  sm90::setmaxnreg_inc<240>();
  const int w = wg - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row_a = q0 + 64 * w + 16 * warp + lane / 4;  // and row_a + 8
  const long long qpos_a = row_a + mk.offset, qpos_b = qpos_a + 8;
  const long long q_first = q0 + 64 * w + mk.offset, q_last = q_first + 63;
  // the softmax runs in base 2: exp(x - m) = 2^(x log2(e) - m log2(e)),
  // so the scores are scaled by scale log2(e) and exp2f is one MUFU.EX2;
  // a masked score stays -1e30, as in the reference
  const float scale2 = scale * 1.4426950408889634f;
  const int steps = d / 16;            // k16 steps of Q K^T

  float o[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c) sm90::zero(o[c]);
  float sc[32];
  sm90::zero(sc);
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
  const uint32_t q_addr = sm90::smem_u32(q_s) + w * 64 * 128;
  sm90::mbar_wait(qbar, 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kBK;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t k_addr = sm90::smem_u32(k_s + s * kC * kKVChunk);
    const uint32_t v_addr = sm90::smem_u32(v_s + s * kC * kKVChunk);

    // (1) S = Q K^T, 64 x 64, both operands K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      if (t < steps)
        sm90::wgmma_ss_m64n64k16<0, 0>(
            sc,
            sm90::desc_sw128(q_addr + (t / 4) * kQChunk + (t % 4) * 32, 16,
                             1024),
            sm90::desc_sw128(k_addr + (t / 4) * kKVChunk + (t % 4) * 32, 16,
                             1024),
            t > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // (2) mask, scale and the online-softmax update; element 4 j + 2 i + e
    // is row a (i = 0) or a + 8 (i = 1), key k0 + 8 j + 2 (lane % 4) + e
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (whole_tile(q_first, q_last, k0, sk, mk)) {  // most tiles: no mask
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale2;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long key = k0 + 8 * j + 2 * (lane % 4) + e;
          sc[4 * j + e] = masked(sc[4 * j + e], qpos_a, key, sk, scale2, mk);
          sc[4 * j + 2 + e] =
              masked(sc[4 * j + 2 + e], qpos_b, key, sk, scale2, mk);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_a);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_b);
        sum_a += sc[4 * j + e];
        sum_b += sc[4 * j + 2 + e];
      }
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= corr_a;
        o[c][4 * j + 1] *= corr_a;
        o[c][4 * j + 2] *= corr_b;
        o[c][4 * j + 3] *= corr_b;
      }

    // (3) P = P_hi + P_lo as wgmma A fragments: k16 step t's registers
    // are the S fragment's elements 8 t .. 8 t + 7, in pairs
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[8 * t + 2 * r], y = sc[8 * t + 2 * r + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(h);
        p_hi[t][r] = as_u32(h);
        p_lo[t][r] = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
      }

    // (4) O += P_hi V + P_lo V per 64-column chunk; V is MN-major
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < nch)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t dv = sm90::desc_sw128(
              v_addr + c * kKVChunk + t * 2048, kKVChunk, 1024);
          sm90::wgmma_rs_m64n64k16<1>(o[c], p_hi[t], dv, 1);
          sm90::wgmma_rs_m64n64k16<1>(o[c], p_lo[t], dv, 1);
        }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) sm90::fence_regs(o[c]);
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= sq) continue;
    const float den = i ? den_b : den_a;
    __nv_bfloat16* orow = out + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * (lane % 4);
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * i] / den,
                                    o[c][4 * j + 2 * i + 1] / den);
      }
  }
}

// a (D, S, BH) bf16 tensor map with boxes of 64 columns x `rows` rows
int encode(CUtensorMap* map, const void* base, int d, int s, int bh,
           int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return sm90::encode_bf16(map, base, 3, dims, strides, box);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, float scale, Mask mk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, sq, bh, kBQ);
  if (!err) err = encode(&tk, k, d, sk, bh, kBK);
  if (!err) err = encode(&tv, v, d, sk, bh, kBK);
  if (err) return err;
  constexpr int smem = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  return attn::bh_slices(bh, [&](int b0, int n) {
    flash_sm90_kernel<DP><<<dim3((sq + kBQ - 1) / kBQ, n), kThreads, smem,
                            stream>>>(tq, tk, tv,
                                      static_cast<__nv_bfloat16*>(out), b0,
                                      sq, sk, d, scale, mk);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// bf16 q/k/v/out, contiguous, 16-byte-aligned, d a multiple of 16 up to
// 256 (kernels/flash_attention.py checks).  window is read only if
// has_window.  Returns 0, a cudaError, or 1000 + a CUresult from encoding
// the tensor maps.  Launches on `stream` and does not synchronise.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int bh,
                                           int sq, int sk, int d, int causal,
                                           int has_window, long long window,
                                           float scale, void* stream) {
  const Mask mk{causal, has_window, window, (long long)sk - sq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 16 || d <= 0 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch<64>(q, k, v, out, bh, sq, sk, d, scale, mk, s);
  if (d <= 128) return launch<128>(q, k, v, out, bh, sq, sk, d, scale, mk, s);
  return launch<256>(q, k, v, out, bh, sq, sk, d, scale, mk, s);
}

// The dynamic shared memory a launch at head dim d asks for, in bytes.
extern "C" int flash_attention_sm90_smem(int d) {
  return d <= 64 ? smem_bytes<64>() : d <= 128 ? smem_bytes<128>()
                                               : smem_bytes<256>();
}
