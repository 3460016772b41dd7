// Blocked (flash) attention for the H100's CUDA cores (sm_90a), f32.
//
// Replaces, for f32 inputs with a head dim D that is a multiple of 4 up to
// 256, the TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (line 34; wrapper `flash_attention`, pallas_call at line 97);
// flash_attention_sm90.cu takes bf16 on the tensor cores, and
// flash_attention.cu the rest.  The function is flash_attention.cu's: q
// (BH, Sq, D), k/v (BH, Sk, D), contiguous; query row i at position
// i + (Sk - Sq); causal keeps keys kpos <= qpos, a window keeps kpos >
// qpos - window; masked logits -1e30 (a row masked everywhere returns the
// mean of V), keys past Sk weight exactly 0; online softmax with f32
// statistics; output acc / max(l, 1e-30).
//
// Arithmetic: IEEE f32 FFMA on the CUDA cores, no TF32 and no tensor
// cores.  The softmax runs in base 2: scores scaled by scale log2(e),
// exp2f.  Per key tile the running output is rescaled by corr and the
// tile's P V is added into it key by key (acc = acc corr, then acc +=
// p v per key), without a separate per-tile sum: the plain version is
// the whole softmax at once, so no order of these sums is the reference's,
// and the 2e-5 bound holds either way (tests/test_torch_ffma.py emulates
// this order against the JAX kernel).
//
// What bounds it: at qwen2-7b's widths (Sq = Sk = 2048, D = 128, causal)
// the function does 120 GFLOP of unmasked pairs on 470 MB, ~250 flops per
// byte, far above the ~20 the f32 CUDA cores need per byte of HBM, so the
// least time is the flops over 67 TFLOP/s (1.8 ms).  flash_attention.cu
// reads 6 float4 per 32 FFMAs in q.k and loads K and V synchronously with
// three barriers per 32-key tile.  Here:
//   * tiles of BQ query rows x BK = 64 keys per 256-thread block: 128 rows
//     at D <= 128, 64 at D = 256, so that Q, one K tile, one V tile and P
//     fit in shared memory (two blocks per SM at D <= 64);
//   * each thread owns 4 BQ / 64 query rows (two runs of 4 rows, 64 apart,
//     at BQ = 128) for all of S, the softmax and the output: S as
//     rows x 4 keys (tx + 16 j, the 16 threads of a half-warp covering a
//     row's 64 keys, so the row max and sum are shuffles), the output as
//     rows x D / 16 columns in runs of 4;
//   * P is written to shared memory transposed, so P V is an outer product
//     per key: 2 + D / 64 float4 shared loads per 4 D / 16 BQ / 16 FFMAs
//     (4 per 64 at D = 128);
//   * K and V arrive by cp.async: V of this tile while S is computed, K of
//     the next while P V is, with two barriers per tile; rows past Sq / Sk
//     and columns past D are zero-filled by the copy.
// Tried on an H100 and slower or no faster (PERF.md): 8 threads per row,
// 512 threads per block, the S loop unrolled over all of D, and skipping
// the mask on tiles every row may attend whole.
// Shared rows of Q, K and P are padded by 4 floats, so the 8 threads of a
// quarter-warp reading 8 rows fall in distinct banks.
//
// Kept from flash_attention.cu (attention_mask.cuh): the masks, the exact
// whole-tile skips, and the bh axis in launches of at most 65535 blocks;
// the blocks walk the query tiles from the last (the longest under a
// causal mask).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_mask.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per tile: 16 thread columns x 4
constexpr float kLog2e = 1.4426950408889634f;

// reductions over the 16 lanes of a half-warp (one query row)
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

using attn::allowed;
using attn::kNeg;
using attn::Mask;

// Tiles per padded head dim DP: BQ query rows, and the floats of shared
// memory: Q [BQ][DP + 4], K [kBK][DP + 4], V [kBK][DP], P^T [kBK][BQ + 4].
template <int DP>
__host__ __device__ constexpr int block_q() {
  return DP == 256 ? 64 : 128;
}

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (block_q<DP>() * (DP + 4) + kBK * (DP + 4) + kBK * DP +
              kBK * (block_q<DP>() + 4));
}

// Copy rows [0, rows) of src (row stride d) into dst (row stride ld), DP
// columns, by cp.async; zero-fill rows from `valid` and columns from d.
template <int DP>
__device__ __forceinline__ void fill(float* dst, int ld, const float* src,
                                     int rows, int valid, int d) {
  for (int e = threadIdx.x; e < rows * (DP / 4); e += kThreads) {
    const int r = e / (DP / 4), c = 4 * (e % (DP / 4));
    const bool in = r < valid && c < d;
    cpa::copy16(dst + r * ld + c, in ? src + (long long)r * d + c : src,
                in ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
    flash_ffma_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int sq, int sk, int d, float scale2, Mask mk) {
  constexpr int BQ = block_q<DP>();
  constexpr int TX = 16, TY = kThreads / TX;  // threads along, down the rows
  constexpr int RQ = BQ / TY;        // query rows per thread, runs of 4
  constexpr int KJ = kBK / TX;       // keys per thread
  constexpr int CG = DP / (4 * TX);  // runs of 4 output columns per thread
  constexpr int LQ = DP + 4, LK = DP + 4, LV = DP, LP = BQ + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][LQ]
  float* k_s = q_s + BQ * LQ;                    // [kBK][LK]
  float* v_s = k_s + kBK * LK;                   // [kBK][LV]
  float* p_s = v_s + kBK * LV;                   // [kBK][LP], P transposed

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  // the thread's query rows: run i / 4 of 4 rows at 4 TY (i / 4) + 4 ty
  auto row = [&](int i) { return (i / 4) * 4 * TY + ty * 4 + i % 4; };

  const int rows = min(BQ, sq - q0);
  int k_begin, k_end;
  attn::key_tiles<kBK>(q0, rows, sk, mk, k_begin, k_end);

  fill<DP>(q_s, LQ, q + (bh * sq + q0) * d, BQ, rows, d);
  fill<DP>(k_s, LK, kb + (long long)k_begin * d, kBK, sk - k_begin, d);
  cpa::commit();

  float m[RQ], l[RQ], acc[RQ][4 * CG];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    cpa::wait<0>();   // this thread's copies of K (and Q) have landed
    __syncthreads();  // everyone's have; V and P of the last tile are read
    fill<DP>(v_s, LV, vb + (long long)k0 * d, kBK, sk - k0, d);
    cpa::commit();

    // (1) S = Q K^T: rows row(i), keys tx + TX j, over the d columns
    float s[RQ][KJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      float4 kv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + TX * j) * LK + c);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + row(i) * LQ + c);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // (2) mask, scale and the online-softmax update; P^T to shared memory
    float corr[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const long long qpos = q0 + row(i) + mk.offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = k0 + tx + TX * j;
        // a key past Sk does not exist: weight exactly 0
        s[i][j] = key >= sk ? -INFINITY
                  : allowed(qpos, key, mk) ? s[i][j] * scale2
                                           : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      corr[i] = exp2f(m[i] - m_new);
      l[i] = l[i] * corr[i] + half_sum(sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int g = 0; g < RQ / 4; ++g)
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        *reinterpret_cast<float4*>(p_s + (tx + TX * j) * LP + g * 4 * TY +
                                   ty * 4) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);
    cpa::wait<0>();   // this thread's copies of V have landed
    __syncthreads();  // everyone's have, and P is written; K is read
    if (k0 + kBK < k_end)
      fill<DP>(k_s, LK, kb + (long long)(k0 + kBK) * d, kBK,
               sk - k0 - kBK, d);
    cpa::commit();

    // (3) acc = acc corr, then += P V key by key: columns 4 TX g + 4 tx + e
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[RQ];
#pragma unroll
      for (int g = 0; g < RQ / 4; ++g) {
        const float4 pp =
            *reinterpret_cast<const float4*>(p_s + j * LP + g * 4 * TY +
                                             ty * 4);
        p[4 * g] = pp.x;
        p[4 * g + 1] = pp.y;
        p[4 * g + 2] = pp.z;
        p[4 * g + 3] = pp.w;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + j * LV + g * 4 * TX +
                                             tx * 4);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          acc[i][4 * g] = fmaf(p[i], vv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

  float* ob = out + (bh * sq + q0) * d;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = row(i);
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = g * 4 * TX + tx * 4;
      if (c < d)
        *reinterpret_cast<float4*>(ob + (long long)r * d + c) = make_float4(
            acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
            acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
    }
  }
}

// One launch per slice of at most 65535 heads.
template <int DP>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int sq, int sk, int d, float scale2, Mask mk,
           cudaStream_t stream) {
  auto kern = flash_ffma_kernel<DP>;
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = block_q<DP>();
  return attn::bh_slices(bh, [&](int b0, int n) {
    const long long oq = (long long)b0 * sq * d, ok = (long long)b0 * sk * d;
    kern<<<dim3((sq + BQ - 1) / BQ, n), kThreads, smem, stream>>>(
        q + oq, k + ok, v + ok, out + oq, sq, sk, d, scale2, mk);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// f32, d a multiple of 4 up to 256, 16-byte-aligned data (the caller,
// flash_attention.route, has checked).  window is read only if has_window.
// Returns cudaGetLastError() after the launch (0 on success).  Launches on
// `stream` and does not synchronise.
extern "C" int flash_attention_ffma_launch(const void* q, const void* k,
                                           const void* v, void* out, int bh,
                                           int sq, int sk, int d, int causal,
                                           int has_window, long long window,
                                           float scale, void* stream) {
  const Mask mk{causal, has_window, window, (long long)sk - sq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const float scale2 = scale * kLog2e;
  if (d <= 0 || d % 4 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return launch<64>(qf, kf, vf, of, bh, sq, sk, d, scale2, mk, s);
  if (d <= 128)
    return launch<128>(qf, kf, vf, of, bh, sq, sk, d, scale2, mk, s);
  return launch<256>(qf, kf, vf, of, bh, sq, sk, d, scale2, mk, s);
}

// the dynamic shared memory a launch at head dim d asks for, in bytes
extern "C" int flash_attention_ffma_smem(int d) {
  return d <= 64 ? smem_bytes<64>() : d <= 128 ? smem_bytes<128>()
                                               : smem_bytes<256>();
}
