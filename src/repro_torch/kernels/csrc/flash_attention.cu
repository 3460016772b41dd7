// Blocked (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (wrapper `flash_attention`, pallas_call at line 97) and computes its
// function: q (BH, Sq, D), k/v (BH, Sk, D), all contiguous, f32 or bf16;
// logits q.k * scale; query row i sits at position qpos = i + (Sk - Sq);
// causal keeps keys kpos <= qpos, a window keeps kpos > qpos - window;
// masked logits are -1e30 (not -inf), so a row masked everywhere returns
// the mean of V; online softmax with f32 statistics (m, l, acc), output
// acc / max(l, 1e-30) in the input type.
//
// Arithmetic: IEEE f32 on the CUDA cores, products and statistics alike
// (bf16 inputs are widened on load).  No TF32, no tensor cores.  This file
// takes what flash_attention.route sends neither to flash_attention_sm90.cu
// (bf16 on the tensor cores) nor to flash_attention_ffma.cu (f32 with a
// head dim that is a multiple of 4 up to 256): head dims above 256, f32
// head dims that are not a multiple of 4, bf16 head dims that are not a
// multiple of 16, and data that is not 16-byte aligned.
//
// Head dims above 256: Q, K and V tiles of the whole width would not fit
// in shared memory, so the launcher runs the output in column slices of
// at most 256 (kSliced): each block computes S over all of D, 256 columns
// of Q and K at a time, and accumulates only its slice of V and the
// output.  Each slice redoes S; its sums are those of the unsliced kernel.
//
// What bounds it: at qwen2-7b's widths (Sq = Sk = 2048, D = 128, causal)
// the function does 120 GFLOP on 470 MB, ~250 flops per byte of HBM, far
// above the ~20 the card's f32 CUDA cores need per byte.  So the least
// time is the unmasked pairs' 4·D flops each over the 67 TFLOP/s f32
// rate (1.8 ms there), and the design spends shared-memory bandwidth,
// not HBM bytes: one head's K/V (2 MB) stays in L2 across its query
// tiles, each loaded K/V tile serves 64 query rows, a 64-row query
// tile stays in shared memory for the whole key loop, each thread keeps a
// 4 x 2 tile of scores and a 4 x D/16 tile of the output in registers,
// and reads its operands as float4 from rows padded by 4 floats, so a
// quarter-warp's 16-byte reads fall in distinct banks.
//
// Design: one block of 256 threads per (bh, 64-row query tile), looping
// over keys in tiles of 32; bh is the grid's y axis, launched in slices of
// at most 65535 (its limit), each slice's arrays offset to its first bh.
// The TPU kernel's 128 x 128 VMEM blocks do not carry over: at D = 256
// three 128 x 256 f32 tiles alone are 384 KB, against 227 KB of shared
// memory per block.  Its sequential kv grid axis,
// with acc/m/l in VMEM scratch, becomes the in-block key loop, with m and
// l in registers.  Per tile: (1) S = Q K^T, one 4 x 2 block per thread;
// (2) mask, scale and the online-softmax update, the 32 scores of a row
// lying in the 16 lanes of one half-warp; (3) acc = acc * corr + P V, the
// tile's P V summed on its own first, as the reference does.
//
// Tiles masked for every row of the block are skipped where that leaves
// the result exactly as it is (attention_mask.cuh, shared with the other
// two attention kernels).  The block index runs over the query tiles from
// the last (the longest under a causal mask) to the first, to even out the
// tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block: 16 thread rows x 4
constexpr int kBK = 32;  // keys per tile: 16 thread columns x 2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// reductions over the 16 lanes of a half-warp (one query row's scores)
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

// Copy `rows` rows of d elements from src (row stride sld) to dst (row
// stride ld, d rounded up to 4), zero past `valid` rows and past d.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int sld, int rows, int valid, int d,
                                          int d4) {
  for (int e = threadIdx.x; e < rows * d4; e += kThreads) {
    const int r = e / d4, c = e - r * d4;
    dst[r * ld + c] =
        (r < valid && c < d) ? to_f32(src[(long long)r * sld + c]) : 0.f;
  }
}

// kSliced: the head dim d may exceed kDMax.  Q and K rows have stride
// ld_arg (= d); the block computes S over all of d, kDMax columns at a
// time, Q's chunk loaded again for each key tile, and P V over the dv_arg
// (at most kDMax) columns of V and the output that `v` and `out` point at
// (row stride ld_arg).  Without it, ld = dv = d and Q stays in shared
// memory for the whole key loop.
template <typename T, int kDMax, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int sk, int d, int ld_arg, int dv_arg,
                           float scale, Mask mk) {
  constexpr int kG = kDMax / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  const int ld = kSliced ? ld_arg : d;     // row stride of q, k, v, out
  const int dv = kSliced ? dv_arg : d;     // columns of V and out
  const int d4 = kSliced ? kDMax : (d + 3) / 4 * 4;  // Q / K columns held
  const int dv4 = (dv + 3) / 4 * 4;
  const int dp = d4 + 4;  // padded row stride of Q and K
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][dp]
  float* k_s = q_s + kBQ * dp;                   // [kBK][dp]
  float* v_s = k_s + kBK * dp;                   // [kBK][dv4]
  float* p_s = v_s + kBK * dv4;                  // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qb = q + (bh * sq + q0) * ld;
  const T* kb = k + bh * sk * ld;
  const T* vb = v + bh * sk * ld;
  if (!kSliced) load_tile(q_s, dp, qb, ld, kBQ, sq - q0, d, d4);

  const int rows = min(kBQ, sq - q0);
  int k_begin, k_end;
  attn::key_tiles<kBK>(q0, rows, sk, mk, k_begin, k_end);

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    if (!kSliced)
      load_tile(k_s, dp, kb + (long long)k0 * ld, ld, kBK, sk - k0, d, d4);
    load_tile(v_s, dv4, vb + (long long)k0 * ld, ld, kBK, sk - k0, dv, dv4);
    __syncthreads();

    // (1) scores of rows ty + 16i, keys tx + 16j, over the w4 columns
    // of Q and K held
    float s[4][2] = {};
    auto scores = [&](int w4) {
      for (int c = 0; c < w4; c += 4) {
        float4 kv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * dp +
                                                   c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * dp + c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
    };
    if constexpr (kSliced) {
      for (int c0 = 0; c0 < d; c0 += d4) {
        const int w = min(d4, d - c0), w4 = (w + 3) / 4 * 4;
        __syncthreads();  // the last chunk's Q and K are no longer read
        load_tile(q_s, dp, qb + c0, ld, kBQ, sq - q0, w, w4);
        load_tile(k_s, dp, kb + (long long)k0 * ld + c0, ld, kBK, sk - k0, w,
                  w4);
        __syncthreads();
        scores(w4);
      }
    } else {
      scores(d4);
    }

    // (2) mask and the online-softmax update
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty + 16 * i + mk.offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        // a key past Sk does not exist: weight exactly 0
        s[i][j] = key >= sk ? -INFINITY
                  : allowed(qpos, key, mk) ? s[i][j] * scale
                                           : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + half_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    // (3) acc = acc * corr + P V over columns 4 tx + 64 g
    float pv[4][4 * kG] = {};
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int col = 4 * tx + 64 * g;
        if (col < dv4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + j * dv4 + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i][4 * g + 0] = fmaf(p[i], vv.x, pv[i][4 * g + 0]);
            pv[i][4 * g + 1] = fmaf(p[i], vv.y, pv[i][4 * g + 1]);
            pv[i][4 * g + 2] = fmaf(p[i], vv.z, pv[i][4 * g + 2]);
            pv[i][4 * g + 3] = fmaf(p[i], vv.w, pv[i][4 * g + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c)
        acc[i][c] = acc[i][c] * corr[i] + pv[i][c];
  }

  T* ob = out + (bh * sq + q0) * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < dv)
          store(ob + (long long)r * ld + col, acc[i][4 * g + e] / denom);
      }
  }
}

// One launch per slice of at most 65535 heads; with kSliced, one per
// slice of heads and of at most kDMax output columns.
template <typename T, int kDMax, bool kSliced = false>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, float scale, Mask mk, cudaStream_t stream) {
  const int d4 = kSliced ? kDMax : (d + 3) / 4 * 4;
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (d4 + 4) + kBK * d4 + kBQ * (kBK + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, kDMax, kSliced>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return attn::bh_slices(bh, [&](int b0, int n) {
    const dim3 grid((sq + kBQ - 1) / kBQ, n);
    const long long oq = (long long)b0 * sq * d, ok = (long long)b0 * sk * d;
    for (int c0 = 0; c0 < d; c0 += kSliced ? kDMax : d) {
      const int dv = d - c0 < kDMax ? d - c0 : kDMax;
      flash_attention_kernel<T, kDMax, kSliced>
          <<<grid, kThreads, smem, stream>>>(
              static_cast<const T*>(q) + oq, static_cast<const T*>(k) + ok,
              static_cast<const T*>(v) + ok + c0,
              static_cast<T*>(out) + oq + c0, sq, sk, d, d, dv, scale, mk);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  });
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, float scale, Mask mk,
             cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, bh, sq, sk, d, scale, mk, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, bh, sq, sk, d, scale, mk, stream);
  if (d <= 256)
    return launch<T, 256>(q, k, v, out, bh, sq, sk, d, scale, mk, stream);
  return launch<T, 256, true>(q, k, v, out, bh, sq, sk, d, scale, mk, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window is read only if has_window.
// Returns cudaGetLastError() after the launch (0 on success).  Launches on
// `stream` and does not synchronise.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int bh, int sq, int sk,
                                      int d, int causal, int has_window,
                                      long long window, float scale,
                                      void* stream) {
  const Mask mk{causal, has_window, window, (long long)sk - sq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, bh, sq, sk, d, scale, mk, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, scale, mk,
                                   s);
  return (int)cudaErrorInvalidValue;
}
