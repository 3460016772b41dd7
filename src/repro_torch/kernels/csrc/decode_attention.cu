// Decode attention for Hopper (sm_90a): one query token per sequence
// attends a partly filled KV cache; the `rep` query heads of a GQA group
// share one KV head.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (wrapper `decode_attention`, pallas_call at line 81) and computes its
// function: scores q.k / sqrt(hd), positions at or past valid[b] set to
// -1e30 (not -inf), softmax statistics in f32, output acc / max(l, 1e-30)
// in the input type (f32 or bf16).  A row with valid == 0 has every
// position masked, so its output is the mean of V over all Smax rows.
//
// Layout: q (B, KV, rep, hd); k/v (B, KV, Smax, hd) read through the
// element strides given (the caller passes a transposed view of its
// (B, Smax, KV, hd) cache, never a copy); out (B, KV, rep, hd) contiguous;
// valid (B,) int32.  The innermost (hd) stride must be 1.
//
// What bounds it: one query token against the cache is ~2 flops per byte
// of K/V read, far below the card's ~20 (f32 CUDA cores) or ~295 (bf16
// tensor cores) flops per byte, so the least time is the K/V bytes of the
// valid positions over the memory rate.  The design reads each of those
// bytes once: positions past `valid` contribute exactly 0 and are never
// read, K rows are read whole by one warp, V rows by consecutive threads,
// and the query rows, scores and accumulators stay in shared memory.
//
// Design: one block per (b, kv-group), looping over the cache in tiles of
// `tile` positions, with the group's `rep` query rows together in the
// block.  Per tile: (1) scores, one warp per key; (2) online-softmax
// statistics, one warp per query row; (3) rescale-and-accumulate P @ V,
// one thread per head-dim column.  The TPU kernel's sequential kv grid
// axis, carried in VMEM scratch, becomes this in-block loop.  B*KV blocks
// (16 at B=4, KV=4) leave most of the 132 SMs idle; splitting the cache
// across blocks with a combine pass (split-KV) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 8;  // query rows accumulated in registers at once
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Strides {
  long long b, g, s;  // element strides of the three outer axes
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ valid, T* __restrict__ out,
                            int rep, int hd, int smax, int tile, Strides qs,
                            Strides ks, Strides vs, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [rep][hd] query rows, pre-scaled
  float* acc_s = q_s + rep * hd;   // [rep][hd] running numerator
  float* p_s = acc_s + rep * hd;   // [rep][tile] scores, then weights
  float* m_s = p_s + rep * tile;   // [rep] running max
  float* l_s = m_s + rep;          // [rep] running denominator
  float* c_s = l_s + rep;          // [rep] rescale factor of this tile

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qs.b + g * qs.g;
  const T* kb = k + b * ks.b + g * ks.g;
  const T* vb = v + b * vs.b + g * vs.g;
  const int nvalid = valid[b];
  // Past `nvalid` every score is -1e30.  With nvalid > 0 their weight
  // exp(-1e30 - m) is exactly 0, so those positions are skipped.  With
  // nvalid <= 0 all positions score -1e30 and all weights are 1.
  const int npos = nvalid > 0 ? min(nvalid, smax) : smax;

  for (int e = tid; e < rep * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    q_s[e] = to_f32(qb[r * qs.s + d]) * scale;
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < npos; k0 += tile) {
    const int n = min(tile, npos - k0);

    // (1) scores: one warp per key position, lanes across hd
    for (int j = warp; j < n; j += kWarps) {
      const int pos = k0 + j;
      if (pos >= nvalid) {
        for (int r = lane; r < rep; r += 32) p_s[r * tile + j] = kNeg;
        continue;
      }
      const T* krow = kb + pos * ks.s;
      for (int r0 = 0; r0 < rep; r0 += kRowChunk) {
        float part[kRowChunk];
#pragma unroll
        for (int rr = 0; rr < kRowChunk; ++rr) part[rr] = 0.f;
        for (int d = lane; d < hd; d += 32) {
          const float kd = to_f32(krow[d]);
#pragma unroll
          for (int rr = 0; rr < kRowChunk; ++rr)
            if (r0 + rr < rep) part[rr] += q_s[(r0 + rr) * hd + d] * kd;
        }
#pragma unroll
        for (int rr = 0; rr < kRowChunk; ++rr) {
          const float s = warp_sum(part[rr]);
          if (lane == 0 && r0 + rr < rep) p_s[(r0 + rr) * tile + j] = s;
        }
      }
    }
    __syncthreads();

    // (2) online-softmax statistics: one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float* row = p_s + r * tile;
      const float m_prev = m_s[r];
      float mx = kNeg;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + P @ V: one thread per head-dim column
    for (int d = tid; d < hd; d += kThreads) {
      for (int r0 = 0; r0 < rep; r0 += kRowChunk) {
        float a[kRowChunk];
#pragma unroll
        for (int rr = 0; rr < kRowChunk; ++rr)
          a[rr] = r0 + rr < rep ? acc_s[(r0 + rr) * hd + d] * c_s[r0 + rr]
                                : 0.f;
        for (int j = 0; j < n; ++j) {
          const float vd = to_f32(vb[(k0 + j) * vs.s + d]);
#pragma unroll
          for (int rr = 0; rr < kRowChunk; ++rr)
            if (r0 + rr < rep) a[rr] += p_s[(r0 + rr) * tile + j] * vd;
        }
#pragma unroll
        for (int rr = 0; rr < kRowChunk; ++rr)
          if (r0 + rr < rep) acc_s[(r0 + rr) * hd + d] = a[rr];
      }
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * gridDim.x + g) * rep * hd;
  for (int e = tid; e < rep * hd; e += kThreads)
    store(ob + e, acc_s[e] / fmaxf(l_s[e / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int KV, int rep, int hd, int smax, int tile,
           Strides qs, Strides ks, Strides vs, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * rep * hd + rep * tile + 3 * rep);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attention_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<T*>(out), rep, hd, smax, tile, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Launches on `stream` and does not synchronise.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const void* valid,
    void* out, int B, int KV, int rep, int hd, int smax, int tile,
    long long q_sb, long long q_sg, long long q_sr, long long k_sb,
    long long k_sg, long long k_ss, long long v_sb, long long v_sg,
    long long v_ss, float scale, void* stream) {
  const Strides qs{q_sb, q_sg, q_sr}, ks{k_sb, k_sg, k_ss},
      vs{v_sb, v_sg, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, out, B, KV, rep, hd, smax, tile, qs,
                         ks, vs, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, out, B, KV, rep, hd, smax,
                                 tile, qs, ks, vs, scale, s);
  return (int)cudaErrorInvalidValue;
}
