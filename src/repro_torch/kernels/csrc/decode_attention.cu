// Decode attention for Hopper (sm_90a), split-KV: one query token per
// sequence attends a partly filled KV cache; the `rep` query heads of a GQA
// group share one KV head.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (wrapper `decode_attention`, pallas_call at line 81) and computes its
// function: scores q.k / sqrt(hd), positions at or past valid[b] set to
// -1e30 (not -inf), softmax statistics in f32, output acc / max(l, 1e-30)
// rounded once to the input type (f32 or bf16).  A row with valid <= 0 has
// every position masked, so its output is the mean of V over all Smax rows.
//
// Layout: q (B, KV, rep, hd); k/v (B, KV, Smax, hd) read through the
// element strides given (the caller passes a transposed view of its
// (B, Smax, KV, hd) cache, never a copy); out (B, KV, rep, hd) contiguous;
// valid (B,) int32, read on the device.  The innermost (hd) stride is 1.
//
// What bounds it: one query token against the cache is ~2 flops per byte
// of K/V read, far below the card's ~20 (f32 CUDA cores) flops per byte,
// so the least time is the K/V bytes of the valid positions over the
// memory rate: under a microsecond at the serving shapes.  What a launch
// really waits for is latency: a few dependent trips to device memory and
// the launch itself.  The design therefore spreads the cache over many
// blocks and keeps each block's trips to memory few and wide.
//
// Design (split-KV):
//  * The host cuts each (b, group)'s Smax positions into `splits` ranges
//    of `len` (decode_attention.split_plan: about two blocks per SM, at
//    least 16 positions a range) and launches one 128-thread block per
//    (split, group, batch), flattened onto blockIdx.x (no 65535 limit).
//    A block whose range starts at or past the live count
//    (min(valid, Smax), or Smax when valid <= 0) returns at once: past
//    `valid` a score is -1e30 and its weight exactly 0, so those
//    positions are never read.
//  * A block walks its range in tiles of up to 32 positions.  Its threads
//    copy a tile's K and V rows into shared memory, 16 bytes a thread with
//    cp.async (the next tile's copies run during this tile's work), so
//    every position of the tile is in flight at once.  Where the rows are
//    not 16-byte aligned, or hd is not a multiple of 16 bytes, the same
//    template copies element by element (WIDE = false).
//  * Scores: one thread per (query row, position) pair, a dot product over
//    hd from shared memory (the group's rep query rows, pre-scaled, sit in
//    shared memory; rows padded so a warp's reads hit distinct banks).
//    Statistics: one warp per query row, online softmax across tiles.
//    P V: one thread per (query row, 4 columns), summing the tile's
//    positions from shared memory; each thread owns its accumulator
//    elements, so no reduction is needed, and the loop reads shared
//    memory only: the whole tile arrived in one trip.
//  * Each split writes its partial (m, l, acc[rep][hd]) in f32 to a
//    workspace the wrapper allocates; a second kernel, one block per
//    output row, merges the live splits as online softmax merges tiles:
//    M = max m_i, out = sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i,
//    1e-30), rounded once.  With valid <= 0 every m_i is -1e30 and every
//    exp(m_i - M) is 1.  A second kernel was chosen over an atomic ticket
//    in the last block of each group: the ticket needs a counter that
//    outlives the call and is zero at the start (state, or a memset
//    launch) and fences between the blocks; the second kernel costs one
//    kernel boundary and needs neither.  With one split the first kernel
//    writes the output itself and the combine is not launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 32;  // positions per tile
constexpr int kSmemMax = 232448;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements of a shared-memory row, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
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

// What the host and the kernel agree on: sizes, strides in shared memory
// and the split plan.
struct Plan {
  int KV, rep, hd, smax;
  int hdv;     // hd rounded up to 16 bytes of the element type
  int qld;     // row stride of the query and accumulator rows, in floats
  int rld;     // row stride of a K/V row in shared memory, in elements
  int len;     // positions a split covers
  int splits;  // splits per (b, group)
  int tile;    // positions per tile
  int stages;  // K/V tile buffers (2: the next tile loads during this one)
};

// Live positions of row b: past them a weight is exactly 0.
__device__ __forceinline__ int live_positions(int nvalid, int smax) {
  return nvalid > 0 ? min(nvalid, smax) : smax;
}

// Bytes of shared memory before the K/V buffers (query rows, accumulator,
// scores, statistics), rounded up to 16.
__host__ __device__ __forceinline__ size_t head_bytes(const Plan& p) {
  const size_t floats = 2 * (size_t)p.rep * p.qld +
                        (size_t)p.rep * p.tile + 3 * (size_t)p.rep;
  return (floats * sizeof(float) + 15) / 16 * 16;
}

template <typename T>
size_t smem_bytes(const Plan& p) {
  return head_bytes(p) + (size_t)p.stages * 2 * p.tile * p.rld * sizeof(T);
}

// Copy rows [pos0, pos0 + n) of K (unless masked) and V into `kb`/`vb`.
template <typename T, bool WIDE>
__device__ __forceinline__ void load_tile(T* kb, T* vb, const T* kg,
                                          const T* vg, const Strides& ks,
                                          const Strides& vs, int pos0, int n,
                                          bool masked, const Plan& p) {
  if (WIDE) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = p.hd / V;  // WIDE: hd is a multiple of V
    for (int e = threadIdx.x; e < n * per_row; e += kThreads) {
      const int j = e / per_row, c = (e - j * per_row) * V;
      if (!masked)
        cpa::copy16(kb + j * p.rld + c, kg + (pos0 + j) * ks.s + c);
      cpa::copy16(vb + j * p.rld + c, vg + (pos0 + j) * vs.s + c);
    }
    cpa::commit();
  } else {
    // element by element; columns hd..hdv are zero (a zero K column meets
    // a zero query column, a V column past hd is never stored)
    for (int e = threadIdx.x; e < n * p.hdv; e += kThreads) {
      const int j = e / p.hdv, d = e - j * p.hdv;
      if (d < p.hd) {
        if (!masked) kb[j * p.rld + d] = kg[(pos0 + j) * ks.s + d];
        vb[j * p.rld + d] = vg[(pos0 + j) * vs.s + d];
      } else {
        if (!masked) store(kb + j * p.rld + d, 0.f);
        store(vb + j * p.rld + d, 0.f);
      }
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ valid,
                        float* __restrict__ ws, T* __restrict__ out, Plan p,
                        Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [rep][qld], pre-scaled
  float* acc_s = q_s + p.rep * p.qld;            // [rep][qld]
  float* p_s = acc_s + p.rep * p.qld;            // [rep][tile]
  float* m_s = p_s + p.rep * p.tile;             // [rep] running max
  float* l_s = m_s + p.rep;                      // [rep] running sum
  float* c_s = l_s + p.rep;                      // [rep] this tile's rescale
  T* kv_s =
      reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + head_bytes(p));
  const int buf = p.tile * p.rld;  // elements of one K (or V) tile buffer

  const int split = blockIdx.x % p.splits;
  const long long grp = blockIdx.x / p.splits;  // b * KV + g
  const int g = (int)(grp % p.KV);
  const long long b = grp / p.KV;
  const int nvalid = valid[b];
  const int npos = live_positions(nvalid, p.smax);
  const int s0 = split * p.len;
  if (s0 >= npos) return;  // wholly past valid: the combine skips it
  const int s1 = min(s0 + p.len, npos);
  const bool masked = nvalid <= 0;  // every score -1e30, every weight 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qs.b + g * qs.g;
  const T* kg = k + b * ks.b + g * ks.g;
  const T* vg = v + b * vs.b + g * vs.g;
  const int ntiles = (s1 - s0 + p.tile - 1) / p.tile;

  load_tile<T, WIDE>(kv_s, kv_s + buf, kg, vg, ks, vs, s0,
                     min(p.tile, s1 - s0), masked, p);
  for (int e = tid; e < p.rep * p.hdv; e += kThreads) {
    const int r = e / p.hdv, d = e - r * p.hdv;
    q_s[r * p.qld + d] = d < p.hd ? to_f32(qb[r * qs.s + d]) * scale : 0.f;
    acc_s[r * p.qld + d] = 0.f;
  }
  for (int r = tid; r < p.rep; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  const int cols4 = p.hdv / 4;
  for (int it = 0; it < ntiles; ++it) {
    const int pos0 = s0 + it * p.tile, n = min(p.tile, s1 - pos0);
    const int cur = p.stages == 2 ? (it & 1) : 0;
    if (p.stages == 2 && it + 1 < ntiles) {
      const int nxt = cur ^ 1;
      load_tile<T, WIDE>(kv_s + 2 * nxt * buf, kv_s + (2 * nxt + 1) * buf,
                         kg, vg, ks, vs, pos0 + p.tile,
                         min(p.tile, s1 - pos0 - p.tile), masked, p);
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
    const T* kt = kv_s + 2 * cur * buf;
    const T* vt = kt + buf;

    // (1) scores: one thread per (row, position)
    for (int e = tid; e < p.rep * n; e += kThreads) {
      const int r = e / n, j = e - r * n;
      float s = kNeg;
      if (!masked) {
        const float* qr = q_s + r * p.qld;
        const T* kr = kt + j * p.rld;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < p.hdv; c += 4) {
          const float4 qv = load4(qr + c), kv4 = load4(kr + c);
          a.x = fmaf(qv.x, kv4.x, a.x);
          a.y = fmaf(qv.y, kv4.y, a.y);
          a.z = fmaf(qv.z, kv4.z, a.z);
          a.w = fmaf(qv.w, kv4.w, a.w);
        }
        s = (a.x + a.y) + (a.z + a.w);
      }
      p_s[r * p.tile + j] = s;
    }
    __syncthreads();

    // (2) online-softmax statistics: one warp per query row
    for (int r = warp; r < p.rep; r += kWarps) {
      float* row = p_s + r * p.tile;
      const float m_prev = m_s[r];
      float mx = kNeg;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
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

    // (3) acc = acc * corr + P V: one thread per (row, 4 columns)
    for (int e = tid; e < p.rep * cols4; e += kThreads) {
      const int r = e / cols4, c = (e - r * cols4) * 4;
      float4* ap = reinterpret_cast<float4*>(acc_s + r * p.qld + c);
      const float corr = c_s[r];
      float4 a = *ap;
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
      const float* pr = p_s + r * p.tile;
      for (int j = 0; j < n; ++j) {
        const float w = pr[j];
        const float4 vv = load4(vt + j * p.rld + c);
        a.x = fmaf(w, vv.x, a.x);
        a.y = fmaf(w, vv.y, a.y);
        a.z = fmaf(w, vv.z, a.z);
        a.w = fmaf(w, vv.w, a.w);
      }
      *ap = a;
    }
    __syncthreads();
    if (p.stages == 1 && it + 1 < ntiles)
      load_tile<T, WIDE>(kv_s, kv_s + buf, kg, vg, ks, vs, pos0 + p.tile,
                         min(p.tile, s1 - pos0 - p.tile), masked, p);
  }

  if (p.splits == 1) {  // the only split: write the output itself
    T* ob = out + grp * p.rep * p.hd;
    for (int e = tid; e < p.rep * p.hd; e += kThreads) {
      const int r = e / p.hd, d = e - r * p.hd;
      store(ob + e, acc_s[r * p.qld + d] / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }
  // the partial: ws = [groups][splits][rep] x (hd acc, then m and l)
  float* wp = ws + (grp * p.splits + split) * p.rep * (p.hd + 2);
  for (int e = tid; e < p.rep * p.hd; e += kThreads) {
    const int r = e / p.hd, d = e - r * p.hd;
    wp[r * (p.hd + 2) + d] = acc_s[r * p.qld + d];
  }
  for (int r = tid; r < p.rep; r += kThreads) {
    wp[r * (p.hd + 2) + p.hd] = m_s[r];
    wp[r * (p.hd + 2) + p.hd + 1] = l_s[r];
  }
}

// One block per output row (b, g, r): merge the live splits' partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const int* __restrict__ valid,
                          const float* __restrict__ ws, T* __restrict__ out,
                          Plan p) {
  const long long row = blockIdx.x;  // (b * KV + g) * rep + r
  const long long grp = row / p.rep;
  const int r = (int)(row - grp * p.rep);
  const long long b = grp / p.KV;
  const int npos = live_positions(valid[b], p.smax);
  const int nlive = min(p.splits, (npos + p.len - 1) / p.len);
  const long long step = (long long)p.rep * (p.hd + 2);  // split to split
  const float* wp = ws + grp * p.splits * step + r * (p.hd + 2);
  float mx = kNeg;
  for (int i = 0; i < nlive; ++i) mx = fmaxf(mx, wp[i * step + p.hd]);
  float l = 0.f;
  for (int i = 0; i < nlive; ++i)
    l += expf(wp[i * step + p.hd] - mx) * wp[i * step + p.hd + 1];
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* ob = out + row * p.hd;
  for (int d = threadIdx.x; d < p.hd; d += kThreads) {
    float a = 0.f;
    for (int i = 0; i < nlive; ++i)
      a = fmaf(expf(wp[i * step + p.hd] - mx), wp[i * step + d], a);
    store(ob + d, a * inv_l);
  }
}

template <typename T, bool WIDE>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* ws, void* out, long long groups, Plan p, Strides qs,
           Strides ks, Strides vs, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  p.hdv = (p.hd + V - 1) / V * V;
  p.qld = p.hdv + 4;
  p.rld = p.hdv + V;  // 16 bytes of padding: rows start on distinct banks
  p.tile = min(p.len, kTileMax);
  p.stages = p.len > p.tile ? 2 : 1;
  while (smem_bytes<T>(p) > (size_t)kSmemMax && (p.tile > 1 || p.stages > 1)) {
    if (p.stages == 2)
      p.stages = 1;
    else
      p.tile = (p.tile + 1) / 2;
  }
  const size_t smem = smem_bytes<T>(p);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  auto kernel = decode_split_kernel<T, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)(groups * p.splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<float*>(ws), static_cast<T*>(out), p, qs, ks, vs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  decode_combine_kernel<T><<<(unsigned)(groups * p.rep), kThreads, 0,
                              stream>>>(static_cast<const int*>(valid),
                                        static_cast<const float*>(ws),
                                        static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; wide: 1 when k and v (data and every
// outer stride) are 16-byte aligned and hd fills whole 16-byte vectors, so
// the rows are copied by cp.async, else 0 (element copies).  ws holds
// B * KV * splits * rep * (hd + 2) floats (unused with splits == 1).
// Returns cudaGetLastError() after the launches (0 on success).  Launches
// on `stream` and does not synchronise.
extern "C" int decode_attention_launch(
    int dtype, int wide, const void* q, const void* k, const void* v,
    const void* valid, void* ws, void* out, int B, int KV, int rep, int hd,
    int smax, int splits, int len, long long q_sb, long long q_sg,
    long long q_sr, long long k_sb, long long k_sg, long long k_ss,
    long long v_sb, long long v_sg, long long v_ss, float scale,
    void* stream) {
  if (B < 1 || KV < 1 || rep < 1 || hd < 1 || smax < 1 || splits < 1 ||
      len < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sg, q_sr}, ks{k_sb, k_sg, k_ss},
      vs{v_sb, v_sg, v_ss};
  Plan p{};
  p.KV = KV;
  p.rep = rep;
  p.hd = hd;
  p.smax = smax;
  p.len = len;
  p.splits = splits;
  const long long groups = (long long)B * KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wide ? launch<float, true>(q, k, v, valid, ws, out, groups, p, qs,
                                      ks, vs, scale, s)
                : launch<float, false>(q, k, v, valid, ws, out, groups, p,
                                       qs, ks, vs, scale, s);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, true>(q, k, v, valid, ws, out,
                                              groups, p, qs, ks, vs, scale, s)
                : launch<__nv_bfloat16, false>(q, k, v, valid, ws, out,
                                               groups, p, qs, ks, vs, scale,
                                               s);
  return (int)cudaErrorInvalidValue;
}
