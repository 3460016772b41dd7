// Mamba-2 SSD chunked scan for Hopper (sm_90a), in three passes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (wrapper `ssd_scan`, pallas_call at line 84) and computes its function,
// for a batch of sequences: x (batch, S, H, P), dt (batch, S, H), A (H,)
// f32, B/C (batch, S, N), all contiguous, x/dt/B/C f32 or bf16; y (batch,
// S, H, P) in x's dtype, before the D skip (the wrapper adds it, outside
// the kernel, as the reference does).  Per head and chunk of L steps, in
// f32:
//   s     = cumsum(dt * A)
//   G     = M o (C B^T),  M[t][u] = u <= t ? exp(s_t - s_u) : 0
//   y     = exp(s) o (C h^T) + G (dt o x)
//   h_out = exp(s_L) h + ((exp(s_L - s) dt) o x)^T B
// with the (P, N) f32 state h carried from chunk to chunk.
//
// Arithmetic: IEEE f32 FFMA on the CUDA cores; bf16 inputs are widened on
// load (the result must stay within ssd_scan.bracket, an f32 bound, so
// neither the tensor cores' bf16 nor TF32 would do).
//
// What bounds it: at mamba2-130m's widths (P = 64, N = 128, L = 64, 24
// heads) the function does 14.7 GFLOP on 220 MB at batch 4 x 4096 steps,
// ~67 flops per byte, above the ~20 the f32 CUDA cores need per HBM byte:
// the least time is the flops over the 67 TFLOP/s f32 rate (0.22 ms).
//
// Design: the TPU grid is (H, S/L), its chunk axis sequential, carrying
// the state in VMEM.  Only the state recurrence h <- exp(s_L) h + S_c is
// sequential; everything else of a chunk depends on the state entering it
// and on the chunk's own inputs.  So three kernels, each over every chunk
// of every head and sequence at once:
//   1. chunk states (ssd_states_kernel, 128-thread blocks): one block per
//      (sequence, chunk, head, 64 x 64 tile of the (P, N) state) writes the
//      chunk's own state S_c = ((exp(s_L - s) dt) o x)^T B, transposed to
//      (N, P), its decay exp(s_L), and s = cumsum(dt A) of every step (a
//      warp scan over tiles of 32 steps, carried from tile to tile); blocks
//      after those write each chunk's C B^T, which no head changes;
//   2. state passing (ssd_passing_kernel): one thread per 4 state elements
//      (1 when P N is not a multiple of 4) per (sequence, head) walks the
//      chunks in order, h <- decay h + S, the reference's recurrence in
//      its order, with four chunks' loads in flight, and writes in place
//      the state that enters each chunk;
//   3. chunk outputs (ssd_outputs_kernel, 256 threads, two blocks an SM):
//      one block per (sequence, chunk, head, 64-row tile of the chunk,
//      64-column tile of P): yi = G (dt o x), G = mask o exp(s_t - s_u) o
//      C B^T from pass 1's C B^T and s, u in tiles of 64 up to the
//      diagonal tile (so L x L never sits in shared memory at once, and
//      chunk, P and N take any size); then y = exp(s) o (C h^T) + yi, h
//      the state entering the chunk, N in tiles of 64.
// Each block starts every load of a phase before it waits on any: f32
// tiles go by cp.async, the rest through registers, into rows padded to 68
// floats; the products run on register tiles read as float4 (4 x 8 a
// thread in pass 1, 4 x 4 in pass 3; 12 LDS.128 per 128 and 8 per 64
// FFMA, no bank conflicts), and in pass 3's diagonal tile a warp stops at
// its last row.
//
// One state per chunk: the states cross device memory four times (written
// by 1, read and written by 2, read by 3), at mamba2-130m 4 x 201 MB,
// ~0.24 ms, more than the bound.  Keeping one state per segment of k
// chunks divides that by k and pays in pass 3 for recomputing a segment's
// earlier chunk states; on the H100 segments of 2 and 4 chunks were slower
// than one state per chunk (PERF.md), so the kernels keep one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // tile edge (rows, steps, columns of P or N)
constexpr int kLd = kT + 4;  // padded row stride of a tile in shared memory
constexpr int kTile = kT * kLd;  // floats of one tile buffer

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements from device memory, widened to f32; those at
// or past `avail` are 0.  `vec`: the four may be read as one 16-byte (f32)
// or 8-byte (bf16) load.
__device__ __forceinline__ float4 load4(const float* p, int avail, bool vec) {
  if (vec && avail >= 4) return *reinterpret_cast<const float4*>(p);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (avail > 0) r.x = p[0];
  if (avail > 1) r.y = p[1];
  if (avail > 2) r.z = p[2];
  if (avail > 3) r.w = p[3];
  return r;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int avail,
                                        bool vec) {
  if (vec && avail >= 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (avail > 0) r.x = __bfloat162float(p[0]);
  if (avail > 1) r.y = __bfloat162float(p[1]);
  if (avail > 2) r.z = __bfloat162float(p[2]);
  if (avail > 3) r.w = __bfloat162float(p[3]);
  return r;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][e] += a[i].k b[k].e over k < 4: one step of a 4 x 4 register tile
// whose A values come 4 along the reduction axis and B values 4 along the
// output columns.
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float4 (&a)[4],
                                         const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ak = get(a[i], k);
      acc[i][0] = fmaf(ak, b[k].x, acc[i][0]);
      acc[i][1] = fmaf(ak, b[k].y, acc[i][1]);
      acc[i][2] = fmaf(ak, b[k].z, acc[i][2]);
      acc[i][3] = fmaf(ak, b[k].w, acc[i][3]);
    }
}

struct Dims {
  int S, H, P, N, L;
  int nc;              // chunks of a sequence
  int ptiles, ttiles;  // 64-wide tiles of P and of a chunk's rows
  bool xvec;  // x rows: P a multiple of 4, x aligned (16 bytes f32, 8 bf16)
  bool bvec;  // B/C rows likewise, with N
  bool svec;  // state rows (along P) 16-byte copies: P a multiple of 4
};

// Copy the 64 x 64 tile src[r * ld + c] (rows r < nr, columns c < nc; the
// rest is zero) to dst[r * dld + c] in f32.  f32 rows that are 16-byte
// aligned go by cp.async (the caller commits and waits); everything else
// through registers.
template <typename T>
__device__ __forceinline__ void stage64(float* dst, int dld, const T* src,
                                        long long ld, int nr, int nc,
                                        bool vec) {
  for (int e = threadIdx.x; e < kT * (kT / 4); e += blockDim.x) {
    const int r = e >> 4, c = (e & 15) * 4;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        const int n = r < nr ? max(0, min(4, nc - c)) : 0;
        cpa::copy16(dst + r * dld + c, n ? src + r * ld + c : src, 4 * n);
        continue;
      }
    }
    *reinterpret_cast<float4*>(dst + r * dld + c) =
        r < nr ? load4(src + r * ld + c, nc - c, vec)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Warp 0 of a block: s for the chunk's rows [t0, t0 + 64) (those past n add
// 0), given `carry` = s of row t0 - 1 (0 for the first).  Lane l takes rows
// t0 + l and t0 + 32 + l; each half is an inclusive warp scan added to the
// carry.  Writes s to s_out (if given) and returns the carry past the tile
// on every lane.  Pass 1 is the only pass that scans a chunk for its
// outputs; pass 3 reads the s it wrote.
template <typename T>
__device__ __forceinline__ float scan_tile(const T* dt0, long long stride,
                                           float a, int n, float carry,
                                           float* s_out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half * 32 + lane;
    float v = j < n ? __fmul_rn(to_f32(dt0[j * stride]), a) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = __fadd_rn(v, w);
    }
    const float s = __fadd_rn(carry, v);
    if (s_out) s_out[j] = s;
    carry = __shfl_sync(0xffffffffu, s, 31);
  }
  return carry;
}

// The state tiles' thread layout: threads [0, 128) of a block each own a
// 4 x 8 register tile of a 64 x 64 (p, n) tile, p = 4 ty + i and
// n = 4 tx + 32 j + e (j < 2, e < 4: 8 lanes read 128 consecutive bytes).
constexpr int kStateThreads = 128;

// acc = sum_u exp(s_L - s_u) dt_u x_u[p] B_u[n] over chunk c of sequence
// b, head h, with acc[i][4 j + e] at p = p0 + 4 ty + i and n = n0 + 4 tx +
// 32 j + e (tx = tid & 7, ty = tid >> 3; threads past 128 only help stage).
// Uses xw_s and b_s (a tile each), s_s and w_s (64 floats each).  Writes
// the chunk's s to s_out unless it is null.  Returns s_L in warp 0.
template <typename T>
__device__ __forceinline__ float chunk_state(
    float (&acc)[4][8], const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ B, float a, const Dims& d, long long b, int h,
    int c, int p0, int n0, float* xw_s, float* b_s, float* s_s, float* w_s,
    float* __restrict__ s_out) {
  const int tid = threadIdx.x, tx = tid & 7, ty = (tid >> 3) & 15;
  const long long row0 = b * d.S + (long long)c * d.L;  // first step
  const T* dtc = dt + row0 * d.H + h;
  float s_last = 0.f;  // warp 0's
  if (d.L > kT && tid < 32) {  // several tiles: s_L first, a sweep
    for (int u0 = 0; u0 < d.L; u0 += kT)
      s_last = scan_tile(dtc + (long long)u0 * d.H, d.H, a,
                         min(kT, d.L - u0), s_last, nullptr);
  }
  float carry = 0.f;
  for (int u0 = 0; u0 < d.L; u0 += kT) {
    const int nu = min(kT, d.L - u0);
    // x rows [u][p] and B rows [u][n]; the copies run while warp 0 scans
    stage64(xw_s, kLd, x + ((row0 + u0) * d.H + h) * d.P + p0,
            (long long)d.H * d.P, nu, d.P - p0, d.xvec);
    stage64(b_s, kLd, B + (row0 + u0) * d.N + n0, d.N, nu, d.N - n0,
            d.bvec);
    cpa::commit();
    if (tid < 32) {
      carry = scan_tile(dtc + (long long)u0 * d.H, d.H, a, nu, carry, s_s);
      if (d.L <= kT) s_last = carry;  // one tile: s of the last row
      __syncwarp();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half * 32 + tid;
        const float sj = s_s[j];
        if (s_out && j < nu) s_out[u0 + j] = sj;
        w_s[j] = j < nu ? expf(s_last - sj) *
                              to_f32(dtc[(long long)(u0 + j) * d.H])
                        : 0.f;
      }
    }
    cpa::wait<0>();
    __syncthreads();  // the tiles and w_s are in
    // xw_s[u][p] *= w_u
    for (int e = tid; e < kT * (kT / 4); e += blockDim.x) {
      float4* q = reinterpret_cast<float4*>(xw_s + (e >> 4) * kLd +
                                            (e & 15) * 4);
      const float w = w_s[e >> 4];
      float4 v = *q;
      v.x *= w;
      v.y *= w;
      v.z *= w;
      v.w *= w;
      *q = v;
    }
    __syncthreads();
    if (tid < kStateThreads) {
      for (int u = 0; u < kT; u += 4) {
        float4 xq[4], bq[2][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xq[k] = lds4(xw_s + (u + k) * kLd + 4 * ty);
          bq[0][k] = lds4(b_s + (u + k) * kLd + 4 * tx);
          bq[1][k] = lds4(b_s + (u + k) * kLd + 4 * tx + 32);
        }
        // acc[i][4 j + e] += x[u + k][4 ty + i] B[u + k][4 tx + 32 j + e]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float xv = get(xq[k], i);
              acc[i][4 * j + 0] = fmaf(xv, bq[j][k].x, acc[i][4 * j + 0]);
              acc[i][4 * j + 1] = fmaf(xv, bq[j][k].y, acc[i][4 * j + 1]);
              acc[i][4 * j + 2] = fmaf(xv, bq[j][k].z, acc[i][4 * j + 2]);
              acc[i][4 * j + 3] = fmaf(xv, bq[j][k].w, acc[i][4 * j + 3]);
            }
      }
    }
    if (u0 + kT < d.L) __syncthreads();  // before the next tile's copies
  }
  return s_last;
}

// One 64 x 64 tile of C B^T for the chunk's rows [t0, t0 + 64) and steps
// [u0, u0 + 64), summed over N, into cb (the chunk's L x L, row-major); a
// 128-thread block, 4 x 8 a thread: t = t0 + 4 ty + i, u = u0 + tx + 8 j.
template <typename T>
__device__ __forceinline__ void chunk_cb_tile(const T* __restrict__ B,
                                              const T* __restrict__ C,
                                              float* __restrict__ cb,
                                              const Dims& d, long long row0,
                                              int t0, int u0, float* c_s,
                                              float* b_s) {
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  float g[4][8] = {};
  for (int n0 = 0; n0 < d.N; n0 += kT) {
    __syncthreads();
    stage64(c_s, kLd, C + (row0 + t0) * d.N + n0, d.N, d.L - t0, d.N - n0,
            d.bvec);
    stage64(b_s, kLd, B + (row0 + u0) * d.N + n0, d.N, d.L - u0, d.N - n0,
            d.bvec);
    cpa::commit();
    cpa::wait<0>();
    __syncthreads();
    for (int n = 0; n < kT; n += 4) {
      float4 cv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = lds4(c_s + (4 * ty + i) * kLd + n);
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = lds4(b_s + (tx + 8 * j) * kLd + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          g[i][j] = fmaf(cv[i].x, bv[j].x, g[i][j]);
          g[i][j] = fmaf(cv[i].y, bv[j].y, g[i][j]);
          g[i][j] = fmaf(cv[i].z, bv[j].z, g[i][j]);
          g[i][j] = fmaf(cv[i].w, bv[j].w, g[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + 4 * ty + i, u = u0 + tx + 8 * j;
      if (t < d.L && u < d.L) cb[(long long)t * d.L + u] = g[i][j];
    }
}

// Pass 1, in blocks of 128 threads.  Blocks [0, state_blocks): one per
// (sequence, chunk, head, 64 x 64 tile of the state) writes the states,
// transposed, [batch][nc][H][N][P], the decays [batch][nc][H] and s of
// every step, [batch][nc][H][L]; the blocks after them, one per (sequence,
// chunk, lower-triangle tile of 64 x 64), write C B^T, [batch][nc][L][L],
// which does not depend on the head (pass 3 reads it instead of forming it
// once per head).
template <typename T>
__global__ void __launch_bounds__(kStateThreads, 4)
    ssd_states_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, float* __restrict__ ws,
                      float* __restrict__ decays, float* __restrict__ s_ws,
                      float* __restrict__ cb_ws, long long state_blocks,
                      Dims d) {
  extern __shared__ float4 smem4[];
  float* xw_s = reinterpret_cast<float*>(smem4);
  float* b_s = xw_s + kTile;
  float* s_s = b_s + kTile;
  float* w_s = s_s + kT;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  if (blockIdx.x >= state_blocks) {  // a tile of C B^T
    long long q = blockIdx.x - state_blocks;
    const int tri = d.ttiles * (d.ttiles + 1) / 2;
    int k = (int)(q % tri);
    q /= tri;
    const int c = (int)(q % d.nc);
    const long long b = q / d.nc;
    int tt = 0;
    while (k > tt) k -= ++tt;
    chunk_cb_tile(B, C, cb_ws + (b * d.nc + c) * (long long)d.L * d.L, d,
                  b * d.S + (long long)c * d.L, tt * kT, k * kT, xw_s, b_s);
    return;
  }
  const int ntl = (d.N + kT - 1) / kT;
  const int tiles = d.ptiles * ntl;
  long long rest = blockIdx.x;
  const int tile = (int)(rest % tiles);
  rest /= tiles;
  const int h = (int)(rest % d.H);
  rest /= d.H;
  const int c = (int)(rest % d.nc);
  const long long b = rest / d.nc;
  const int p0 = (tile / ntl) * kT, n0 = (tile % ntl) * kT;
  const long long sidx = (b * d.nc + c) * d.H + h;

  float acc[4][8] = {};
  const float s_last =
      chunk_state(acc, x, dt, B, A[h], d, b, h, c, p0, n0, xw_s, b_s, s_s,
                  w_s, tile == 0 ? s_ws + sidx * d.L : nullptr);

  // the state, transposed: st[n][p]
  float* st = ws + sidx * d.P * d.N;
  const int p = p0 + 4 * ty;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n0 + 4 * tx + 32 * (e >> 2) + (e & 3);
    if (n >= d.N || p >= d.P) continue;
    float* row = st + (long long)n * d.P + p;
    if (d.svec) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < d.P) row[i] = acc[i][e];
    }
  }
  if (tile == 0 && tid == 0) decays[sidx] = expf(s_last);
}

// Pass 2: one thread per VEC state elements of one (sequence, head),
// with the next kAhead chunks' states and decays in flight.
constexpr int kAhead = 4;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    ssd_passing_kernel(float* __restrict__ ws,
                       const float* __restrict__ decays, long long lanes,
                       Dims d) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= lanes) return;
  const long long per = (long long)d.P * d.N / VEC;  // lanes a (seq, head)
  const long long bh = idx / per, e = idx - bh * per;
  const long long b = bh / d.H;
  const int h = (int)(bh - b * d.H);
  const long long step = (long long)d.H * d.P * d.N;  // chunk to chunk
  float* p = ws + ((b * d.nc) * d.H + h) * d.P * d.N + e * VEC;
  const float* dec = decays + b * d.nc * d.H + h;
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  V ring[kAhead];
  float dring[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    ring[k] = k < d.nc ? *reinterpret_cast<const V*>(p + k * step) : V{};
    dring[k] = k < d.nc ? dec[(long long)k * d.H] : 0.f;
  }
  V hs{};
  for (int c0 = 0; c0 < d.nc; c0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c >= d.nc) break;
      const V cur = ring[k];
      const float dk = dring[k];
      if (c + kAhead < d.nc) {
        ring[k] = *reinterpret_cast<const V*>(p + (c + kAhead) * step);
        dring[k] = dec[(long long)(c + kAhead) * d.H];
      }
      *reinterpret_cast<V*>(p + c * step) = hs;  // the state entering c
      if constexpr (VEC == 4) {
        hs.x = dk * hs.x + cur.x;
        hs.y = dk * hs.y + cur.y;
        hs.z = dk * hs.z + cur.z;
        hs.w = dk * hs.w + cur.w;
      } else {
        hs = dk * hs + cur;
      }
    }
  }
}

// Pass 3: y for one (sequence, chunk, head, 64-row tile, 64-column tile of
// P), thread tile t = t0 + 4 ty + i, p = p0 + 4 tx + e (a warp's rows are
// 8 consecutive ones).  yi = G (dt o x) over the u tiles up to the
// diagonal one, G = mask o exp(s_t - s_u) o C B^T from pass 1's C B^T and
// s (in the diagonal tile a warp stops at its last row); then ye = C h^T
// over N in tiles of 64, h the state entering the chunk, two N tiles in
// flight.  Every load of a phase is issued before the block waits on any.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_outputs_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ C, const float* __restrict__ ws,
                       const float* __restrict__ s_ws,
                       const float* __restrict__ cb_ws, T* __restrict__ y,
                       Dims d) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // [t][u] G
  float* xw_s = g_s + kTile;     // [u][p] dt o x
  float* c_s = xw_s + kTile;     // 2 x [t][n] C rows
  float* h_s = c_s + 2 * kTile;  // 2 x [n][p] the state entering the chunk
  float* st_s = h_s + 2 * kTile;  // [64] s of the tile's rows
  float* su_s = st_s + kT;        // [64] s of a u tile
  float* dt_s = su_s + kT;        // [64] dt of a u tile
  const int tiles = d.ttiles * d.ptiles;
  long long rest = blockIdx.x;
  const int tile = (int)(rest % tiles);
  rest /= tiles;
  const int h = (int)(rest % d.H);
  rest /= d.H;
  const int c = (int)(rest % d.nc);
  const long long b = rest / d.nc;
  const int t0 = (tile / d.ptiles) * kT, p0 = (tile % d.ptiles) * kT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = b * d.S + (long long)c * d.L;
  const T* dtc = dt + row0 * d.H + h;
  const float* sc = s_ws + ((b * d.nc + c) * d.H + h) * (long long)d.L;
  const float* cbc = cb_ws + (b * d.nc + c) * (long long)d.L * d.L;
  const float* st = ws + ((b * d.nc + c) * d.H + h) * (long long)d.P * d.N;
  const int nk = (d.N + kT - 1) / kT;
  auto issue_inter = [&](int k) {  // C and h for N tile k, into buffer k & 1
    const int n0 = k * kT;
    stage64(c_s + (k & 1) * kTile, kLd, C + (row0 + t0) * d.N + n0, d.N,
            d.L - t0, d.N - n0, d.bvec);
    stage64(h_s + (k & 1) * kTile, kLd, st + (long long)n0 * d.P + p0, d.P,
            d.N - n0, d.P - p0, d.svec);
    cpa::commit();
  };
  issue_inter(0);
  if (nk > 1) issue_inter(1);
  if (tid < kT) st_s[tid] = t0 + tid < d.L ? sc[t0 + tid] : 0.f;

  // intra: yi = G (dt o x)
  float yi[4][4] = {};
  for (int u0 = 0; u0 <= t0; u0 += kT) {
    const int nu = min(kT, d.L - u0);
    __syncthreads();  // the last tile's products are done
    stage64(g_s, kLd, cbc + (long long)t0 * d.L + u0, d.L, d.L - t0, nu,
            d.L % 4 == 0);
    stage64(xw_s, kLd, x + ((row0 + u0) * d.H + h) * d.P + p0,
            (long long)d.H * d.P, nu, d.P - p0, d.xvec);
    cpa::commit();
    if (tid < kT) {
      su_s[tid] = tid < nu ? sc[u0 + tid] : 0.f;
      dt_s[tid] = tid < nu ? to_f32(dtc[(long long)(u0 + tid) * d.H]) : 0.f;
    }
    cpa::wait<0>();
    __syncthreads();
    // in place: G[t][u] = exp(s_t - s_u) (C B^T)[t][u] for u <= t, else 0;
    // xw[u][p] = dt_u x[u][p]
    for (int e = tid; e < kT * (kT / 4); e += kThreads) {
      const int r = e >> 4, q = (e & 15) * 4, t = t0 + r;
      float4* gp = reinterpret_cast<float4*>(g_s + r * kLd + q);
      float gv[4] = {gp->x, gp->y, gp->z, gp->w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = u0 + q + k;
        gv[k] = u <= t && t < d.L ? expf(st_s[r] - su_s[q + k]) * gv[k]
                                  : 0.f;
      }
      *gp = make_float4(gv[0], gv[1], gv[2], gv[3]);
      float4* xp = reinterpret_cast<float4*>(xw_s + r * kLd + q);
      const float w = dt_s[r];
      float4 xv = *xp;
      xv.x *= w;
      xv.y *= w;
      xv.z *= w;
      xv.w *= w;
      *xp = xv;
    }
    __syncthreads();
    // past the warp's last row G is 0 in the diagonal tile
    const int u_end = u0 == t0 ? min(kT, 8 * (tid >> 5) + 8) : kT;
    for (int u = 0; u < u_end; u += 4) {
      float4 gq[4], xq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gq[i] = lds4(g_s + (4 * ty + i) * kLd + u);
#pragma unroll
      for (int k = 0; k < 4; ++k) xq[k] = lds4(xw_s + (u + k) * kLd + 4 * tx);
      fma_tile(yi, gq, xq);
    }
  }

  // inter: ye = C h^T
  float ye[4][4] = {};
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk)  // tile k + 1 may stay in flight
      cpa::wait<1>();
    else
      cpa::wait<0>();
    __syncthreads();
    const float* cs = c_s + (k & 1) * kTile;
    const float* hs = h_s + (k & 1) * kTile;
    for (int n = 0; n < kT; n += 4) {
      float4 cq[4], hq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cq[i] = lds4(cs + (4 * ty + i) * kLd + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) hq[j] = lds4(hs + (n + j) * kLd + 4 * tx);
      fma_tile(ye, cq, hq);
    }
    __syncthreads();  // before the buffer takes N tile k + 2
    if (k + 2 < nk) issue_inter(k + 2);
  }

  // y = exp(s) o ye + yi
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= d.L) continue;
    const float es = expf(st_s[4 * ty + i]);
    T* yr = y + ((row0 + t) * d.H + h) * d.P;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 4 * tx + e;
      if (p < d.P) store(yr + p, es * ye[i][e] + yi[i][e]);
    }
  }
}

constexpr size_t kStatesSmem = sizeof(float) * (2 * kTile + 2 * kT);
constexpr size_t kOutputsSmem = sizeof(float) * (6 * kTile + 3 * kT);

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* ws, int batch, Dims d,
           cudaStream_t stream) {
  const long long states = (long long)batch * d.nc * d.H;
  float* wsf = static_cast<float*>(ws);
  float* decays = wsf + states * d.P * d.N;
  float* s_ws = decays + states;
  // C B^T is read 16 bytes at a time: its region starts on 16 bytes
  float* cb_ws = s_ws + ((long long)batch * d.S * d.H + 3) / 4 * 4 +
                 (4 - reinterpret_cast<size_t>(s_ws) / sizeof(float) % 4) % 4;
  {
    const long long state_blocks = states * d.ptiles * ((d.N + kT - 1) / kT);
    const long long cb_blocks =
        (long long)batch * d.nc * (d.ttiles * (d.ttiles + 1) / 2);
    ssd_states_kernel<T><<<(unsigned)(state_blocks + cb_blocks),
                           kStateThreads, kStatesSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B),
        static_cast<const T*>(C), wsf, decays, s_ws, cb_ws, state_blocks, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  {
    const bool quads = (long long)d.P * d.N % 4 == 0;
    const long long lanes = states / d.nc * d.P * d.N / (quads ? 4 : 1);
    const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
    if (quads)
      ssd_passing_kernel<4><<<blocks, kThreads, 0, stream>>>(wsf, decays,
                                                             lanes, d);
    else
      ssd_passing_kernel<1><<<blocks, kThreads, 0, stream>>>(wsf, decays,
                                                             lanes, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  {
    auto kernel = ssd_outputs_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kOutputsSmem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        (long long)batch * d.nc * d.H * d.ttiles * d.ptiles;
    kernel<<<(unsigned)blocks, kThreads, kOutputsSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const T*>(C), wsf, s_ws, cb_ws, static_cast<T*>(y), d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); A is float32.
// ws, 16-byte aligned, holds batch * (S / L * H * (P * N + 1) + S * (H +
// L)) + 8 floats.  Launches the three kernels in order and returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (any the
// reference refuses).  Launches on `stream` and does not synchronise.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* B, const void* C,
                               void* y, void* ws, int batch, int S, int H,
                               int P, int N, int L, void* stream) {
  if (batch < 1 || L < 1 || S < L || S % L || H < 1 || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  Dims d{};
  d.S = S;
  d.H = H;
  d.P = P;
  d.N = N;
  d.L = L;
  d.nc = S / L;
  d.ptiles = (P + kT - 1) / kT;
  d.ttiles = (L + kT - 1) / kT;
  const int align = dtype == 0 ? 16 : 8;  // bytes of four elements
  d.xvec = P % 4 == 0 && reinterpret_cast<size_t>(x) % align == 0;
  d.bvec = N % 4 == 0 && reinterpret_cast<size_t>(B) % align == 0 &&
           reinterpret_cast<size_t>(C) % align == 0;
  d.svec = P % 4 == 0;
  if (reinterpret_cast<size_t>(ws) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, B, C, y, ws, batch, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, ws, batch, d, s);
  return (int)cudaErrorInvalidValue;
}
