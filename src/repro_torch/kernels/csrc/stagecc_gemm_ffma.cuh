// Register-tiled GEMM template for the H100's CUDA cores (sm_90a): the
// ffma route of the emitted contraction.
//
// Replaces, with stagecc_gemm.cuh and stagecc_gemm_sm90.cuh, the TPU kernel
// that src/repro/core/backend_pallas.py::_emit_gemm (line 229) emits
// (pallas_call at line 298).  repro_torch/core/backend_cuda.py renders a
// source that includes this file when the plan's tiles are multiples of 64
// and tk a multiple of 8; the source then exports stagecc_gemm_ffma_launch
// beside stagecc_gemm_launch (stagecc_gemm.cuh, for the operands this file
// cannot read), and backend_cuda._gemm_route picks one per call.
//
// Function and arithmetic: those of stagecc_gemm.cuh.  Every product is an
// IEEE f32 FFMA (no TF32, no tensor cores); bf16 operands are widened
// exactly on their way into shared memory.  Each output element belongs to
// one thread, which sums each k tile of tk columns in order into a fresh
// `part` and then adds it to the running sum: acc += part (tpu_mxu) or
// acc = R(acc + R(part)) (tpu_mxu_kgrid, R the rounding to the output
// type), the k tiles walked in order; no split-K.  The generated Epilogue
// runs on the final sum.  So an element's bits depend on tk alone, not on
// the block shape, and any output split leaves them as they are.
//
// What bounds it: qwen2-7b's MLP products at M=512 do ~200 flops per byte
// of f32 operands, far above the ~20 the CUDA cores need per byte of HBM,
// so the least time is 2MNK flops over 67 TFLOP/s.  stagecc_gemm.cuh gave
// each thread a strided 8 x 8 tile (16 scalar shared loads per 64 FMAs),
// loaded K synchronously through registers with two barriers a chunk, and
// ran one 128 x 128 block per output tile (0.85 of a wave on the down
// product).  Here:
//   * each thread holds an 8 x 8 tile as two runs of 4 rows by two runs of
//     4 columns, half a block apart, so a k step is 4 float4 shared loads
//     (LDS.128) per 64 FFMAs;
//   * K is staged in chunks of KC = 16 columns (8 where tk is not a
//     multiple of 16) through a ring of two shared-memory stages, both
//     operands k-major.  An f32 operand whose unit stride runs along M or N
//     (B as stored, A as the backward's a.t()) is copied by cp.async, a
//     chunk ahead.  An operand whose unit stride runs along K, and any bf16
//     operand, goes through registers: chunk c + 2 is loaded (16 bytes a
//     thread) while chunk c is computed, and stored (widened, transposed
//     where needed) one chunk ahead.  One barrier per chunk;
//   * blocks of 64 x 64 outputs (64 threads), whatever the plan's tiles,
//     walk the output column of blocks by column, so the row blocks that
//     share a B tile run together; the down product runs 448 blocks, not
//     112 tiles;
//   * the running sum lives in shared memory, read and written once per k
//     tile, and `part` in registers: that frees 64 registers a thread, so
//     six blocks (12 warps) share an SM.
// On an H100 this pairing took the least time over both MLP products of
// six that were timed: the sum in registers or in shared memory, by blocks
// of 128 x 128, 128 x 64 or 64 x 64 (PERF.md, section 6).

#pragma once

#include "cp_async.cuh"
#include "stagecc_gemm.cuh"

namespace stagecc {
namespace ffma {

constexpr int kPad = 4;  // floats added to each shared row (bank spread)

// 16 bytes of T widened to floats: 4 f32 or 8 bf16 (a bf16 is the upper
// half of its f32, so the widening is exact)
__device__ __forceinline__ void widen(const uint4& v, const float*,
                                      float* x) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, const __nv_bfloat16*,
                                      float* x) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One operand's part of a k chunk: EXT rows of M (or N) by KC columns of
// K, element (r, q) at src + r * s_r + q * s_q, kept in shared memory
// k-major as s[q * LD + r].  unit_k: s_q == 1, else s_r == 1.
template <typename T, int EXT, int KC, int NT>
struct Operand {
  static constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kVecs = EXT * KC / V;
  static constexpr int kPer = (kVecs + NT - 1) / NT;
  static constexpr int LD = EXT + kPad;
  static constexpr int kStage = KC * LD;  // floats per ring stage
  uint4 reg[kPer];                        // the prefetched chunk, raw

  // vector idx of the chunk: its first element (r, q); along K when
  // unit_k (neighbouring threads on one row), else along M / N
  __device__ __forceinline__ static void place(int idx, bool unit_k, int& r,
                                               int& q) {
    if (unit_k) {
      r = idx / (KC / V);
      q = idx % (KC / V) * V;
    } else {
      q = idx / (EXT / V);
      r = idx % (EXT / V) * V;
    }
  }

  __device__ __forceinline__ void load(const T* src, long long s_r,
                                       long long s_q, bool unit_k) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (kVecs % NT == 0 || idx < kVecs) {
        int r, q;
        place(idx, unit_k, r, q);
        reg[i] = __ldg(reinterpret_cast<const uint4*>(src + r * s_r +
                                                      q * s_q));
      }
    }
  }

  __device__ __forceinline__ void store(float* s, bool unit_k) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (kVecs % NT == 0 || idx < kVecs) {
        int r, q;
        place(idx, unit_k, r, q);
        float x[V];
        widen(reg[i], static_cast<const T*>(nullptr), x);
        if (unit_k) {
#pragma unroll
          for (int j = 0; j < V; ++j) s[(q + j) * LD + r] = x[j];
        } else {
#pragma unroll
          for (int j = 0; j < V; j += 4)
            *reinterpret_cast<float4*>(s + q * LD + r + j) =
                make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
        }
      }
    }
  }

  // f32 with unit stride along M / N: 16-byte copies straight to s
  __device__ __forceinline__ static void copy(float* s, const T* src,
                                              long long s_q) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (kVecs % NT == 0 || idx < kVecs) {
        int r, q;
        place(idx, false, r, q);
        cpa::copy16(s + q * LD + r, src + r + q * s_q);
      }
    }
  }
};

constexpr int kBM = 64, kBN = 64;  // outputs per block
constexpr int kThreads = kBM * kBN / 64;
constexpr int kStages = 2;         // the ring of k chunks

template <int TK>
__host__ __device__ constexpr int chunk() {
  return TK % 16 == 0 ? 16 : 8;
}

// the dynamic shared memory of a block: the ring, and the running sum
template <int TK>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (kStages * chunk<TK>() * (kBM + kBN + 2 * kPad) + kBM * kBN);
}

// blocks per SM the launch bounds ask for: as many as the SM's 228 KB of
// shared memory hold (1 KB of it reserved per block), which caps the
// registers at 65536 over that many blocks' threads
template <int TK>
__host__ __device__ constexpr int min_blocks() {
  return 233472 / (smem_bytes<TK>() + 1024);
}

template <int TK, bool kKGrid, typename TA, typename TB, typename TO,
          typename Epilogue>
__global__ void __launch_bounds__(kThreads, min_blocks<TK>())
    gemm_ffma_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                     TO* __restrict__ out, int m, int n, int k,
                     long long sam, long long sak, long long sbk,
                     long long sbn, Epilogue epi) {
  constexpr int NT = kThreads, KC = chunk<TK>(), S = kStages, TX = kBN / 8;
  static_assert(TK % KC == 0, "tk");
  using OpA = Operand<TA, kBM, KC, NT>;
  using OpB = Operand<TB, kBN, KC, NT>;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [S][KC][kBM + kPad]
  float* bs = as + S * OpA::kStage;             // [S][KC][kBN + kPad]
  float* acc_s = bs + S * OpB::kStage;          // [64][NT], the running sums

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // column of blocks by column: the row blocks of one B tile run together
  const int row_blocks = m / kBM;
  const long long row0 =
      static_cast<long long>(blockIdx.x % row_blocks) * kBM;
  const long long col0 =
      static_cast<long long>(blockIdx.x / row_blocks) * kBN;
  // which axis has the unit stride; f32 along M / N goes by cp.async
  const bool a_k = sak == 1, b_k = sbk == 1;
  const bool a_async = sizeof(TA) == 4 && !a_k;
  const bool b_async = sizeof(TB) == 4 && !b_k;
  const long long a_sr = a_k ? sam : 1, a_sq = a_k ? 1 : sak;
  const long long b_sr = b_k ? sbn : 1, b_sq = b_k ? 1 : sbk;
  const TA* a_blk = a + row0 * sam;
  const TB* b_blk = b + col0 * sbn;
  const int chunks = k / KC;

  OpA op_a;
  OpB op_b;
  auto issue = [&](int c) {  // cp.async of chunk c into its ring stage
    if (c < chunks) {
      const long long kq = static_cast<long long>(c) * KC;
      if (a_async)
        OpA::copy(as + (c % S) * OpA::kStage, a_blk + kq * sak, a_sq);
      if (b_async)
        OpB::copy(bs + (c % S) * OpB::kStage, b_blk + kq * sbk, b_sq);
    }
    cpa::commit();
  };
  auto fetch = [&](int c) {  // registers: chunk c's global loads
    const long long kq = static_cast<long long>(c) * KC;
    if (!a_async) op_a.load(a_blk + kq * sak, a_sr, a_sq, a_k);
    if (!b_async) op_b.load(b_blk + kq * sbk, b_sr, b_sq, b_k);
  };
  auto put = [&](int c) {  // registers: chunk c into its ring stage
    if (!a_async) op_a.store(as + (c % S) * OpA::kStage, a_k);
    if (!b_async) op_b.store(bs + (c % S) * OpB::kStage, b_k);
  };

  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < 64; ++e) acc_s[e * NT + tid] = 0.f;

  for (int c = 0; c < S - 1; ++c) issue(c);
  fetch(0);
  put(0);
  if (chunks > 1) fetch(1);

  for (int c = 0; c < chunks; ++c) {
    cpa::wait<S - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();     // everyone's have; the stages refilled below
                         // were last read in chunk c - 1
    issue(c + S - 1);
    if (c + 1 < chunks) {
      put(c + 1);
      if (c + 2 < chunks) fetch(c + 2);
    }
    const float* a_c = as + (c % S) * OpA::kStage + ty * 4;
    const float* b_c = bs + (c % S) * OpB::kStage + tx * 4;
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_c + q * OpA::LD);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_c + q * OpA::LD + kBM / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(b_c + q * OpB::LD);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_c + q * OpB::LD + kBN / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    if ((c + 1) % (sum_block(TK, kKGrid) / KC) == 0) {  // a k tile's end
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& x = acc_s[(i * 8 + j) * NT + tid];
          if constexpr (kKGrid)
            x = round_to<TO>(x + round_to<TO>(part[i][j]));
          else
            x += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

  // rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + e and 32 + tx*4 + e
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gr = row0 + (i < 4 ? 0 : kBM / 2) + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gc = col0 + h * (kBN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = epi(acc_s[(i * 8 + h * 4 + e) * NT + tid], gr, gc + e, n);
      TO* o = out + gr * n + gc;
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(o + e, v[e]);
      }
    }
  }
}

}  // namespace ffma

// Launch on `stream` in blocks of 64 x 64 outputs (the caller has checked
// that 64 divides M and N, that tk divides K, and that each operand has a
// unit stride, the other a multiple of 16 bytes, and a 16-byte-aligned
// base).  Returns cudaGetLastError() (0 when the launch was accepted).
template <int TK, bool kKGrid, typename TA, typename TB, typename TO,
          typename Epilogue>
int launch_ffma(const void* a, const void* b, void* out, int m, int n, int k,
                long long sam, long long sak, long long sbk, long long sbn,
                Epilogue epi, void* stream) {
  auto kern = ffma::gemm_ffma_kernel<TK, kKGrid, TA, TB, TO, Epilogue>;
  constexpr int smem = ffma::smem_bytes<TK>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((m / ffma::kBM) * (n / ffma::kBN)));
  kern<<<grid, ffma::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TO*>(out), m, n, k, sam, sak, sbk, sbn, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stagecc
