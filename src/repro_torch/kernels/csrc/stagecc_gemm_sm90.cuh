// Tiled GEMM template for Hopper's tensor cores (sm_90a): the bf16 route
// of the emitted contraction.
//
// Replaces, with stagecc_gemm.cuh, the TPU kernel that
// src/repro/core/backend_pallas.py::_emit_gemm emits (pallas_call at line
// 298).  repro_torch/core/backend_cuda.py renders a source that includes
// this file when both operands are bf16 and tk is a multiple of 16; such a
// source exports stagecc_gemm_wgmma_launch beside stagecc_gemm_launch (the
// CUDA-core template, for operands whose strides or alignment TMA cannot
// read), with one signature, and backend_cuda._gemm_route picks one per
// call.  The epilogue functor is the generated one, called per element.
//
// Function and arithmetic: those of stagecc_gemm.cuh.  Each tk tile's
// products go into a fresh f32 `part` (the tile's first k16 wgmma does not
// read it) and, after the tile's last k16 step, into the running sum:
// acc += part (tpu_mxu) or acc = R(acc + R(part)) (tpu_mxu_kgrid, R the
// rounding to the output type).  The k tiles are walked in order inside
// the block: no split-K.  Products of bf16 values are exact in the tensor
// cores, which sum a tile in f32 in their own order;
// backend_cuda.bracket allows any order inside a tile.
//
// What bounds it: qwen2-7b's MLP products at M=512 do ~200 flops per byte,
// below the bf16 tensor cores' ~295, but each operand tile is reused from
// L2 by the blocks beside it, so the least time is near the flops over
// 989 TFLOP/s.  Design: blocks of 128 x 128 outputs, 384 threads.
// Warpgroup 0 is the producer: one thread keeps a ring of kStages k-chunks
// of 64 (A 128 x 64 and B 64 x 128, 32 KB a stage) in flight by TMA, each
// stage's arrival counted on an mbarrier.  Warpgroups 1 and 2 each own 64
// rows and issue m64n128k16 wgmmas from shared memory (128-byte swizzle),
// holding part and acc, 64 + 64 f32 registers a thread, through setmaxnreg.
// The blocks walk the output tiles column of tiles by column, so the four
// row tiles of M=512 read one B tile from HBM and share it through L2.
// Both operands are read through their strides: K-major (unit stride
// along K) or MN-major (unit stride along M or N, as the backward's
// transposed views are), the latter through wgmma's transpose bits.
// Ragged edges: TMA fills loads past M, N or K with zeros, and the
// epilogue stores only rows below M and columns below N.

#pragma once

#include <type_traits>

#include "sm90.cuh"
#include "stagecc_gemm.cuh"

namespace stagecc {
namespace wg {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kThreads = 384;                 // producer + two consumers
constexpr int kTileA = kBM * kBK * 2;         // bytes of one stage's A
constexpr int kTileB = kBN * kBK * 2;
constexpr int kHalf = 64 * kBK * 2;           // one 64-wide MN-major box
constexpr int kSmem = kStages * (kTileA + kTileB) + 2 * kStages * 8 + 1024;

// a ring stage's A (kAMN: MN-major) and B (kBMN) descriptors for k16 step
// kk of the stage, warpgroup c's 64 rows of A
template <bool kAMN>
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int c, int kk) {
  return kAMN ? sm90::desc_sw128(a + c * kHalf + kk * 2048, kHalf, 1024)
              : sm90::desc_sw128(a + c * 64 * 128 + kk * 32, 16, 1024);
}
template <bool kBMN>
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  return kBMN ? sm90::desc_sw128(b + kk * 2048, kHalf, 1024)
              : sm90::desc_sw128(b + kk * 32, 16, 1024);
}

template <int TK, bool kKGrid, bool kAMN, bool kBMN, typename TO,
          typename Epilogue>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      TO* __restrict__ out, int m, int n, int k,
                      Epilogue epi) {
  static_assert(TK % 16 == 0, "the wgmma route takes tk a multiple of 16");
  // the kgrid schedule with a bf16 output keeps its running sum as bf16
  // pairs: acc = R(acc + R(part)) is one packed conversion of part and one
  // bf16x2 add (a + b rounded once, to nearest even) per two elements.
  // Four conversions and an add per element (stagecc::round_to), or the
  // same rounding in integer operations, took longer on an H100 than the
  // tile's wgmmas, with the tensor cores idle meanwhile.
  constexpr bool kBf16Sum =
      kKGrid && std::is_same<TO, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;                          // [kStages][kTileA]
  uint8_t* sb = smem + kStages * kTileA;       // [kStages][kTileB]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kTileB);
  uint64_t* empty = full + kStages;

  // column of tiles by column: the row tiles of one B tile run together
  const int row_tiles = (m + kBM - 1) / kBM;
  const int row0 = (blockIdx.x % row_tiles) * kBM;
  const int col0 = (blockIdx.x / row_tiles) * kBN;
  const int chunks = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < chunks; ++it) {
        const int s = it % kStages;
        if (it >= kStages) sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], kTileA + kTileB);
        const int kc = it * kBK;
        uint8_t* a = sa + s * kTileA;
        uint8_t* b = sb + s * kTileB;
        if (kAMN) {   // boxes of 64 rows of M x 64 of K
          sm90::tma_load_2d(a, &ta, &full[s], row0, kc);
          sm90::tma_load_2d(a + kHalf, &ta, &full[s], row0 + 64, kc);
        } else {      // one box of 64 of K x 128 rows of M
          sm90::tma_load_2d(a, &ta, &full[s], kc, row0);
        }
        if (kBMN) {
          sm90::tma_load_2d(b, &tb, &full[s], col0, kc);
          sm90::tma_load_2d(b + kHalf, &tb, &full[s], col0 + 64, kc);
        } else {
          sm90::tma_load_2d(b, &tb, &full[s], kc, col0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c = wg - 1 owns rows row0 + 64 c ..  Each ring
  // stage is waited and its k16 steps issued into part; at a k tile's last
  // step the wgmmas are waited and the tile's products join the running
  // sum.  Stages go back to the producer once their steps are done: at
  // the k tile's end where a tile spans fewer stages than the ring holds
  // (so the tensor cores run a whole tile without a pause), else at each
  // stage's end.  (Two register sets, with tile t + 1's wgmmas in flight
  // while tile t is summed, ran slower on an H100.)
  sm90::setmaxnreg_inc<232>();
  const int c = wg - 1;
  float acc[64], part[64];
  __nv_bfloat162 acc2[32];
  sm90::zero(acc);
  sm90::zero(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc2[i] = __floats2bfloat162_rn(0.f, 0.f);
  const int steps = k / 16;            // k16 steps; TK divides K
  // k16 steps per k tile (per sum block of a long tpu_mxu tile)
  constexpr int kSpt = sum_block(TK, kKGrid) / 16;
  constexpr int kSpc = kBK / 16;       // k16 steps per stage
  // a tile's steps touch at most this many stages
  constexpr bool kTileWait = (kSpt + 2 * kSpc - 2) / kSpc < kStages;
  int released = 0;                    // stages given back
  auto release = [&](int done) {       // those whose steps are all done
    for (; (released + 1) * kSpc <= done; ++released)
      if (threadIdx.x % 32 == 0)
        sm90::mbar_arrive(&empty[released % kStages]);
  };
  for (int it = 0; it < chunks; ++it) {
    const int s = it % kStages;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t a = sm90::smem_u32(sa + s * kTileA);
    const uint32_t b = sm90::smem_u32(sb + s * kTileB);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int st = it * (kBK / 16) + kk;
      if (st < steps) {
        sm90::wgmma_ss_m64n128k16<kAMN, kBMN>(
            part, desc_a<kAMN>(a, c, kk), desc_b<kBMN>(b, kk),
            st % kSpt != 0);
        if ((st + 1) % kSpt == 0) {    // the k tile is complete
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(part);
          if constexpr (kBf16Sum) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              acc2[i] = __hadd2(acc2[i], __floats2bfloat162_rn(
                                             part[2 * i], part[2 * i + 1]));
          } else {
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              if constexpr (kKGrid)
                acc[i] = round_to<TO>(acc[i] + round_to<TO>(part[i]));
              else
                acc[i] += part[i];
            }
          }
          if constexpr (kTileWait) release(st + 1);
          sm90::wgmma_fence();
        }
      }
    }
    if constexpr (!kTileWait) {
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(part);
      release(min((it + 1) * kSpc, steps));
    }
  }

  // epilogue: the generated functor per element, then the output's type
  if constexpr (kBf16Sum) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 f = __bfloat1622float2(acc2[i]);
      acc[2 * i] = f.x;
      acc[2 * i + 1] = f.y;
    }
  }
  const int t = threadIdx.x % 128;
  const int r0 = row0 + 64 * c + 16 * (t / 32) + (t % 32) / 4;
  const int cb = col0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long gr = r0 + 8 * i, gc = cb + 8 * j + e;
        if (gr < m && gc < n)
          store(out + gr * n + gc, epi(acc[4 * j + 2 * i + e], gr, gc, n));
      }
}

template <int TK, bool kKGrid, bool kAMN, bool kBMN, typename TO,
          typename Epilogue>
int launch_majors(const CUtensorMap& ta, const CUtensorMap& tb, void* out,
                  int m, int n, int k, Epilogue epi, cudaStream_t stream) {
  auto kernel = gemm_wgmma_kernel<TK, kKGrid, kAMN, kBMN, TO, Epilogue>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) *
                           ((n + kBN - 1) / kBN);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      ta, tb, static_cast<TO*>(out), m, n, k, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// Launch the wgmma route on `stream`.  The caller (backend_cuda's route
// rule) has checked: bf16 operands, TK % 16 == 0, each operand with a unit
// stride along K (K-major) or else along M / N (MN-major), the other
// stride a multiple of 8 elements, 16-byte-aligned bases; and that the
// blocks number below 2^31.  Returns 0, a cudaError, or 1000 + a CUresult
// from encoding the tensor maps.
template <int TK, bool kKGrid, typename TO, typename Epilogue>
int launch_wgmma(const void* a, const void* b, void* out, int m, int n,
                 int k, long long sam, long long sak, long long sbk,
                 long long sbn, Epilogue epi, void* stream) {
  using namespace wg;
  const bool amn = sak != 1, bmn = sbk != 1;
  CUtensorMap ta, tb;
  int err;
  if (amn) {
    const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)k};
    const cuuint64_t strides[1] = {(cuuint64_t)sak * 2};
    const cuuint32_t box[2] = {64, kBK};
    err = sm90::encode_bf16(&ta, a, 2, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)sam * 2};
    const cuuint32_t box[2] = {kBK, kBM};
    err = sm90::encode_bf16(&ta, a, 2, dims, strides, box);
  }
  if (err) return err;
  if (bmn) {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
    const cuuint64_t strides[1] = {(cuuint64_t)sbk * 2};
    const cuuint32_t box[2] = {64, kBK};
    err = sm90::encode_bf16(&tb, b, 2, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)sbn * 2};
    const cuuint32_t box[2] = {kBK, kBN};
    err = sm90::encode_bf16(&tb, b, 2, dims, strides, box);
  }
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (amn && bmn)
    return launch_majors<TK, kKGrid, true, true, TO>(ta, tb, out, m, n, k,
                                                     epi, s);
  if (amn)
    return launch_majors<TK, kKGrid, true, false, TO>(ta, tb, out, m, n, k,
                                                      epi, s);
  if (bmn)
    return launch_majors<TK, kKGrid, false, true, TO>(ta, tb, out, m, n, k,
                                                      epi, s);
  return launch_majors<TK, kKGrid, false, false, TO>(ta, tb, out, m, n, k,
                                                     epi, s);
}

}  // namespace stagecc
