// Tiled GEMM template for Hopper (sm_90a), instantiated by the compiler.
//
// Replaces the TPU kernel that src/repro/core/backend_pallas.py::_emit_gemm
// emits (pallas_call at line 298).  repro_torch/core/backend_cuda.py renders
// one small .cu source per scheduled contraction.  The source fixes the
// tile sizes TM, TN, TK (any divisors of the problem up to 128, such as 96,
// or 1 for a prime dimension), the schedule, the element types and a
// generated epilogue functor; it includes this file and exports one
// extern "C" launcher.  M, N and K stay runtime arguments, so products
// that share tiles, types and epilogue share one build.
//
// Function: out = epilogue(A @ B).  A (M, K) and B (K, N) are read through
// the element strides given (the autograd backward passes transposed
// views, never copies); out (M, N) is contiguous.  Products are f32: bf16
// and f16 inputs are widened exactly, int32 and int8 ones converted (the
// reference's preferred_element_type=float32), and f32 runs as IEEE FFMA
// on the CUDA cores (no TF32).  An integer output rounds as XLA converts
// (toward zero, saturating); its kgrid running sum is an int that wraps.  As in the reference, each k tile's product is summed on its
// own in f32 and then added to the running sum, with the k tiles walked in
// order inside the block (the TPU grid's sequential k axis); there is no
// split-K, which would move the roundings below.
//   kKGrid = false (tpu_mxu): the running sum is f32; the epilogue runs
//     on it, then one rounding to the output type.
//   kKGrid = true (tpu_mxu_kgrid): each tile's product is rounded to the
//     output type and added to the output-typed running sum, which is
//     rounded again: the two roundings per k tile of the reference's
//     revisited output block.  The epilogue runs after the last tile, on
//     that output-typed value.
//
// What bounds it: qwen2-7b's MLP products at M=512 do ~200 flops per byte
// moved, above the f32 CUDA-core ridge (~20) and near the bf16 tensor-core
// one (~295), so the least time is the flops over the peak rate.  This
// first version reaches neither peak.  It is the plain shared-memory tiled
// form: a TM x TN tile per block, a 16 x 16 thread grid, each thread a
// strided ceil(TM/16) x ceil(TN/16) register tile, K staged through shared
// memory kChunk columns at a time.  It has no tensor cores, no
// asynchronous copies and no double buffering.  backend_cuda._gemm_route
// sends what the faster templates take elsewhere (bf16 with tk a multiple
// of 16 to stagecc_gemm_sm90.cuh; tiles that are multiples of 64 with tk a
// multiple of 8 to stagecc_gemm_ffma.cuh, both for operands with a unit
// stride, the other 16 bytes apart, and 16-byte-aligned bases), so this
// file takes the rest: tiles such as 96 or 1 (a prime dimension), tk not a
// multiple of 8, and operands those two cannot read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace stagecc {

constexpr int kDim = 16;  // threads per side of the block's thread grid
constexpr int kThreads = kDim * kDim;
constexpr int kChunk = 32;  // K columns staged in shared memory per step

// An operand element widened to float (an integer converted, as the
// reference's jnp.dot(..., preferred_element_type=float32) does).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// An epilogue input element as a value: float for the floating types, int
// for the integer ones (the epilogue computes integers in int).
__device__ __forceinline__ float to_val(float x) { return x; }
__device__ __forceinline__ float to_val(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_val(__half x) { return __half2float(x); }
__device__ __forceinline__ int to_val(int x) { return x; }
__device__ __forceinline__ int to_val(int8_t x) { return x; }

// int8's wrap: x modulo 2^8, as a signed value
__device__ __forceinline__ int wrap8(int x) {
  return static_cast<int>(static_cast<int8_t>(x));
}

// x rounded (to nearest even) to the type T, and widened back to float;
// into an integer type, as XLA converts a float: toward zero, clamped to
// the type's range, NaN to 0 (PTX's cvt.rzi clamps and takes NaN to 0)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const __half*) {
  return __half2float(__float2half_rn(x));
}
__device__ __forceinline__ int round_to(float x, const int*) {
  return __float2int_rz(x);
}
__device__ __forceinline__ int round_to(float x, const int8_t*) {
  return min(max(__float2int_rz(x), -128), 127);
}
template <typename T>
__device__ __forceinline__ auto round_to(float x) {
  return round_to(x, static_cast<const T*>(nullptr));
}

// The type a running sum of T is kept in: int for the integer types,
// float for the floating ones.
template <typename T>
using value_t = decltype(round_to<T>(0.f));

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}
__device__ __forceinline__ void store(int* p, float x) {
  *p = round_to<int>(x);
}
__device__ __forceinline__ void store(int8_t* p, float x) {
  *p = static_cast<int8_t>(round_to<int8_t>(x));
}
__device__ __forceinline__ void store(float* p, int x) {
  *p = static_cast<float>(x);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int x) {
  *p = __float2bfloat16(static_cast<float>(x));
}
__device__ __forceinline__ void store(__half* p, int x) {
  *p = __int2half_rn(x);
}
__device__ __forceinline__ void store(int* p, int x) { *p = x; }
__device__ __forceinline__ void store(int8_t* p, int x) {
  *p = static_cast<int8_t>(x);
}

template <int TM, int TN, int TK, bool kKGrid, typename TA, typename TB,
          typename TO, typename Epilogue>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                TO* __restrict__ out, int n, int k, long long sam,
                long long sak, long long sbk, long long sbn, long long ldo,
                Epilogue epi) {
  constexpr int RM = (TM + kDim - 1) / kDim;  // rows per thread
  constexpr int RN = (TN + kDim - 1) / kDim;  // columns per thread
  constexpr int KC = TK < kChunk ? TK : kChunk;
  constexpr bool kFullM = TM % kDim == 0;
  constexpr bool kFullN = TN % kDim == 0;
  constexpr bool kFullK = TK % KC == 0;
  // k-major staging, each row padded by one word so that neither fill
  // pattern below (k fastest, or m / n fastest) conflicts on a bank
  __shared__ float as[KC][TM + 1];
  __shared__ float bs[KC][TN + 1];

  const int tx = threadIdx.x % kDim;
  const int ty = threadIdx.x / kDim;
  // one block per output tile, the tiles of a row of tiles in a row
  const int col_tiles = n / TN;
  const long long row0 = static_cast<long long>(blockIdx.x / col_tiles) * TM;
  const long long col0 = static_cast<long long>(blockIdx.x % col_tiles) * TN;
  const TA* a_blk = a + row0 * sam;
  const TB* b_blk = b + col0 * sbn;

  // the running sum: output-typed in kgrid (an int for an integer output)
  using Acc = std::conditional_t<kKGrid, value_t<TO>, float>;
  Acc acc[RM][RN];
  float part[RM][RN];  // the current k tile's f32 product
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += TK) {  // the k tiles, in order
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) part[i][j] = 0.f;
    for (int kc = 0; kc < TK; kc += KC) {
      const int kw = kFullK ? KC : (TK - kc < KC ? TK - kc : KC);
      const long long kq = static_cast<long long>(k0) + kc;
      __syncthreads();  // every thread is done with the previous chunk
      // A[row0 + r, kq + q] -> as[q][r]; B[kq + q, col0 + c] -> bs[q][c].
      // Neighbouring threads take neighbouring addresses along whichever
      // axis has unit stride.
      if (sak == 1) {
        for (int t = threadIdx.x; t < TM * kw; t += kThreads) {
          const int r = t / kw, q = t % kw;
          as[q][r] = to_f32(a_blk[r * sam + kq + q]);
        }
      } else {
        for (int t = threadIdx.x; t < TM * kw; t += kThreads) {
          const int r = t % TM, q = t / TM;
          as[q][r] = to_f32(a_blk[r * sam + (kq + q) * sak]);
        }
      }
      if (sbk == 1) {
        for (int t = threadIdx.x; t < TN * kw; t += kThreads) {
          const int c = t / kw, q = t % kw;
          bs[q][c] = to_f32(b_blk[kq + q + c * sbn]);
        }
      } else {
        for (int t = threadIdx.x; t < TN * kw; t += kThreads) {
          const int c = t % TN, q = t / TN;
          bs[q][c] = to_f32(b_blk[(kq + q) * sbk + c * sbn]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < kw; ++q) {
        float af[RM], bf[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = ty + kDim * i;
          af[i] = (kFullM || r < TM) ? as[q][r] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tx + kDim * j;
          bf[j] = (kFullN || c < TN) ? bs[q][c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            part[i][j] = fmaf(af[i], bf[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        if constexpr (kKGrid && std::is_same_v<Acc, int>) {
          // the integer output's running sum wraps as its type does
          const int t = static_cast<int>(
              static_cast<unsigned>(acc[i][j]) +
              static_cast<unsigned>(round_to<TO>(part[i][j])));
          acc[i][j] = std::is_same_v<TO, int8_t> ? wrap8(t) : t;
        } else if constexpr (kKGrid) {
          acc[i][j] = round_to<TO>(acc[i][j] + round_to<TO>(part[i][j]));
        } else
          acc[i][j] += part[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + kDim * i;
    if (!kFullM && r >= TM) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + kDim * j;
      if (!kFullN && c >= TN) continue;
      const long long gr = row0 + r, gc = col0 + c;
      store(out + gr * ldo + gc, epi(acc[i][j], gr, gc, ldo));
    }
  }
}

// Launch on `stream`, one block per output tile.  m, n and k are what the
// reference's grid covers (its tiles times its extents), which may fall
// short of the arrays: the output's rows are `ldo` apart, and the caller
// has filled what no tile writes.  The tiles number below 2^31.  Returns
// cudaGetLastError() (0 when the launch was accepted).
template <int TM, int TN, int TK, bool kKGrid, typename TA, typename TB,
          typename TO, typename Epilogue>
int launch(const void* a, const void* b, void* out, int m, int n, int k,
           long long sam, long long sak, long long sbk, long long sbn,
           long long ldo, Epilogue epi, void* stream) {
  const dim3 grid(static_cast<unsigned>((n / TN) * (m / TM)));
  gemm_kernel<TM, TN, TK, kKGrid, TA, TB, TO, Epilogue>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TA*>(a), static_cast<const TB*>(b),
          static_cast<TO*>(out), n, k, sam, sak, sbk, sbn, ldo, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stagecc
