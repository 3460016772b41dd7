// Building blocks of the general multi-nest emitter's stage kernels, for
// Hopper (sm_90a), instantiated by the compiler.
//
// Replaces the TPU kernel that src/repro/core/backend_pallas.py::_emit_stage
// emits through emit_general (pallas_call at line 539): one kernel per
// top-level LoopIR nest.  repro_torch/core/backend_cuda.py renders one .cu
// source per compiled kernel: one __global__ per stage, whose body is the
// nest's statements in the schedule's order with every non-grid loop a C
// loop, and one extern "C" launcher per stage.  The source includes this
// file for the statements' block-cooperative bodies.
//
// Mapping, as the reference's body computes it:
//   * the leading @grid chain is the CUDA grid, one program per block; the
//     schedule's grid pass maps only loops whose iterations are
//     independent, so the blocks may run in any order;
//   * scratch buffers (@vreg / @vmem) live in dynamic shared memory,
//     zeroed at the start of every block, as the reference's scratch is
//     fresh per program;
//   * HBM buffers are global pointers at full shape; a tile's origin is
//     its affine index times the tile size per dimension, in 64-bit
//     offsets;
//   * every statement is a loop of the whole block over the tile's
//     elements, followed by __syncthreads(), since the next statement may
//     read what this one wrote;
//   * every value is computed in f32 (bf16 inputs are widened exactly) and
//     rounded to bf16 where the reference's value has that type; every
//     store rounds to the destination's type.
//
// What bounds it: the compiled graphs materialise every intermediate in
// HBM, so a stage moves whole (S, S) score tensors, and a stage whose nest
// has no grid loop runs as one block on one SM.  This first version is the
// plain form: IEEE f32 FMA on the CUDA cores, no tensor cores, no TMA, no
// asynchronous copies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace stagecc_stage {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to the nearest bf16 (ties to even) and widened back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A rank-2 view of a tile: element (r, c) at p[r * rs + c * cs].
template <typename T>
struct View2 {
  T* p;
  long long rs, cs;
  __device__ __forceinline__ float get(int r, int c) const {
    return ld(p + r * rs + c * cs);
  }
  __device__ __forceinline__ void put(int r, int c, float x) const {
    st(p + r * rs + c * cs, x);
  }
};

// Zero `bytes` (a multiple of 16) of shared memory with the whole block.
template <int NT>
__device__ __forceinline__ void zero_shared(unsigned char* p, int bytes) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += NT)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

constexpr int kChunk = 16;  // k columns staged in shared memory per step

// d (TM x TN) = [d +] a (TM x TK) @ b (TK x TN), with the whole block of NT
// threads.  The block is an RX-wide grid of threads, each holding an MI x
// MJ register tile of outputs strided by the grid; tiles larger than the
// grid's RY*MI x RX*MJ pass are walked in passes.  k is staged through
// shared memory `sm` (kChunk * (RY*MI + RX*MJ) floats) in chunks, walked
// in order, so each output is an f32 sum in k order (FFMA, no TF32); then
// `ACC` adds it to d as read in f32, as the reference's `dst + dot`.  All
// reads of a and b are done before the last __syncthreads of a pass, so d
// may not alias them within a pass: the emitter stages such statements.
template <int NT, int TM, int TN, int TK, int RX, int MI, int MJ, bool ACC,
          typename TA, typename TB, typename TD>
__device__ __forceinline__ void matmul_tile(const View2<TA>& a,
                                            const View2<TB>& b,
                                            const View2<TD>& d, float* sm) {
  constexpr int RY = NT / RX, PM = RY * MI, PN = RX * MJ;
  float* as = sm;                 // [kChunk][PM], k-major
  float* bs = sm + kChunk * PM;   // [kChunk][PN]
  const int tx = threadIdx.x % RX, ty = threadIdx.x / RX;
  for (int r0 = 0; r0 < TM; r0 += PM) {
    for (int c0 = 0; c0 < TN; c0 += PN) {
      float acc[MI][MJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < TK; k0 += kChunk) {
        // neighbouring threads take neighbouring k of a row of a
        for (int e = threadIdx.x; e < PM * kChunk; e += NT) {
          const int r = e / kChunk, k = e % kChunk;
          as[k * PM + r] = (r0 + r < TM && k0 + k < TK)
                               ? a.get(r0 + r, k0 + k) : 0.f;
        }
        for (int e = threadIdx.x; e < kChunk * PN; e += NT) {
          const int k = e / PN, c = e % PN;
          bs[k * PN + c] = (c0 + c < TN && k0 + k < TK)
                               ? b.get(k0 + k, c0 + c) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float av[MI], bv[MJ];
#pragma unroll
          for (int i = 0; i < MI; ++i) av[i] = as[k * PM + ty + i * RY];
#pragma unroll
          for (int j = 0; j < MJ; ++j) bv[j] = bs[k * PN + tx + j * RX];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < MJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const int r = r0 + ty + i * RY, c = c0 + tx + j * RX;
          if (r < TM && c < TN) d.put(r, c, ACC ? d.get(r, c) + acc[i][j]
                                                 : acc[i][j]);
        }
    }
  }
}

// Sum or max of a warp's 32 values, left in every lane.
template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

}  // namespace stagecc_stage
