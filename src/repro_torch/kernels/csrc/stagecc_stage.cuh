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
//   * the leading @grid chain is part of the CUDA grid, one program per
//     block; the schedule's grid pass maps only loops whose iterations are
//     independent, so the blocks may run in any order;
//   * below it, the emitter spreads the leading loops whose iterations are
//     independent (no carried reduction or scan, no scratch read before
//     the iteration writes it, each HBM tile written and read by one
//     iteration only) over blocks too, and where that leaves SMs idle and
//     every statement is row-local it cuts each tile's rows into parts,
//     one block each, with the same statements in the same order; the
//     block index is decoded into the grid, spread and part variables;
//   * scratch buffers (@vreg / @vmem) live in dynamic shared memory,
//     zeroed at the start of every block, as the reference's scratch is
//     fresh per program; under a row split an accumulator used only at
//     row 0 holds the block's own rows only;
//   * HBM buffers are global pointers at full shape; a tile's origin is
//     its affine index times the tile size per dimension, in 64-bit
//     offsets;
//   * every statement is a loop of the whole block over the tile's
//     elements, followed by __syncthreads(), since the next statement may
//     read what this one wrote;
//   * a floating value is computed in f32 (bf16 and f16 inputs are widened
//     exactly) and rounded to bf16 or f16 where the reference's value has
//     that type; an integer value (int32, int8) is computed in int and
//     wraps as the reference's type does; every store converts to the
//     destination's type as the reference's astype does (a float into an
//     integer type truncates toward zero, saturates, and takes NaN to 0);
//   * scratch that does not fit in shared memory, and a staged result too
//     large for it, live in a per-block workspace in global memory that
//     the launch allocates; such a stage runs a bounded number of blocks,
//     each walking programs in a loop and zeroing its workspace per
//     program;
//   * a matmul tile of rank above 2 is a loop of 2-D products over the
//     operands' leading tile dimensions, as the reference's jnp.dot
//     computes it (the output is (lhs leading, M, rhs leading, N)).
//
// What bounds it: the compiled graphs materialise every intermediate in
// HBM, so a stage moves whole (S, S) score tensors, and a nest whose rows
// cannot be cut (a scan, a 7-row decode tile) runs as few blocks as its
// independent loops give.  IEEE f32 FMA on the CUDA cores, no tensor
// cores, no TMA, no asynchronous copies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stagecc_stage {

// Loads: a floating element widens to float, an integer one to int.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ int ld(const int* p) { return *p; }
__device__ __forceinline__ int ld(const int8_t* p) { return *p; }

// int8's wrap: x modulo 2^8, as a signed value
__device__ __forceinline__ int wrap8(int x) {
  return static_cast<int>(static_cast<int8_t>(x));
}
// a float into an integer type as XLA converts it: toward zero, clamped
// to the type's range, NaN to 0 (PTX's cvt.rzi clamps and takes NaN to 0)
__device__ __forceinline__ int sat32(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int sat8(float x) {
  return min(max(__float2int_rz(x), -128), 127);
}

// Stores: to the destination's type, as the reference's astype.
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st(__half* p, float x) {
  *p = __float2half_rn(x);
}
__device__ __forceinline__ void st(int* p, float x) { *p = sat32(x); }
__device__ __forceinline__ void st(int8_t* p, float x) {
  *p = static_cast<int8_t>(sat8(x));
}
__device__ __forceinline__ void st(float* p, int x) {
  *p = static_cast<float>(x);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, int x) {
  *p = __float2bfloat16_rn(static_cast<float>(x));
}
__device__ __forceinline__ void st(__half* p, int x) { *p = __int2half_rn(x); }
__device__ __forceinline__ void st(int* p, int x) { *p = x; }
__device__ __forceinline__ void st(int8_t* p, int x) {
  *p = static_cast<int8_t>(x);
}
// x rounded to the nearest bf16 / f16 (ties to even) and widened back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float f16r(float x) {
  return __half2float(__float2half_rn(x));
}

// A rank-2 view of a tile: element (r, c) at p[r * rs + c * cs].
template <typename T>
struct View2 {
  T* p;
  long long rs, cs;
  __device__ __forceinline__ auto get(int r, int c) const {
    return ld(p + r * rs + c * cs);
  }
  __device__ __forceinline__ void put(int r, int c, float x) const {
    st(p + r * rs + c * cs, x);
  }
};

// Zero `bytes` (a multiple of 16, 16-byte aligned) of shared or global
// memory with the whole block.
template <int NT>
__device__ __forceinline__ void zero_shared(unsigned char* p, long long bytes) {
  float4* q = reinterpret_cast<float4*>(p);
  for (long long i = threadIdx.x; i < bytes / 16; i += NT)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

constexpr int kChunk = 16;  // k columns staged in shared memory per step

// d (TM x TN) = [d +] a (TM x TK) @ b (TK x TN), with the whole block of NT
// threads.  The block is an RX-wide grid of threads, each holding an MI x
// MJ register tile of outputs strided by the grid; tiles larger than the
// grid's RY*MI x RX*MJ pass are walked in passes.  k is staged through
// shared memory `sm` (kChunk * (RY*MI + RX*MJ) floats) in chunks, walked
// in order, so each output is an f32 sum in k order (FFMA, no TF32); then
// `ACC` adds it to d as read in f32, as the reference's `dst + dot`.  A
// thread with few outputs (MI * MJ <= 16: a row-split part, a narrow
// tile) loads its share of the next chunk into registers while the block
// computes on this one, so the chunk's loads are in flight together and
// behind the arithmetic; measured on the H100, that halves such a stage,
// while a thread holding 8 x 8 outputs has no registers to spare (it would
// drop to one block per SM) and stages each chunk as it goes.  All reads
// of a and b are done before the last __syncthreads of a pass, so d may
// not alias them within a pass: the emitter stages such statements.
template <int NT, int TM, int TN, int TK, int RX, int MI, int MJ, bool ACC,
          typename TA, typename TB, typename TD>
__device__ __forceinline__ void matmul_tile(const View2<TA>& a,
                                            const View2<TB>& b,
                                            const View2<TD>& d, float* sm) {
  constexpr int RY = NT / RX, PM = RY * MI, PN = RX * MJ;
  constexpr int LA = (PM * kChunk + NT - 1) / NT;  // a elements per thread
  constexpr int LB = (kChunk * PN + NT - 1) / NT;  // b elements per thread
  constexpr bool kAhead = MI * MJ <= 16;  // load chunk k+1 during chunk k
  float* as = sm;                 // [kChunk][PM], k-major
  float* bs = sm + kChunk * PM;   // [kChunk][PN]
  const int tx = threadIdx.x % RX, ty = threadIdx.x / RX;
  float ra[LA], rb[LB];
  for (int r0 = 0; r0 < TM; r0 += PM) {
    for (int c0 = 0; c0 < TN; c0 += PN) {
      // chunk k0 of a and b into registers, zero outside the tile;
      // neighbouring threads take neighbouring k of a row of a
      auto load = [&](int k0) {
#pragma unroll
        for (int i = 0; i < LA; ++i) {
          const int e = threadIdx.x + i * NT, r = e / kChunk, k = e % kChunk;
          ra[i] = (e < PM * kChunk && r0 + r < TM && k0 + k < TK)
                      ? a.get(r0 + r, k0 + k) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int e = threadIdx.x + i * NT, k = e / PN, c = e % PN;
          rb[i] = (e < kChunk * PN && c0 + c < TN && k0 + k < TK)
                      ? b.get(k0 + k, c0 + c) : 0.f;
        }
      };
      float acc[MI][MJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
      if (kAhead) load(0);
      for (int k0 = 0; k0 < TK; k0 += kChunk) {
        if (kAhead) {
#pragma unroll
          for (int i = 0; i < LA; ++i) {
            const int e = threadIdx.x + i * NT;
            if (e < PM * kChunk) as[(e % kChunk) * PM + e / kChunk] = ra[i];
          }
#pragma unroll
          for (int i = 0; i < LB; ++i) {
            const int e = threadIdx.x + i * NT;
            if (e < kChunk * PN) bs[e] = rb[i];
          }
        } else {
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
        }
        __syncthreads();
        if (kAhead && k0 + kChunk < TK) load(k0 + kChunk);
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

// Sum or max of a warp's 32 values, left in every lane; an int sum wraps
// modulo 2^32, as the reference's int32 sum does.
template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}
template <bool MAX>
__device__ __forceinline__ int warp_reduce(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? max(x, y) : static_cast<int>(static_cast<unsigned>(x) +
                                           static_cast<unsigned>(y));
  }
  return x;
}

}  // namespace stagecc_stage
