// Mamba-2 SSD chunked scan for Hopper (sm_90a).
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
// Arithmetic: IEEE f32 on the CUDA cores; bf16 inputs are widened on load.
//
// What bounds it: at mamba2-130m's widths (P = 64, N = 128, L = 64, 24
// heads) the function does 14.7 GFLOP on 220 MB at batch 4 x 4096 steps,
// ~67 flops per byte, above the ~20 the f32 CUDA cores need per HBM byte
// (B and C are read by all 24 heads, from L2): the least time is the
// flops over the 67 TFLOP/s f32 rate (0.22 ms there).  The design keeps
// everything of a chunk in shared memory (x, dt·x, B, C, G, s and the
// state: 147 KB at those widths), and each thread a 4 x 4 tile of G or y,
// or an 8 x 4 tile of the state, in registers, reading float4 rows.
//
// Design: the TPU grid is (H, S/L), and its chunk axis carries the state
// in VMEM scratch.  That axis is sequential, so it becomes a loop over
// chunks inside one block of 256 threads per (sequence, head; the sequence
// is the grid's y axis, launched in slices of at most 65535), with the
// state in shared memory, stored transposed (h_s[n][p]) so that a row of
// the output reads 4 consecutive p as one float4.  Per chunk: (0) load x,
// dt, B, C, zero-padded to multiples of 4; one thread takes the cumsum,
// in order; (1) G; (2) y; (3) the state update, each thread updating the
// elements it owns.  batch x H blocks (96 at 4 x 24) leave 36 of the 132
// SMs idle and run one chunk after another: a three-pass design (chunk
// states, state passing, outputs) that runs the chunks in parallel is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLMax = 64;   // chunk: 16 thread rows x 4
constexpr int kPMax = 64;   // head dim: 16 thread columns x float4
constexpr int kNMax = 128;  // state dim: 16 thread rows x 8
constexpr int kMaxGridY = 65535;  // blocks a grid's y axis can hold

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Copy L rows of `width` elements, the row t at src + t * stride, to dst
// (row stride ld), zero from `width` up to the next multiple of 4.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int L, int width,
                                          int width4) {
  for (int e = threadIdx.x; e < L * width4; e += kThreads) {
    const int t = e / width4, c = e - t * width4;
    dst[t * ld + c] = c < width ? to_f32(src[t * stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ B,
                    const T* __restrict__ C, T* __restrict__ y, int S, int H,
                    int P, int N, int L) {
  extern __shared__ float4 smem4[];
  const int p4 = (P + 3) / 4 * 4, n4 = (N + 3) / 4 * 4, np = n4 + 4;
  float* h_s = reinterpret_cast<float*>(smem4);  // [n4][p4] state h^T
  float* b_s = h_s + n4 * p4;                    // [L][np]
  float* c_s = b_s + L * np;                     // [L][np]
  float* x_s = c_s + L * np;                     // [L][p4]
  float* xw_s = x_s + L * p4;  // [L][p4] dt o x, then exp(s_L - s) dt o x
  float* g_s = xw_s + L * p4;  // [L][L + 1] G
  float* s_s = g_s + L * (L + 1);  // [L] cumsum
  float* dt_s = s_s + L;           // [L]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = (long long)H * P;  // x's stride along S
  const T* xb = x + b * S * row + (long long)h * P;
  T* yb = y + b * S * row + (long long)h * P;
  const T* dtb = dt + b * S * H + h;
  const T* bb = B + b * S * N;
  const T* cb = C + b * S * N;
  const float a = A[h];
  const int p = 4 * tx;  // this thread's 4 columns of y and of the state

  for (int e = tid; e < n4 * p4; e += kThreads) h_s[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();  // the last chunk is done with every buffer
    load_rows(x_s, p4, xb + t0 * row, row, L, P, p4);
    load_rows(b_s, np, bb + (long long)t0 * N, N, L, N, n4);
    load_rows(c_s, np, cb + (long long)t0 * N, N, L, N, n4);
    for (int t = tid; t < L; t += kThreads)
      dt_s[t] = to_f32(dtb[(long long)(t0 + t) * H]);
    __syncthreads();
    if (tid == 0) {  // in order, as a running sum
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += dt_s[t] * a;
        s_s[t] = run;
      }
    }
    for (int e = tid; e < L * p4; e += kThreads)
      xw_s[e] = dt_s[e / p4] * x_s[e];
    __syncthreads();

    // (1) G[t][u] for t = ty + 16i, u = tx + 16j (rows past L clamped and
    // not stored)
    {
      float cbt[4][4] = {};
      for (int n = 0; n < n4; n += 4) {
        float4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(
              b_s + min(tx + 16 * j, L - 1) * np + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(
              c_s + min(ty + 16 * i, L - 1) * np + n);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cbt[i][j] = fmaf(cv.x, bv[j].x, cbt[i][j]);
            cbt[i][j] = fmaf(cv.y, bv[j].y, cbt[i][j]);
            cbt[i][j] = fmaf(cv.z, bv[j].z, cbt[i][j]);
            cbt[i][j] = fmaf(cv.w, bv[j].w, cbt[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, u = tx + 16 * j;
          if (t < L && u < L)  // exp only where u <= t
            g_s[t * (L + 1) + u] =
                u <= t ? expf(s_s[t] - s_s[u]) * cbt[i][j] : 0.f;
        }
    }
    __syncthreads();

    // (2) y[t][p..p+3] = exp(s_t) (C h^T)[t] + (G (dt o x))[t]
    if (p < p4) {
      float yi[4][4] = {}, ye[4][4] = {};
      for (int u = 0; u < L; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(xw_s + u * p4 + p);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(yi[i], g_s[min(ty + 16 * i, L - 1) * (L + 1) + u], xv);
      }
      for (int n = 0; n < n4; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(h_s + n * p4 + p);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(ye[i], c_s[min(ty + 16 * i, L - 1) * np + n], hv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
        const float es = expf(s_s[t]);
        T* yt = yb + (t0 + t) * row + p;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p + e < P) store(yt + e, es * ye[i][e] + yi[i][e]);
      }
    }
    __syncthreads();  // h and dt o x are read

    // (3) h^T[n][p..p+3] = exp(s_L) h^T + sum_u B[u][n] (w o x)[u], with
    // w = exp(s_L - s) dt, for n = ty + 16i
    const float s_last = s_s[L - 1];
    for (int e = tid; e < L * p4; e += kThreads) {
      const int u = e / p4;
      xw_s[e] = expf(s_last - s_s[u]) * dt_s[u] * x_s[e];
    }
    __syncthreads();
    if (p < p4) {
      float hn[8][4] = {};
      for (int u = 0; u < L; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(xw_s + u * p4 + p);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          fma4(hn[i], b_s[u * np + min(ty + 16 * i, n4 - 1)], xv);
      }
      const float decay = expf(s_last);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = ty + 16 * i;
        if (n >= n4) continue;
        float4* hp = reinterpret_cast<float4*>(h_s + n * p4 + p);
        float4 hv = *hp;
        hv.x = decay * hv.x + hn[i][0];
        hv.y = decay * hv.y + hn[i][1];
        hv.z = decay * hv.z + hn[i][2];
        hv.w = decay * hv.w + hn[i][3];
        *hp = hv;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int batch, int S, int H, int P, int N,
           int L, cudaStream_t stream) {
  if (L < 1 || L > kLMax || S % L || P < 1 || P > kPMax || N < 1 ||
      N > kNMax)
    return (int)cudaErrorInvalidValue;
  const int p4 = (P + 3) / 4 * 4, n4 = (N + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (n4 * p4 + 2 * L * (n4 + 4) +
                                       2 * L * p4 + L * (L + 1) + 2 * L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const long long ox = (long long)b0 * S * H * P,
                    odt = (long long)b0 * S * H, obc = (long long)b0 * S * N;
    const int n = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    ssd_scan_kernel<T><<<dim3(H, n), kThreads, smem, stream>>>(
        static_cast<const T*>(x) + ox, static_cast<const T*>(dt) + odt,
        static_cast<const float*>(A), static_cast<const T*>(B) + obc,
        static_cast<const T*>(C) + obc, static_cast<T*>(y) + ox, S, H, P, N,
        L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); A is float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take.  Launches on
// `stream` and does not synchronise.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* B, const void* C,
                               void* y, int batch, int S, int H, int P, int N,
                               int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, batch, S, H, P, N, L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, batch, S, H, P, N, L, s);
  return (int)cudaErrorInvalidValue;
}
