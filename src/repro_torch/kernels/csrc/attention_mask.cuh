// The masks, the key-tile walk and the launch in slices of heads, shared by
// the three attention kernels: flash_attention.cu (simt),
// flash_attention_ffma.cu (ffma) and flash_attention_sm90.cu (wgmma).
//
// The function: query row i of Sq sits at position qpos = i + (Sk - Sq);
// causal keeps keys kpos <= qpos, a window keeps kpos > qpos - window;
// masked logits are kNeg = -1e30 (not -inf), so a row masked everywhere
// returns the mean of V; keys past Sk weight exactly 0.
//
// Whole-tile skips (key_tiles): a block walks only the key tiles that meet
// [lo of its first row, hi of its last] (both ends grow with the row), and
// only when every row of the block has an unmasked key.  That leaves the
// result exactly as it is: a skipped tile's weights would be
// exp(-1e30 - m) = 0 after the row's first unmasked key, or would be wiped
// by corr = exp(-1e30 - m) = 0 before it.  A block holding a row masked
// everywhere walks every tile, since that row averages all of V.

#pragma once

namespace attn {

constexpr float kNeg = -1e30f;
constexpr int kMaxGridY = 65535;  // blocks a grid's y axis can hold

struct Mask {
  int causal, has_window;
  long long window, offset;  // offset = Sk - Sq
};

// The keys a query at position qpos may attend: [lo, hi], empty if lo > hi.
__device__ __forceinline__ void key_range(long long qpos, int sk,
                                          const Mask& mk, long long& lo,
                                          long long& hi) {
  lo = 0;
  hi = sk - 1;
  if (mk.causal) hi = min(hi, qpos);
  if (mk.has_window) lo = max(lo, qpos - mk.window + 1);
}

__device__ __forceinline__ bool allowed(long long qpos, long long kpos,
                                        const Mask& mk) {
  return (!mk.causal || kpos <= qpos) &&
         (!mk.has_window || kpos > qpos - mk.window);
}

// [k_begin, k_end): the keys that the block's query rows q0 .. q0 + rows - 1
// walk, k_begin a multiple of BK.  Every thread of the block calls it (it
// holds a barrier), and the block has at least `rows` threads.
template <int BK>
__device__ __forceinline__ void key_tiles(int q0, int rows, int sk,
                                          const Mask& mk, int& k_begin,
                                          int& k_end) {
  long long lo, hi;
  int empty = 0;
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < rows) {
    key_range(q0 + tid + mk.offset, sk, mk, lo, hi);
    empty = lo > hi;
  }
  empty = __syncthreads_or(empty);
  k_begin = 0;
  k_end = sk;
  if (!empty) {
    key_range(q0 + mk.offset, sk, mk, lo, hi);
    k_begin = static_cast<int>(lo / BK) * BK;
    key_range(q0 + rows - 1 + mk.offset, sk, mk, lo, hi);
    k_end = static_cast<int>(hi) + 1;
  }
}

// launch(b0, n) for each slice [b0, b0 + n) of the bh heads, n at most
// kMaxGridY; returns the first nonzero result, else 0.
template <typename Launch>
int bh_slices(int bh, Launch launch) {
  for (int b0 = 0; b0 < bh; b0 += kMaxGridY) {
    const int err = launch(b0, bh - b0 < kMaxGridY ? bh - b0 : kMaxGridY);
    if (err) return err;
  }
  return 0;
}

}  // namespace attn
