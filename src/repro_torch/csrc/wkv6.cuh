// The pieces that csrc/wkv6.cu's chunk- and tile-parallel forwards and
// csrc/wkv6_bwd.cu's chunk- and tile-parallel backwards share: the 64-row
// sub-tile (the tile-parallel routes' tile) and its 68-float shared rows,
// cp.async tile loads, the blocked scan of the log decays (load_w,
// scan_rows), so that a row's LW has the same bits in every kernel that
// rebuilds it, the walks' reduce-scatter over a half-warp (halve), and
// the row bounds of ragged sub-tiles and chunks (zero_rows, chunk_start).  The
// TF32 tensor-core product split in three (split, mma3) is in tf32.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

constexpr int kTS = 64;       // rows per sub-tile; also the most K and V
constexpr int kThreads = 256;
constexpr float kClamp = 30.0f;

// A shared tile's row is 68 floats (4 mod 32): the fragment reads are free
// of bank conflicts and 16-byte cp.async rows stay aligned
constexpr int kLDT = kTS + 4;
constexpr int kTile = kTS * kLDT;        // floats of one 64-row tile
constexpr int kSeg = 16;                 // rows of one scan segment

// rows x n (n a multiple of 4) of a row-strided operand -> dst[t * kLDT + c]
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int n) {
  const int per_row = n >> 2;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int t = idx / per_row, c = (idx % per_row) * 4;
    cp_async16(dst + t * kLDT + c, src + (long long)t * row_stride + c);
  }
}

// exp(clip(x, -30, 30)) by ex2.approx (__expf): within 2 + 1.2 |x| ulp, so
// under 1e-5 relative at |x| <= 30.  The unclipped __expf below it is as
// close down to e^-87, where it flushes to 0 and the plain version keeps a
// subnormal.
__device__ __forceinline__ float fast_clamp_exp(float x) {
  return __expf(fminf(fmaxf(x, -kClamp), kClamp));
}

// Thread (seg, ch), seg = tid / 64, ch = tid % 64: its 16 values of w in
// rows 16 seg .. + 15 of a 64-row sub-tile, channel ch (0 past K and past
// the sub-tile's first ``rows`` rows; at the constant rows = 64 the row
// test folds away), straight from device memory; a warp reads 32
// neighbouring floats of a row.
__device__ __forceinline__ void load_w(float* wv, const float* src,
                                       long long row_stride, int K,
                                       int rows = kTS) {
  const int seg = threadIdx.x >> 6, ch = threadIdx.x & 63;
#pragma unroll
  for (int t = 0; t < kSeg; ++t)
    wv[t] = ch < K && (rows == kTS || seg * kSeg + t < rows)
                ? src[(long long)(seg * kSeg + t) * row_stride + ch]
                : 0.0f;
}

// The blocked scan of one 64-row sub-tile: from its values wv (load_w) and
// the channel's LW before the sub-tile, carry, thread (seg, ch) gets LW of
// its 16 rows in lw: its segment summed in order, plus the carry and the
// earlier segments' totals.  It syncs the block once; seg_sum (4 x 64
// floats) is free again after the caller's next __syncthreads.
__device__ __forceinline__ void scan_rows(const float* wv, float* seg_sum,
                                          float carry, float* lw) {
  const int seg = threadIdx.x >> 6, ch = threadIdx.x & 63;
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    run += wv[t];
    lw[t] = run;
  }
  seg_sum[seg * kTS + ch] = run;
  __syncthreads();
  float base = carry;
  for (int s = 0; s < seg; ++s) base += seg_sum[s * kTS + ch];
#pragma unroll
  for (int t = 0; t < kSeg; ++t) lw[t] = base + lw[t];
}

// One step of a reduce-scatter over lane bit H: of x[0 .. 2H), the lane
// keeps the upper half if its bit H is set, else the lower, adds its
// partner's copy of it and leaves it in x[0 .. H).  After H = 8, 4, 2, 1
// lane j of a half-warp holds the half-warp's sum of x[j] (the walks').
template <int H>
__device__ __forceinline__ void halve(float* x, int lane) {
  const bool hi = lane & H;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float send = hi ? x[m] : x[m + H];
    x[m] = (hi ? x[m + H] : x[m]) + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

__device__ __forceinline__ void zero_smem(float* p, int n) {
  for (int idx = threadIdx.x; idx < n; idx += kThreads) p[idx] = 0.0f;
}

// rows ``from`` .. 63 of a shared 64-row tile <- 0 (a ragged sub-tile's
// rows past its last, over a buffer an earlier sub-tile filled), by a block
// of kN threads
template <int kN = kThreads>
__device__ __forceinline__ void zero_rows(float* tile, int from) {
  for (int idx = threadIdx.x; idx < (kTS - from) * kTS; idx += kN)
    tile[(from + idx / kTS) * kLDT + idx % kTS] = 0.0f;
}

// The first row of row i's chunk of L rows: a mask where L is a power of
// two (every L that divides 64), else a division.
template <bool kPow2>
__device__ __forceinline__ int chunk_start(int i, int L) {
  return kPow2 ? i & -L : i - i % L;
}

}  // namespace
