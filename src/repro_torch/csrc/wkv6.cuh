// The pieces that csrc/wkv6.cu's chunk- and tile-parallel forwards and
// csrc/wkv6_bwd.cu's chunk- and tile-parallel backwards share: the 64-row
// sub-tile (the tile-parallel routes' tile) and its 68-float shared rows,
// the TF32 tensor-core product split in three (split, mma3), cp.async tile
// loads, the blocked scan of the log decays (load_w, scan_rows), so that a
// row's LW has the same bits in every kernel that rebuilds it, and the
// walks' reduce-scatter over a half-warp (halve).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTS = 64;       // rows per sub-tile; also the most K and V
constexpr int kThreads = 256;
constexpr float kClamp = 30.0f;

// A shared tile's row is 68 floats (4 mod 32): the fragment reads are free
// of bank conflicts and 16-byte cp.async rows stay aligned
constexpr int kLDT = kTS + 4;
constexpr int kTile = kTS * kLDT;        // floats of one 64-row tile
constexpr int kSeg = 16;                 // rows of one scan segment
constexpr unsigned kTF32 = 0xffffe000u;  // sign, exponent, 10 mantissa bits

// x = hi + lo, each a TF32 value (x's top 11 significant bits, then the
// next 11, both truncated), to within 2^-20 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTF32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTF32;
}

__device__ __forceinline__ void split4(const float* a, uint32_t* hi,
                                       uint32_t* lo) {
#pragma unroll
  for (int x = 0; x < 4; ++x) split(a[x], hi[x], lo[x]);
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[x] += a b[x] for N accumulators, each as a_lo b_hi + a_hi b_lo +
// a_hi b_hi, with a split by split4.  a is the m16 x k8 A fragment (a0
// (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)), b[x] the k8 x n8
// B fragment (b0 (q, g), b1 (q + 4, g)), c[x] the accumulator (c0 (g, 2q),
// c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)), where g = lane / 4
// and q = lane % 4.  The products go out one kind at a time over the N
// accumulators, so no mma waits on the one before it.
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t* ah,
                                     const uint32_t* al, const float (*b)[2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int x = 0; x < N; ++x) {
    split(b[x][0], bh[x][0], bl[x][0]);
    split(b[x][1], bh[x][1], bl[x][1]);
  }
#pragma unroll
  for (int x = 0; x < N; ++x) mma_tf32(c[x], al, bh[x]);
#pragma unroll
  for (int x = 0; x < N; ++x) mma_tf32(c[x], ah, bl[x]);
#pragma unroll
  for (int x = 0; x < N; ++x) mma_tf32(c[x], ah, bh[x]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

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

}  // namespace
