// The TF32 tensor-core pieces that csrc/wkv6.cu, csrc/wkv6_bwd.cu and
// csrc/flash_attention_bwd.cu's float32 route share: an f32 value split
// into two TF32 halves (split, split4), mma.sync m16n8k8 on TF32 operands
// (mma_tf32), the product of split operands as three such products (mma3),
// and 16-byte cp.async copies into shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

}  // namespace
