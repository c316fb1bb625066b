// The TF32 tensor-core pieces that csrc/wkv6.cu, csrc/wkv6_bwd.cu and the
// float32 routes of csrc/flash_attention.cu and csrc/flash_attention_bwd.cu
// share: an f32 value split into two TF32 halves (split, split4), mma.sync
// m16n8k8 on TF32 operands (mma_tf32), the product of split operands as
// three such products (mma3), and 16- or 4-byte cp.async copies into shared
// memory; then the attention kernels' own: q, k and v's strides and whether
// they allow 16-byte copies (Strides, vec_ok), rows of a strided f32 operand
// into a shared tile (load_rows), a warp's 16 rows times a tile's rows
// (dot_rows) and accumulator fragments times a tile (accumulate_rows).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

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
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// q, k and v's (batch, row, head) strides, in elements
struct Strides {
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// whether load_rows may copy 16 bytes at a time: every operand's base
// 16-byte aligned and every stride a multiple of 4 floats
inline bool vec_ok(std::initializer_list<const void*> bases,
                   const Strides& st) {
  uintptr_t any = 0;
  for (const void* p : bases) any |= reinterpret_cast<uintptr_t>(p);
  const long long strides = st.qsb | st.qss | st.qsh | st.ksb | st.kss |
                            st.ksh | st.vsb | st.vss | st.vsh;
  return any % 16 == 0 && strides % 4 == 0;
}

// ROWS rows x HD of a row-strided f32 operand from row row0 -> dst (row
// HD + 4 floats), zeros past n_rows, by the block's NT threads: 16 bytes a
// copy where `vec`, else 4.  Rows of HD + 4 floats (4 mod 32) let the
// fragment reads of dot_rows and accumulate_rows reach 32 banks for 32
// lanes, and keep rows 16-byte aligned for cp.async.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows, bool vec) {
  constexpr int LD = HD + 4;
  if (vec) {
    constexpr int kPer = HD / 4;
    for (int idx = threadIdx.x; idx < ROWS * kPer; idx += NT) {
      const int r = idx / kPer, c = (idx % kPer) * 4;
      float* d = dst + r * LD + c;
      if (row0 + r < n_rows)
        cp_async16(d, src + (long long)(row0 + r) * row_stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += NT) {
      const int r = idx / HD, c = idx % HD;
      float* d = dst + r * LD + c;
      if (row0 + r < n_rows)
        cp_async4(d, src + (long long)(row0 + r) * row_stride + c);
      else
        *d = 0.0f;
    }
  }
}

// acc[j] = A B^T for the warp's 16 rows of A and 8 rows 8 j .. 8 j + 7 of
// B, j < N, over HD: S = Q K^T, dP = dO V^T and their transposes.  A and B
// point at row 0 of the warp's rows (row HD + 4 floats); g = lane / 4, t =
// lane % 4.
template <int HD, int N>
__device__ __forceinline__ void dot_rows(float (&acc)[N][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int g,
                                         int t) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* a = A + g * LD + 8 * kk + t;
    const float av[4] = {a[0], a[8 * LD], a[4], a[8 * LD + 4]};
    uint32_t ah[4], al[4];
    split4(av, ah, al);
    float b[N][2];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float* bp = B + (8 * j + g) * LD + 8 * kk + t;
      b[j][0] = bp[0];
      b[j][1] = bp[4];
    }
    mma3<N>(acc, ah, al, b);
  }
}

// acc[i] (the warp's 16 rows x head columns 8 i .. 8 i + 7) += X Y, X the
// 16 x 8 NK product that x holds as accumulator fragments (x[j]: columns
// 8 j .. 8 j + 7), Y rows 0 .. 8 NK - 1 of a tile (row HD + 4 floats).  The
// sum over X's columns runs in a permuted order: k slot t of step j is
// column 8 j + 2 t, slot t + 4 column 8 j + 2 t + 1, so x[j] is the A
// fragment as it lies, and B's fragment is Y's rows 8 j + 2 t and + 1.
template <int HD, int NK>
__device__ __forceinline__ void accumulate_rows(float (&acc)[HD / 8][4],
                                                const float (&x)[NK][4],
                                                const float* __restrict__ Y,
                                                int g, int t) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float av[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
    uint32_t ah[4], al[4];
    split4(av, ah, al);
    const float* y = Y + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int i0 = 0; i0 < HD / 8; i0 += 4) {
      float b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i][0] = y[8 * (i0 + i)];
        b[i][1] = y[LD + 8 * (i0 + i)];
      }
      mma3<4>(&acc[i0], ah, al, b);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.0f;
}

}  // namespace
