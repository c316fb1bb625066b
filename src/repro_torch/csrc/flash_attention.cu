// Blocked GQA softmax attention (forward), by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention
// (_kernel).  For query row i of head h (kv head h / G) it computes
//   s_ij = (q_i . k_j) * scale      (f32; NEG_INF = -1e30 where j > i under
//                                    the causal mask; -inf for kv columns
//                                    past the ragged edge, so they weigh 0)
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)
// with the running max m_i and sum l_i of the online softmax kept in f32
// (l summed from the f32 weights), and writes o in q's dtype.  Given an
// lse pointer, (B, Hq, Sq) f32, both kernels also write each row's
// logsumexp m_i + log l_i (natural log) for the backward kernels
// (csrc/flash_attention_bwd.cu); a null pointer writes nothing.
//
// What bounds it: operations.  At the Qwen3-0.6B prefill (B 4, S 1024,
// 16 query heads of 128, 8 kv heads, causal, bf16) the two products are
// 17.2 GFLOP per call against about 50 MB of q/k/v/o traffic: about 17 us
// at the card's bf16 tensor-core rate, 15 us at its memory rate.
//
// Two kernels live here.
//
// flash_fwd_wgmma (bf16, head width 64 or 128: every full-size config) runs
// both products on the tensor cores.  A block owns 128 query rows of one
// (batch, query head) and has three warpgroups:
//   * a producer warpgroup, one thread of which issues TMA loads
//     (cp.async.bulk.tensor, 4-D tensor maps over the (B, S, H, hd) strides,
//     so nothing is transposed or copied; 128-byte swizzle) of the Q tile
//     once and of 64-row K and V tiles into a ring of two stages, each with
//     a full and an empty mbarrier;
//   * two consumer warpgroups of 64 query rows each.  S = Q K^T is
//     wgmma m64n64k16 with both operands in shared memory; the online
//     softmax runs on the accumulator registers (row max and sum over the
//     4 threads that share a row, exp2 with the scale folded into log2 e);
//     O += P V is wgmma with P from registers and V as a transposed
//     (MN-major) shared-memory operand: a wgmma accumulator fragment is
//     the 16-bit A fragment, so P needs no shuffle.  Tile n's S and tile
//     n - 1's P V are issued together, so S_n's softmax runs while P V is on
//     the tensor cores, and the two warpgroups take turns to issue
//     (named barriers), so one's softmax overlaps the other's products.
// The plain version weighs v by the f32 P.  Rounding P to bf16 alone would
// move outputs near 0 by about 2^-10 |v|, far outside the kernel's gate
// (1e-5 + 2^-7 |plain| in bf16), so P is split, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V: about 16 bits of P, at
// 1.5x the tensor-core work of the bound's count.  Tiles wholly above the
// diagonal are skipped (they add exactly 0); masks run only on tiles that
// reach the diagonal or the ragged edge; TMA zero-fills rows past the end,
// and the masks still give those kv columns -inf.  Query tiles run
// longest-first.  The two query heads that share a kv head are not paired
// in one block: each block loads its own K and V.
// Registers: setmaxnreg moves the producer warpgroup to 40 and the
// consumers to 232, but ptxas still compiles every path within the
// 168-register cap of 384 threads, so the consumer's in-flight state has to
// fit 168: O (hd / 2), S (32) and P's two halves (16 + 16).  That is why
// the kv tile is 64 rows: at 128 rows the overlapped schedule spills.
//
// flash_fwd_kernel (float32, and bf16 at head width 32) computes in f32
// FMAs on the CUDA cores.  One block owns one (batch, query head, 64-row
// query tile) and loops over 64-row kv tiles: the query tile stays in
// shared memory, the kv tile is staged there (K, then V in the same
// buffer), and each of the 256 threads keeps 4 rows x (hd / 16) columns of
// acc and the 4 rows' m and l in registers; row statistics are reduced
// across the 16 threads that share the rows with warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 256; // 16 x 16: 4 rows x 4 (or hd/16) columns each
constexpr int kPLD = kBK + 1; // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = row0 + r;
    dst[r * LD + d] = s < n_rows ? to_f32(src[(long long)s * row_stride + d])
                                 : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int G,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x LD
  float* KVs = Qs + kBQ * LD;   // kBK x LD: the K tile, then the V tile
  float* Ps = KVs + kBK * LD;   // kBQ x kPLD

  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / G) * ksh;
  const T* vb = v + b * vsb + (h / G) * vsh;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    Qs[r * LD + d] = s < Sq ? to_f32(qb[(long long)s * qss + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int n_k = (Skv + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_k, q_last / kBK + 1) : n_k;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P @ V is done with KVs and Ps
    load_tile<T, HD>(KVs, kb, kss, k0, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Skv) {
          x = -INFINITY;            // past the ragged edge: weighs exactly 0
        } else if (causal && kpos > qpos) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kPLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // every thread is done reading the K tile
    load_tile<T, HD>(KVs, vb, vss, k0, Skv);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPLD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = KVs[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Hq + h) * Sq + s] = m[i] + logf(l[i]);
    T* orow = o + (((long long)b * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      store(orow + tx + 16 * cc, acc[i][cc] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, long long qsb,
           long long qss,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (HD + 1) + kBQ * kPLD);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, Hq,
      Hq / Hkv,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 on the tensor cores, head width 64 or 128
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kBM = 128;        // query rows per block: 2 consumer warpgroups
constexpr int kBN = 64;         // kv rows per tile
constexpr int kStages = 2;      // K and V tiles in flight
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr uint32_t kRowBytes = 128;  // 64 bf16 columns: the swizzle span
constexpr uint32_t kQColBlock = kBM * kRowBytes;   // a 64-column block of Q
constexpr uint32_t kColBlock = kBN * kRowBytes;    // ... of a K or V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Tiles {
  // a tile is HD / 64 column blocks of its rows x 128 bytes, each
  // 1024-byte aligned and swizzled by TMA as wgmma reads it
  static constexpr uint32_t kBytes = kColBlock * (HD / 64);     // K or V
  static constexpr uint32_t kQBytes = kQColBlock * (HD / 64);   // Q
  // Q, the K ring, the V ring, 1 + 4 * kStages mbarriers, alignment slack
  static constexpr uint32_t kSmem =
      1024 + kQBytes + 2 * kStages * kBytes + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that never
// completes is a fault of the kernel: trap (an error that the next
// synchronize reports) instead of spinning on the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}

// One box (64 head columns x the map's rows, of one head of one batch) by
// TMA; rows past the end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands (Q, K)
// step 8-row groups by SBO = 1024; the MN-major V steps 8-row groups of its
// K axis (kv rows) by SBO = 1024 and 64-column blocks of N by LBO.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The two consumer warpgroups take turns to issue their products (named
// barrier 1 + wg is warpgroup wg's turn; barrier 0 is __syncthreads), so
// that one's softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 256;" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, 256;" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;" ::: "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma reads or
// writes: each call marks them as read and written at this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32(d, i) F8(d, i), F8(d, i + 8), F8(d, i + 16), F8(d, i + 24)

// d[32] (+)= A (64 x 16, shared memory) . B (64 x 16, shared memory)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A (64 x 16, registers) . B (16 x 128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(d, 0), F32(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, registers) . B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef F32
#undef F8

// p = hi + lo + O(2^-17 p), both halves as packed bf16 pairs (low half:
// the lower column), the layout of a wgmma A fragment.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S (+)= Q K^T over the head axis: HD / 16 steps of k16, both operands
// K-major; within a 128-byte row a step moves the start by 32 bytes.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t sQw,
                                         uint32_t sKs) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(sc, desc(sQw + (kk >> 2) * kQColBlock + off, 16, 1024),
             desc(sKs + (kk >> 2) * kColBlock + off, 16, 1024), kk > 0);
  }
}

// O += P_hi V + P_lo V over the tile's kv rows: kBN / 16 steps of k16, V
// MN-major, a step moves 16 rows (2048 bytes) down every column block.
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&phi)[kBN / 4],
                                         const uint32_t (&plo)[kBN / 4],
                                         uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc(sVs + kk * 16 * kRowBytes, kColBlock, 1024);
    wgmma_rs(acc, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
             phi[4 * kk + 3], dv);
    wgmma_rs(acc, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
             plo[4 * kk + 3], dv);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What a consumer thread needs to mask its two rows.
struct Rows {
  int qpos0, qpos1, quad, Skv, causal;
  float scale_log2;
};

// One tile of the online softmax on S's accumulator registers, in the log2
// domain (scale folded into log2 e): masks where the tile needs them, the
// new row max m, the correction c = exp2(m_old - m), P = exp2(s - m) in
// place of S, and l = l c + the f32 row sum of P.
__device__ __forceinline__ void softmax(float (&sc)[kBN / 2], const Rows& r,
                                        int k0, int q0, float& m0, float& m1,
                                        float& l0, float& l1, float& c0,
                                        float& c1) {
  const bool masked = k0 + kBN > r.Skv || (r.causal && k0 + kBN - 1 > q0);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = sc[4 * j + e] * r.scale_log2;
      float x1 = sc[4 * j + 2 + e] * r.scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * j + 2 * r.quad + e;
        if (kpos >= r.Skv) {
          x0 = -INFINITY;  // past the ragged edge: weighs exactly 0
          x1 = -INFINITY;
        } else if (r.causal) {
          if (kpos > r.qpos0) x0 = kNegInf;
          if (kpos > r.qpos1) x1 = kNegInf;
        }
      }
      sc[4 * j + e] = x0;
      sc[4 * j + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = exp2f(sc[4 * j + e] - mn0);
      sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn1);
      rs0 += sc[4 * j + e];
      rs1 += sc[4 * j + 2 + e];
    }
  }
  l0 = l0 * c0 + quad_sum(rs0);
  l1 = l1 * c1 + quad_sum(rs1);
}

__device__ __forceinline__ void split_all(const float (&p)[kBN / 2],
                                          uint32_t (&hi)[kBN / 4],
                                          uint32_t (&lo)[kBN / 4]) {
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) split(p[2 * i], p[2 * i + 1], hi[i], lo[i]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Skv, int Hq, int G, int causal,
                float scale_log2) {
  constexpr uint32_t TB = Tiles<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Tiles<HD>::kQBytes;
  const uint32_t sV = sK + kStages * TB;
  // mbarriers: Q full, then K full, V full, K empty, V empty per stage
  const uint32_t q_full = sV + kStages * TB;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_q = (Sq + kBM - 1) / kBM;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int n_k = (Skv + kBN - 1) / kBN;
  const int n_tiles = causal ? min(n_k, q_last / kBN + 1) : n_k;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int hk = h / G;
      mbar_expect_tx(q_full, Tiles<HD>::kQBytes);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        tma_load(sQ + c * kQColBlock, &tq, q_full, 64 * c, q0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t parity = ((n / kStages) & 1) ^ 1;  // round 0: free
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, TB);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          tma_load(sK + s * TB + c * kColBlock, &tk, k_full + 8 * s, 64 * c,
                   n * kBN, hk, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, TB);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          tma_load(sV + s * TB + c * kColBlock, &tv, v_full + 8 * s, 64 * c,
                   n * kBN, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const int quad = lane & 3;
    // this thread's two rows (accumulator layout of wgmma m64nNk16)
    const int qpos0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int qpos1 = qpos0 + 8;
    const uint32_t sQw = sQ + wg * 64 * kRowBytes;
    const Rows rows{qpos0, qpos1, quad, Skv, causal, scale_log2};
    if (wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, c0, c1;
    float sc[kBN / 2];                          // S, then P in f32
    uint32_t phi[kBN / 4], plo[kBN / 4];        // P split, A fragments

    // tile 0: S = Q K^T, then its softmax and P's split
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<HD>(sc, sQw, sK);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty);
    softmax(sc, rows, 0, q0, m0, m1, l0, l1, c0, c1);
    split_all(sc, phi, plo);

    // tile n: S_n = Q K_n^T and O += P_{n-1} V_{n-1} in flight together;
    // S_n's softmax runs while P_{n-1} V_{n-1} is on the tensor cores, and
    // O is rescaled to the new row max once that product has landed
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages, ps = (n - 1) % kStages;
      mbar_wait(k_full + 8 * s, (n / kStages) & 1);
      mbar_wait(v_full + 8 * ps, ((n - 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<HD>(sc, sQw, sK + s * TB);
      wgmma_commit();
      issue_pv(acc, phi, plo, sV + ps * TB);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      softmax(sc, rows, n * kBN, q0, m0, m1, l0, l1, c0, c1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(phi);
      fence_regs(plo);
      mbar_arrive(v_empty + 8 * ps);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      split_all(sc, phi, plo);
    }

    // the last tile's O += P V
    const int ls = (n_tiles - 1) % kStages;
    mbar_wait(v_full + 8 * ls, ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv(acc, phi, plo, sV + ls * TB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(phi);
    fence_regs(plo);
    mbar_arrive(v_empty + 8 * ls);

    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    if (lse != nullptr && quad == 0) {
      // m is in the log2 domain of the scaled scores
      float* lrow = lse + ((long long)b * Hq + h) * Sq;
      if (qpos0 < Sq) lrow[qpos0] = (m0 + log2f(l0)) * kLn2;
      if (qpos1 < Sq) lrow[qpos1] = (m1 + log2f(l1)) * kLn2;
    }
    __nv_bfloat16* o0 =
        o + (((long long)b * Sq + qpos0) * Hq + h) * HD + 2 * quad;
    __nv_bfloat16* o1 = o0 + 8LL * Hq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qpos0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
      if (qpos1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                  acc[4 * j + 3] / den1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, H, hd) bf16 operand, head axis contiguous, as a 4-D tensor map
// (innermost axis first) in boxes of 64 head columns x `rows` rows.  TMA takes
// a 16-byte aligned base and strides that are multiples of 16 bytes; the
// stride of an axis of extent 1 is never stepped, so any valid one serves.
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int S, int H,
                int B, long long ss, long long sh, long long sb,
                cuuint32_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t unit = 2ull * hd;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? 2ull * ss : unit,
                                 H > 1 ? 2ull * sh : unit,
                                 B > 1 ? 2ull * sb : unit};
  const cuuint32_t box[4] = {64, rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, long long qsb,
           long long qss,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, Sq, Hq, B, qss, qsh, qsb, kBM) ||
      !tensor_map(&tk, k, HD, Skv, Hkv, B, kss, ksh, ksb, kBN) ||
      !tensor_map(&tv, v, HD, Skv, Hkv, B, vss, vsh, vsb, kBN))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<HD>;
  const int smem = (int)Tiles<HD>::kSmem;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq,
      Hq / Hkv, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// bf16 at head width 64 or 128 goes to the tensor-core kernel; float32, and
// bf16 at head width 32, to the CUDA-core one
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
             long long qsb, long long qss, long long qsh, long long ksb,
             long long kss, long long ksh, long long vsb, long long vss,
             long long vsh, int causal, float scale, cudaStream_t stream) {
  constexpr bool tensor_cores = std::is_same<T, __nv_bfloat16>::value;
#define FLASH_ARGS                                                         \
  q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, \
      vss, vsh, causal, scale, stream
  switch (hd) {
    case 32:
      return launch<T, 32>(FLASH_ARGS);
    case 64:
      if constexpr (tensor_cores)
        return hopper::launch<64>(FLASH_ARGS);
      else
        return launch<T, 64>(FLASH_ARGS);
    case 128:
      if constexpr (tensor_cores)
        return hopper::launch<128>(FLASH_ARGS);
      else
        return launch<T, 128>(FLASH_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* k, const void* v, void* o, float* lse, \
           int B, int Sq, int Skv, int Hq, int Hkv, int hd, long long qsb,    \
           long long qss, long long qsh, long long ksb, long long kss,        \
           long long ksh, long long vsb, long long vss, long long vsh,        \
           int causal, float scale, cudaStream_t stream) {                    \
    return dispatch<T>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, hd, qsb, qss,    \
                       qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale,      \
                       stream);                                               \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
