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
// both products on the tensor cores (the TMA, mbarrier and wgmma pieces it
// shares with the backward are in hopper.cuh).  A block owns 128 query rows
// of one (batch, query head) and has three warpgroups:
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

#include "hopper.cuh"

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

constexpr int kStages = 2;      // K and V tiles in flight
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr float kNegInf = -1e30f;
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
