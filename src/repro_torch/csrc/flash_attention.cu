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
// (csrc/flash_attention_bwd.cu); a null pointer writes nothing.  Both
// softmaxes run in the log2 domain, the scale folded into log2 e, and sum in
// a fixed order with no atomics, so two calls give the same bits.
//
// What bounds it: operations.  At the Qwen3-0.6B prefill (B 4, S 1024,
// 16 query heads of 128, 8 kv heads, causal, bf16) the two products are
// 17.2 GFLOP per call against about 50 MB of q/k/v/o traffic: about 17 us
// at the card's bf16 tensor-core rate, 15 us at its memory rate.
//
// Two kernels live here, one a dtype, and every product of both runs on the
// tensor cores.
//
// flash_fwd_wgmma (bf16, head width 32, 64 or 128) runs both products by
// wgmma (the TMA, mbarrier and wgmma pieces it shares with the backward are
// in hopper.cuh).  A block owns 128 query rows of one (batch, query head)
// and has three warpgroups (at head width 32, 64 rows and two: see below):
//   * a producer warpgroup, one thread of which issues TMA loads
//     (cp.async.bulk.tensor, 4-D tensor maps over the (B, S, H, hd) strides,
//     so nothing is transposed or copied; 128-byte swizzle, or 64-byte at
//     head width 32, whose bf16 rows are 64 bytes) of the Q tile once and of
//     64-row K and V tiles into a ring of two stages, each with a full and
//     an empty mbarrier;
//   * two consumer warpgroups of 64 query rows each.  S = Q K^T is
//     wgmma m64n64k16 with both operands in shared memory; the online
//     softmax runs on the accumulator registers (row max and sum over the
//     4 threads that share a row); O += P V is wgmma with P from registers
//     and V as a transposed (MN-major) shared-memory operand: a wgmma
//     accumulator fragment is the 16-bit A fragment, so P needs no shuffle.
//     Tile n's S and tile n - 1's P V are issued together, so S_n's softmax
//     runs while P V is on the tensor cores, and the two warpgroups take
//     turns to issue (named barriers), so one's softmax overlaps the
//     other's products.
// The plain version weighs v by the f32 P.  Rounding P to bf16 alone would
// move outputs near 0 by about 2^-10 |v|, far outside the kernel's gate
// (1e-5 + 2^-7 |plain| in bf16), so P is split, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V: about 16 bits of P, at
// 1.5x the tensor-core work of the bound's count.  Tiles wholly above the
// diagonal are skipped (they add exactly 0); masks run only on tiles that
// reach the diagonal or the ragged edge; TMA zero-fills rows past the end,
// and the masks still give those kv columns -inf.  Query tiles run
// longest-first.  The two query heads that share a kv head are not paired
// in one block: each block loads its own K and V.  TMA needs a 16-byte
// aligned base and row, head and batch strides of 16-byte multiples: the
// wrapper refuses a bf16 view that lacks them (no configuration makes one).
// Registers: setmaxnreg moves the producer warpgroup to 40 and the
// consumers to 232, but ptxas still compiles every path within the
// 168-register cap of 384 threads, so the consumer's in-flight state has to
// fit 168: O (hd / 2), S (32) and P's two halves (16 + 16).  That is why
// the kv tile is 64 rows: at 128 rows the overlapped schedule spills.  At
// head width 32 a block has one consumer warpgroup (64 query rows, no
// turns) and is compiled for two blocks an SM (128 registers, no
// setmaxnreg): on the H100 that ran 26 % faster than the 128-row block at
// (1, 1000, 4, 2, 32), whose 32 blocks leave most of the 132 SMs idle, and
// 10 % faster at (4, 1024, 16, 8, 32); one such block an SM (232 registers)
// lost 30 % there (PERF.md).
//
// flash_fwd_tf32 (float32, head width 32, 64 or 128: every reduced config)
// multiplies on the TF32 tensor cores by mma.sync m16n8k8, every product
// split in three (tf32.cuh: x = hi + lo, each a TF32 value truncated from
// x, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi), as the f32 backward
// does: TF32 products alone would move outputs far past the f32 gate (1e-5
// + 1e-4 |plain|; tests/test_torch_flash_attention.py).  mma.sync and not
// TF32 wgmma: P leaves S's accumulator in a layout that is not the TF32 A
// fragment's, and wgmma would read V for P V from shared memory K-major
// only, that is transposed.  Each warp owns 16 whole query rows of the score
// tile, so the online softmax's row max and sum need only the 4 threads
// that share a row (quad shuffles), never another warp.  S = Q K^T over a
// 64-row K tile stays in registers as accumulator fragments (dot_rows);
// P = exp2(S scale log2 e - m) replaces it there, and O += P V takes P as
// A fragments as they lie (accumulate_rows), because the sum over the
// tile's kv rows runs in a permuted order that V's rows follow.  The query
// tile stays in shared memory; K and V tiles arrive by cp.async in a ring
// of two stages, rows of HD + 4 floats (conflict-free fragment reads),
// 16 bytes a copy where every operand's base and strides are 16-byte
// multiples, else 4 bytes a copy: the route takes any strided f32 view with
// a contiguous head axis.  A block owns kTf32Warps<HD> x 16 query rows
// (head widths 32 and 64: 4 warps, 64 rows, compiled for two blocks an SM;
// 128: 8 warps, 128 rows, whose 198 KB of f32 tiles hold one block an SM),
// longest first; a warp skips the tiles wholly above its rows' diagonal.
// Measured on the H100 (PERF.md): 4 warps at head width 128 ran 27 %
// slower, 8 warps at head width 32 5 to 40 % slower.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 on the tensor cores, head width 32, 64 or 128
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kStages = 2;      // K and V tiles in flight
// consumer warpgroups of a block, 64 query rows each: two at head widths 64
// and 128 (one block an SM); one at 32, two blocks an SM
template <int HD>
constexpr int kConsumers = HD >= 64 ? 2 : 1;
template <int HD>
constexpr int kQRows = 64 * kConsumers<HD>;            // query rows a block
template <int HD>
constexpr int kThreads = 128 * (1 + kConsumers<HD>);   // + the producer
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Tiles {
  // a tile is kBlocks column blocks of its rows x kRow bytes, swizzled by
  // TMA as wgmma reads it (hopper.cuh: HD / 64 blocks of 128-byte rows, or
  // at HD = 32 one block of 64-byte rows)
  static constexpr int kBlocks = HD >= 64 ? HD / 64 : 1;
  static constexpr uint32_t kRow = row_bytes<HD>();
  static constexpr uint32_t kBytes = kBN * 2 * HD;    // K or V
  static constexpr uint32_t kQBytes = kQRows<HD> * 2 * HD;   // Q
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
__global__ void __launch_bounds__(kThreads<HD>, 3 - kConsumers<HD>)
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

  constexpr int kRows = kQRows<HD>;
  constexpr bool kTurns = kConsumers<HD> == 2;
  const int n_q = (Sq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int n_k = (Skv + kBN - 1) / kBN;
  const int n_tiles = causal ? min(n_k, q_last / kBN + 1) : n_k;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      // every consumer thread
      mbar_init(k_empty + 8 * s, kConsumers<HD> * 128);
      mbar_init(v_empty + 8 * s, kConsumers<HD> * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring filled ----
    if constexpr (kTurns) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int hk = h / G;
      mbar_expect_tx(q_full, Tiles<HD>::kQBytes);
#pragma unroll
      for (int c = 0; c < Tiles<HD>::kBlocks; ++c)
        tma_load(sQ + c * kQColBlock, &tq, q_full, 64 * c, q0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t parity = ((n / kStages) & 1) ^ 1;  // round 0: free
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, TB);
#pragma unroll
        for (int c = 0; c < Tiles<HD>::kBlocks; ++c)
          tma_load(sK + s * TB + c * kColBlock, &tk, k_full + 8 * s, 64 * c,
                   n * kBN, hk, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, TB);
#pragma unroll
        for (int c = 0; c < Tiles<HD>::kBlocks; ++c)
          tma_load(sV + s * TB + c * kColBlock, &tv, v_full + 8 * s, 64 * c,
                   n * kBN, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (kTurns) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const int quad = lane & 3;
    // this thread's two rows (accumulator layout of wgmma m64nNk16)
    const int qpos0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int qpos1 = qpos0 + 8;
    const uint32_t sQw = sQ + wg * 64 * Tiles<HD>::kRow;
    const Rows rows{qpos0, qpos1, quad, Skv, causal, scale_log2};
    if (kTurns && wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, c0, c1;
    float sc[kBN / 2];                          // S, then P in f32
    uint32_t phi[kBN / 4], plo[kBN / 4];        // P split, A fragments

    // tile 0: S = Q K^T, then its softmax and P's split
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    if (kTurns) turn_wait(wg);
    wgmma_fence();
    issue_qk<HD>(sc, sQw, sK);
    wgmma_commit();
    if (kTurns) turn_pass(wg);
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
      if (kTurns) turn_wait(wg);
      wgmma_fence();
      issue_qk<HD>(sc, sQw, sK + s * TB);
      wgmma_commit();
      issue_pv(acc, phi, plo, sV + ps * TB);
      wgmma_commit();
      if (kTurns) turn_pass(wg);
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
           int B, int Sq, int Skv, int Hq, int Hkv, const Strides& st,
           int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, Sq, Hq, B, st.qss, st.qsh, st.qsb,
                  kQRows<HD>) ||
      !tensor_map(&tk, k, HD, Skv, Hkv, B, st.kss, st.ksh, st.ksb, kBN) ||
      !tensor_map(&tv, v, HD, Skv, Hkv, B, st.vss, st.vsh, st.vsb, kBN))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<HD>;
  const int smem = (int)Tiles<HD>::kSmem;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid((Sq + kQRows<HD> - 1) / kQRows<HD>, Hq, B);
  kern<<<grid, kThreads<HD>, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq,
      Hq / Hkv, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// flash_fwd_tf32: float32 on the TF32 tensor cores, head width 32, 64 or 128
// ---------------------------------------------------------------------------

constexpr int kBK = 64;        // kv rows of a tile
constexpr int kStages = 2;     // K / V tiles in flight

// warps of a block, each 16 query rows, and blocks an SM that the register
// budget is set for: at head width 128 one block of 8 warps (its 198 KB of
// f32 tiles allow no second), else two of 4 (without the bound ptxas keeps
// 128 registers and spills at head width 32)
template <int HD>
constexpr int kTf32Warps = HD >= 128 ? 8 : 4;
template <int HD>
constexpr int kTf32Blocks = HD >= 128 ? 1 : 2;

// One block per (kTf32Warps<HD> x 16 query rows, query head, batch),
// longest first; for every 64-row kv tile the mask reaches, with K and V in
// a ring of two stages, each warp over its 16 rows:
//   S = Q K^T (split TF32), masked and scaled into the log2 domain
//   m' = max(m, rowmax S), P = exp2(S - m'), l = l exp2(m - m') + rowsum P
//   O = O exp2(m - m') + P V (split TF32)
// then o = O / max(l, 1e-30) and lse = (m + log2 l) ln 2.  A thread's
// partial l is summed over its quad once, at the end.
template <int HD>
__global__ void __launch_bounds__(kTf32Warps<HD> * 32, kTf32Blocks<HD>)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Skv, int Hq, int G,
               Strides st, int causal, float scale_log2, int vec) {
  constexpr int NT = kTf32Warps<HD> * 32;
  constexpr int kRows = kTf32Warps<HD> * 16;
  constexpr int LD = HD + 4;
  constexpr int kTile = kBK * LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // kRows x LD
  float* Ks = Qs + kRows * LD;         // kStages x kBK x LD
  float* Vs = Ks + kStages * kTile;    // kStages x kBK x LD

  const int n_q = (Sq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kRows;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.ksb + (h / G) * st.ksh;
  const float* vb = v + b * st.vsb + (h / G) * st.vsh;
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int n_k = (Skv + kBK - 1) / kBK;
  const int n_tiles = causal ? min(n_k, q_last / kBK + 1) : n_k;

  auto load_kv = [&](int n) {
    const int s = n % kStages;
    load_rows<HD, kBK, NT>(Ks + s * kTile, kb, st.kss, n * kBK, Skv, vec);
    load_rows<HD, kBK, NT>(Vs + s * kTile, vb, st.vss, n * kBK, Skv, vec);
  };
  load_rows<HD, kRows, NT>(Qs, q + b * st.qsb + h * st.qsh, st.qss, q0, Sq,
                           vec);
  load_kv(0);
  cp_commit();
  if (n_tiles > 1) load_kv(1);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 16 * warp;
  const int qpos0 = q0w + g, qpos1 = qpos0 + 8;   // this thread's two rows
  // the warp's tiles: those its rows (none past Sq) see
  const int n_w = q0w >= Sq ? 0
                  : causal ? min(n_k, min(q0w + 15, Sq - 1) / kBK + 1)
                           : n_k;

  float acc[HD / 8][4];
  zero_frags(acc);
  float m0 = hopper::kNegInf, m1 = hopper::kNegInf, l0 = 0.0f, l1 = 0.0f;
  for (int n = 0; n < n_tiles; ++n) {
    cp_wait<1>();      // tile n has landed (this thread's copies) ...
    __syncthreads();   // ... and every thread's
    const int s = n % kStages, k0 = n * kBK;
    if (n < n_w) {
      float sc[kBK / 8][4];   // S, then P
      dot_rows<HD, kBK / 8>(sc, Qs + 16 * warp * LD, Ks + s * kTile, g, t);
      const bool masked = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0w);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[j][e] * scale_log2;
          float x1 = sc[j][2 + e] * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            if (kpos >= Skv) {
              x0 = -INFINITY;  // past the ragged edge: weighs exactly 0
              x1 = -INFINITY;
            } else if (causal) {
              if (kpos > qpos0) x0 = hopper::kNegInf;
              if (kpos > qpos1) x1 = hopper::kNegInf;
            }
          }
          sc[j][e] = x0;
          sc[j][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, hopper::quad_max(mx0));
      const float mn1 = fmaxf(m1, hopper::quad_max(mx1));
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[j][e] = exp2f(sc[j][e] - mn0);
          sc[j][2 + e] = exp2f(sc[j][2 + e] - mn1);
          rs0 += sc[j][e];
          rs1 += sc[j][2 + e];
        }
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= c0;
        acc[i][1] *= c0;
        acc[i][2] *= c1;
        acc[i][3] *= c1;
      }
      accumulate_rows<HD, kBK / 8>(acc, sc, Vs + s * kTile, g, t);
    }
    __syncthreads();   // every warp is done with stage s
    if (n + kStages < n_tiles) load_kv(n + kStages);
    cp_commit();
  }
  cp_wait<0>();

  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  if (lse != nullptr && t == 0) {
    // m is in the log2 domain of the scaled scores
    float* lrow = lse + ((long long)b * Hq + h) * Sq;
    if (qpos0 < Sq) lrow[qpos0] = (m0 + log2f(l0)) * hopper::kLn2;
    if (qpos1 < Sq) lrow[qpos1] = (m1 + log2f(l1)) * hopper::kLn2;
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  float* o0 = o + (((long long)b * Sq + qpos0) * Hq + h) * HD + 2 * t;
  float* o1 = o0 + 8LL * Hq * HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    if (qpos0 < Sq)
      *reinterpret_cast<float2*>(o0 + 8 * i) =
          make_float2(acc[i][0] / den0, acc[i][1] / den0);
    if (qpos1 < Sq)
      *reinterpret_cast<float2*>(o1 + 8 * i) =
          make_float2(acc[i][2] / den1, acc[i][3] / den1);
  }
}

template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                const Strides& st, int causal, float scale,
                cudaStream_t stream) {
  constexpr int kRows = kTf32Warps<HD> * 16;
  const int smem =
      (int)sizeof(float) * (kRows + 2 * kStages * kBK) * (HD + 4);
  auto kern = flash_fwd_tf32<HD>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int vec = vec_ok({q, k, v}, st);
  dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  kern<<<grid, kTf32Warps<HD> * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv,
      Hq, Hq / Hkv, st, causal, scale * hopper::kLog2e, vec);
  return (int)cudaGetLastError();
}

// bf16 goes to the wgmma kernel, float32 to the split-TF32 one
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
             const Strides& st, int causal, float scale,
             cudaStream_t stream) {
  constexpr bool wgmma = std::is_same<T, __nv_bfloat16>::value;
#define FLASH_CASE(HD)                                                       \
  case HD:                                                                   \
    if constexpr (wgmma)                                                     \
      return hopper::launch<HD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, st,    \
                                causal, scale, stream);                      \
    else                                                                     \
      return launch_tf32<HD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, st,       \
                             causal, scale, stream);
  switch (hd) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// q, k, v through their (batch, row, head) strides, head axis contiguous;
// o (B, Sq, Hq, hd) contiguous; lse (B, Hq, Sq) f32 contiguous, or null.
#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* k, const void* v, void* o, float* lse, \
           int B, int Sq, int Skv, int Hq, int Hkv, int hd, long long qsb,    \
           long long qss, long long qsh, long long ksb, long long kss,        \
           long long ksh, long long vsb, long long vss, long long vsh,        \
           int causal, float scale, cudaStream_t stream) {                    \
    const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};            \
    return dispatch<T>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, hd, st, causal,  \
                       scale, stream);                                        \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
