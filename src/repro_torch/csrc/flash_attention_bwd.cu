// Blocked GQA softmax attention (backward), by hand for Hopper (sm_90a).
//
// The gradient of csrc/flash_attention.cu's forward, from q, k, v, the
// forward's output o, its per-row logsumexp lse (B, Hq, Sq) and the output's
// cotangent dO.  For query row i of head h (kv head h / G) and kv row j:
//   D_i   = sum_d dO_id o_id                      (f32)
//   P_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * scale, 0 where the
//           forward masks (j > i under the causal mask, j past Skv)
//   dV_j  = sum_{h in group, i} P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_{h in group, i} dS_ij q_i
// with the results written in the operands' dtype.  Each route is two
// kernels launched in this order on one stream: a dQ kernel, a block per
// query tile of one query head, which also writes D and lse log2 e of its
// rows (a 512-byte block per 64-row query tile of a (B, Hq, ceil(Sq / 64),
// 2, 64) f32 scratch) for the next kernel, then a dK / dV kernel, a block
// per kv tile of one kv head, which loops over the query tiles of every
// query head of its group that the mask reaches: the GQA sum is a loop in
// one block, not a sum across blocks.  Each sum runs in a fixed order and
// nothing is added atomically, so two calls give the same bits.
//
// What bounds it: operations, five products of 2 HD flops per (query, key)
// pair the mask keeps (S, dP, dV, dQ, dK), 2.5 times the forward's two.
// Both routes run every product on the tensor cores and form S and dP in
// both kernels: seven products against the bound's five.
//
// flash_bwd_dq_tf32 and flash_bwd_dkdv_tf32 (float32, head width 32, 64 or
// 128: every reduced config, any f32 training) multiply on the TF32 tensor
// cores by mma.sync m16n8k8, every product split in three (tf32.cuh: x =
// hi + lo, each a TF32 value truncated from x, and a b = a_hi b_hi + a_hi
// b_lo + a_lo b_hi): truncated TF32 products alone move the gradients 38 to
// 276 times past the f32 gate (1e-5 max + 1e-4 |ref|), the split form
// stays within 0.16 of it (tests/test_torch_flash_backward.py).  mma.sync
// and not TF32 wgmma: wgmma reads a TF32 operand from shared memory K-major
// only, so dQ = dS K, dV = P^T dO and dK = dS^T Q would need K, dO and Q
// transposed in shared memory, and P and dS leave the accumulator in a
// layout that is not the TF32 A fragment's; mma.sync reads its fragments
// from any layout.  Each warp owns 16 rows and a part of the other side's
// tile: their S and dP stay in registers as accumulator fragments, and the
// second products take them as A fragments as they lie, because the sum
// over the score tile's columns runs in a permuted order (k slot q of an
// 8-column step is column 2 q, slot q + 4 column 2 q + 1), which the B
// operand's rows follow.  Shared tiles are f32 rows of HD + 4 floats (4 mod
// 32): the fragment reads of both orders (rows g, columns q; rows 2 q and
// 2 q + 1, columns g) reach 32 banks for 32 lanes, and rows stay 16-byte
// aligned for cp.async (load_rows, dot_rows and accumulate_rows, shared
// with the forward's f32 route, are in tf32.cuh).  Tiles arrive by cp.async
// in a ring of two stages, 16 bytes a copy where every operand's base and
// strides are 16-byte multiples, else 4 bytes a copy: the route takes any
// strided f32 view that the wrapper admits, so nothing is kept for another
// route.  The dQ kernel
// has 8 warps over 64 query rows, each 16 rows x one 32-column half of
// every 64-row K / V tile, the halves' dQ added in a fixed order at the
// end; the dK / dV kernel has 4 warps over 32 kv rows, each 16 rows x one
// half of every 64-row Q / dO tile, likewise.  So the ragged (1, 1000, 4,
// 2, 32) shape has 64 blocks of each kernel (a block per 128 rows would
// leave 32 and 16 of 132 SMs busy).  At head width 128 the f32 tiles hold
// one block on an SM (198 KB and 166 KB of shared memory).
//
// flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma (bf16, head width 32, 64 or
// 128: every full-size config) run every product on the tensor cores: wgmma
// on swizzled tiles (128-byte; 64-byte at head width 32, whose rows are 64
// bytes) that TMA loads through the (B, S, H, hd) strides (the pieces shared
// with the forward are in hopper.cuh).  TMA needs a 16-byte aligned base and
// batch, row and head strides that are 16-byte multiples, so a bf16 q, k or
// v view that misses them is refused at every head width, before the
// forward launches (the forward's bf16 kernel reads them by TMA too; no
// configuration makes one).  A block has two consumer warpgroups of 64
// rows each over a 128-row tile; one thread also
// keeps a ring of three 64-row stages of the other side filled (in the dK /
// dV kernel with each query tile's lse and D too, by bulk copy).  Letting
// the two warpgroups take turns to issue, as the forward's do, measured no
// faster on the H100 (PERF.md).  S and dP (S^T and dP^T in the dK / dV
// kernel) are SS wgmma, both operands K-major, in two commit groups, so P's
// exponentials run while dP is on the tensor cores.  P and dS then lie in
// the accumulator registers, whose layout is
// a wgmma A fragment, so dQ += dS K, dV += P^T dO and dK += dS^T Q are wgmma
// with A from registers and K, dO, Q as MN-major operands, as the forward's
// P V.  As the forward splits P, P and dS are split, hi = bf16(x) and lo =
// bf16(x - hi), and both halves multiplied (about 16 bits): bf16 alone would
// move gradients near 0 by about 2^-9 of their scale, far outside the bf16
// gate (1e-5 max + 2^-7 per element).  S and dP, of bf16 operands, are
// exact products with f32 sums.  So S and dP are formed in both kernels and
// every product of P or dS runs twice: ten bf16 products against the
// bound's five.  Tiles wholly above a warpgroup's diagonal are skipped,
// masks run only on tiles that reach the diagonal or a ragged edge, and TMA
// zero-fills rows past the end.  Registers: a block has 256 threads, so
// ptxas may give each 255 (at 384, with a producer warpgroup as in the
// forward, the cap would be 168); the dK / dV kernel's peak is dK and dV
// (HD / 2 each) beside S^T and dP^T (32 + 32) or their split halves (16 x 4).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBR = 64;         // rows of a Q / dO or K / V tile, of a dQ block
constexpr int kStages = 2;      // tiles of the other side in flight
constexpr int kStat = 2 * kBR;  // floats of a query tile's lse log2 e and D

// The f32 route's tiling: a dQ block is 8 warps over 64 query rows (4 row
// groups of 16 x two 32-column halves of each 64-row K / V tile), a dK / dV
// block 4 warps over kKvRows kv rows (2 row groups x two halves of each
// 64-row Q / dO tile).  Each warp's S and dP are 16 x 32, 16 accumulator
// floats each.
constexpr int kDqThreads = 256;
constexpr int kKvRows = 32;
constexpr int kKvThreads = 128;

// whether the forward let query row qpos see kv row kpos
__device__ __forceinline__ bool kept(int qpos, int kpos, int Sq, int Skv,
                                     int causal) {
  return qpos < Sq && kpos < Skv && !(causal && kpos > qpos);
}

// Where a query tile's row statistics lie in the scratch that each route's
// dQ kernel writes and its dK / dV kernel reads: for each (batch, query
// head) and 64-row query tile t, the rows' lse log2 e, then their D, 512
// contiguous bytes.
__device__ __forceinline__ long long stat_at(int b, int h, int Hq, int n_q64,
                                             int t) {
  return (((long long)b * Hq + h) * n_q64 + t) * kStat;
}

// One block per (64-row query tile, query head, batch), longest first: 8
// warps, a warp 16 query rows x one 32-column half of each K / V tile.  D_i = dO_i . o_i and lse_i log2 e come first, into registers and
// the statistics scratch; then for every 64-row kv tile the mask reaches,
// with K and V in a ring of two stages:
//   S = Q K^T, dP = dO V^T, P = exp2(S scale log2 e - lse log2 e) (0 where
//   the forward masked), dS = P (dP - D), dQ += dS K
// and the halves' dQ, added in order, times scale is written once.
template <int HD>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ stats,
                  float* __restrict__ dq, int Sq, int Skv, int Hq, int G,
                  Strides st, int causal, float scale, float scale_log2,
                  int vec) {
  constexpr int NT = kDqThreads;
  constexpr int LD = HD + 4;
  constexpr int kTile = kBR * LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // kBR x LD
  float* dOs = Qs + kTile;             // kBR x LD
  float* Ks = dOs + kTile;             // kStages x kBR x LD
  float* Vs = Ks + kStages * kTile;    // kStages x kBR x LD

  const int n_q = (Sq + kBR - 1) / kBR;
  const int qt = n_q - 1 - (int)blockIdx.x;   // longest first
  const int q0 = qt * kBR;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.ksb + (h / G) * st.ksh;
  const float* vb = v + b * st.vsb + (h / G) * st.vsh;
  const long long rowO = (long long)Hq * HD;          // o, dO, dq contiguous
  const long long ob = (long long)b * Sq * rowO + (long long)h * HD;
  const int q_last = min(q0 + kBR, Sq) - 1;
  const int n_k = (Skv + kBR - 1) / kBR;
  const int n_tiles = causal ? min(n_k, q_last / kBR + 1) : n_k;

  auto load_kv = [&](int n) {
    const int s = n % kStages;
    load_rows<HD, kBR, NT>(Ks + s * kTile, kb, st.kss, n * kBR, Skv, vec);
    load_rows<HD, kBR, NT>(Vs + s * kTile, vb, st.vss, n * kBR, Skv, vec);
  };
  load_rows<HD, kBR, NT>(Qs, q + b * st.qsb + h * st.qsh, st.qss, q0, Sq,
                         vec);
  load_rows<HD, kBR, NT>(dOs, dout + ob, rowO, q0, Sq, vec);
  load_kv(0);
  cp_commit();
  if (n_tiles > 1) load_kv(1);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;   // row group, kv half
  const int r0 = 16 * rg + g;                  // rows r0 and r0 + 8
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  // D and lse log2 e of the two rows, over the 4 threads that share them;
  // rows past Sq get 0 and 0 (the dK / dV kernel masks them)
  float d0 = 0.0f, d1 = 0.0f;
#pragma unroll 4
  for (int c = t; c < HD; c += 4) {
    const long long at0 = ob + qpos0 * rowO + c, at1 = at0 + 8 * rowO;
    if (qpos0 < Sq) d0 += dout[at0] * o[at0];
    if (qpos1 < Sq) d1 += dout[at1] * o[at1];
  }
  d0 = hopper::quad_sum(d0);
  d1 = hopper::quad_sum(d1);
  const float* lrow = lse + ((long long)b * Hq + h) * Sq;
  const float l0 = qpos0 < Sq ? lrow[qpos0] * hopper::kLog2e : 0.0f;
  const float l1 = qpos1 < Sq ? lrow[qpos1] * hopper::kLog2e : 0.0f;
  if (half == 0 && t == 0) {
    float* sb = stats + stat_at(b, h, Hq, n_q, qt);
    sb[r0] = l0;
    sb[r0 + 8] = l1;
    sb[kBR + r0] = d0;
    sb[kBR + r0 + 8] = d1;
  }

  float acc[HD / 8][4];
  zero_frags(acc);
  const int q0w = q0 + 16 * rg;
  for (int n = 0; n < n_tiles; ++n) {
    cp_wait<1>();      // tile n has landed (this thread's copies) ...
    __syncthreads();   // ... and every thread's
    const int s = n % kStages;
    const int kc0 = n * kBR + 32 * half;   // the half's first kv column
    // a half wholly past Sq or Skv, or wholly above its diagonal, adds 0
    if (q0w < Sq && kc0 < Skv && !(causal && kc0 > q0w + 15)) {
      const float* Kt = Ks + s * kTile + 32 * half * LD;
      float sc[4][4], dp[4][4];   // S, then P; dP, then dS
      dot_rows<HD, 4>(sc, Qs + 16 * rg * LD, Kt, g, t);
      dot_rows<HD, 4>(dp, dOs + 16 * rg * LD, Vs + s * kTile + 32 * half * LD,
                      g, t);
      const bool masked = kc0 + 32 > Skv || q0w + 16 > Sq ||
                          (causal && kc0 + 31 > q0w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(sc[j][e] * scale_log2 - l0);
          float p1 = exp2f(sc[j][2 + e] * scale_log2 - l1);
          if (masked) {
            const int kpos = kc0 + 8 * j + 2 * t + e;
            if (!kept(qpos0, kpos, Sq, Skv, causal)) p0 = 0.0f;
            if (!kept(qpos1, kpos, Sq, Skv, causal)) p1 = 0.0f;
          }
          dp[j][e] = p0 * (dp[j][e] - d0);
          dp[j][2 + e] = p1 * (dp[j][2 + e] - d1);
        }
      }
      accumulate_rows<HD, 4>(acc, dp, Kt, g, t);
    }
    __syncthreads();   // every warp is done with stage s
    if (n + kStages < n_tiles) load_kv(n + kStages);
    cp_commit();
  }

  // the second half's sums onto the first's, through the K ring (free: the
  // loop's last copies have landed and been read): value x of thread (rg,
  // lane) at red[x 128 + slot]
  cp_wait<0>();
  float* red = Ks;
  const int slot = 32 * rg + lane;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * i + e) * 128 + slot] = acc[i][e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += red[(4 * i + e) * 128 + slot];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const long long col = ob + 8 * i + 2 * t;
    if (qpos0 < Sq)
      *reinterpret_cast<float2*>(dq + qpos0 * rowO + col) =
          make_float2(acc[i][0] * scale, acc[i][1] * scale);
    if (qpos1 < Sq)
      *reinterpret_cast<float2*>(dq + qpos1 * rowO + col) =
          make_float2(acc[i][2] * scale, acc[i][3] * scale);
  }
}

// One block per (kKvRows kv rows, kv head, batch), the kv tiles that the
// most query tiles reach first: 4 warps, a warp 16 kv rows x one half (32
// rows) of each 64-row Q / dO tile.  For every query head of the GQA group
// and every query tile the mask reaches, in that order (no atomics: the
// group's sum is this loop), with the tile's Q, dO and row statistics in a
// ring of two stages:
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T scale log2 e - lse log2 e)
//   (0 where the forward masked), dS^T = P^T (dP^T - D),
//   dV += P^T dO, dK += dS^T Q
// and the two halves' sums, added in order, are written once (dK times
// scale).
template <int HD>
__global__ void __launch_bounds__(kKvThreads)
flash_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ stats, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Skv, int Hq, int G,
                    Strides st, int causal, float scale, float scale_log2,
                    int vec) {
  constexpr int NT = kKvThreads;
  constexpr int RG = kKvRows / 16;       // row groups
  constexpr int LD = HD + 4;
  constexpr int kTile = kBR * LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // kKvRows x LD, this block's kv rows
  float* Vs = Ks + kKvRows * LD;         // kKvRows x LD
  float* Qs = Vs + kKvRows * LD;         // kStages x kBR x LD
  float* dOs = Qs + kStages * kTile;     // kStages x kBR x LD
  float* Ss = dOs + kStages * kTile;     // kStages x kStat

  const int k0 = blockIdx.x * kKvRows;   // causal: the most query tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long rowO = (long long)Hq * HD;
  const int n_q = (Sq + kBR - 1) / kBR;
  const int qt_begin = causal ? k0 / kBR : 0;
  const int per_head = max(0, n_q - qt_begin);
  const int n_iter = G * per_head;

  auto load_q = [&](int n) {
    const int s = n % kStages;
    const int h = hk * G + n / per_head, qt = qt_begin + n % per_head;
    load_rows<HD, kBR, NT>(Qs + s * kTile, q + b * st.qsb + h * st.qsh,
                           st.qss, qt * kBR, Sq, vec);
    load_rows<HD, kBR, NT>(dOs + s * kTile,
                           dout + (long long)b * Sq * rowO + (long long)h * HD,
                           rowO, qt * kBR, Sq, vec);
    // the tile's lse log2 e and D: 512 bytes of the scratch, 16-byte aligned
    if (threadIdx.x < kStat / 4)
      cp_async16(Ss + s * kStat + 4 * threadIdx.x,
                 stats + stat_at(b, h, Hq, n_q, qt) + 4 * threadIdx.x);
  };
  load_rows<HD, kKvRows, NT>(Ks, k + b * st.ksb + hk * st.ksh, st.kss, k0,
                             Skv, vec);
  load_rows<HD, kKvRows, NT>(Vs, v + b * st.vsb + hk * st.vsh, st.vss, k0,
                             Skv, vec);
  if (n_iter > 0) load_q(0);
  cp_commit();
  if (n_iter > 1) load_q(1);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % RG, half = warp / RG;   // row group, query half
  const int k0w = k0 + 16 * rw;
  const int kpos0 = k0w + g, kpos1 = kpos0 + 8;
  float dka[HD / 8][4], dva[HD / 8][4];
  zero_frags(dka);
  zero_frags(dva);

  for (int n = 0; n < n_iter; ++n) {
    cp_wait<1>();
    __syncthreads();
    const int s = n % kStages;
    // this warp's 32 query columns of the tile
    const int qc0 = (qt_begin + n % per_head) * kBR + 32 * half;
    // a warp wholly past Skv or Sq, or wholly above its diagonal, adds 0
    if (k0w < Skv && qc0 < Sq && !(causal && k0w > qc0 + 31)) {
      const float* Qt = Qs + s * kTile + 32 * half * LD;
      const float* dOt = dOs + s * kTile + 32 * half * LD;
      const float* lse2 = Ss + s * kStat + 32 * half;
      const float* Dr = lse2 + kBR;
      float sc[4][4], dp[4][4];   // S^T, then P^T; dP^T, then dS^T
      dot_rows<HD, 4>(sc, Ks + 16 * rw * LD, Qt, g, t);
      dot_rows<HD, 4>(dp, Vs + 16 * rw * LD, dOt, g, t);
      const bool masked =
          qc0 + 32 > Sq || k0w + 16 > Skv || (causal && k0w + 15 > qc0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float l = lse2[c], d = Dr[c];
          float p0 = exp2f(sc[j][e] * scale_log2 - l);
          float p1 = exp2f(sc[j][2 + e] * scale_log2 - l);
          if (masked) {
            if (!kept(qc0 + c, kpos0, Sq, Skv, causal)) p0 = 0.0f;
            if (!kept(qc0 + c, kpos1, Sq, Skv, causal)) p1 = 0.0f;
          }
          sc[j][e] = p0;
          sc[j][2 + e] = p1;
          dp[j][e] = p0 * (dp[j][e] - d);
          dp[j][2 + e] = p1 * (dp[j][2 + e] - d);
        }
      }
      accumulate_rows<HD, 4>(dva, sc, dOt, g, t);
      accumulate_rows<HD, 4>(dka, dp, Qt, g, t);
    }
    __syncthreads();
    if (n + kStages < n_iter) load_q(n + kStages);
    cp_commit();
  }

  // the second half's sums onto the first's, through the Q ring (free: the
  // loop's last copies have landed and been read): value x of thread (rw,
  // lane) at red[x kKvRows 2 + slot]
  cp_wait<0>();
  float* red = Qs;
  const int slot = 32 * rw + lane;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(4 * i + e) * 2 * kKvRows + slot] = dka[i][e];
        red[(HD / 2 + 4 * i + e) * 2 * kKvRows + slot] = dva[i][e];
      }
  }
  __syncthreads();
  if (half == 1) return;
  const long long rowKV = (long long)(Hq / G) * HD;   // dk, dv contiguous
  const long long at0 =
      ((long long)b * Skv + kpos0) * rowKV + (long long)hk * HD + 2 * t;
  const long long at1 = at0 + 8 * rowKV;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    float kx[4], vx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kx[e] = (dka[i][e] + red[(4 * i + e) * 2 * kKvRows + slot]) * scale;
      vx[e] = dva[i][e] + red[(HD / 2 + 4 * i + e) * 2 * kKvRows + slot];
    }
    if (kpos0 < Skv) {
      *reinterpret_cast<float2*>(dk + at0 + 8 * i) = make_float2(kx[0], kx[1]);
      *reinterpret_cast<float2*>(dv + at0 + 8 * i) = make_float2(vx[0], vx[1]);
    }
    if (kpos1 < Skv) {
      *reinterpret_cast<float2*>(dk + at1 + 8 * i) = make_float2(kx[2], kx[3]);
      *reinterpret_cast<float2*>(dv + at1 + 8 * i) = make_float2(vx[2], vx[3]);
    }
  }
}

// stats: the (B, Hq, ceil(Sq / 64), 2, 64) f32 scratch that the first
// kernel writes and the second reads
template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* stats, void* dq,
                void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                const Strides& st, int causal, float scale,
                cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem_dq = (int)sizeof(float) * (2 + 2 * kStages) * kBR * LD;
  const int smem_kv = (int)sizeof(float) *
                      ((2 * kKvRows + 2 * kStages * kBR) * LD +
                       kStages * kStat);
  auto kdq = flash_bwd_dq_tf32<HD>;
  auto kkv = flash_bwd_dkdv_tf32<HD>;
  cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_dq);
  cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_kv);
  const int G = Hq / Hkv;
  const float scale_log2 = scale * hopper::kLog2e;
  const int vec = vec_ok({q, k, v, o, dout}, st);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  kdq<<<dim3((Sq + kBR - 1) / kBR, Hq, B), kDqThreads, smem_dq, stream>>>(
      fq, fk, fv, static_cast<const float*>(o), fdo, lse, stats,
      static_cast<float*>(dq), Sq, Skv, Hq, G, st, causal, scale, scale_log2,
      vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((Skv + kKvRows - 1) / kKvRows, Hkv, B), kKvThreads, smem_kv,
        stream>>>(
      fq, fk, fv, fdo, stats, static_cast<float*>(dk), static_cast<float*>(dv),
      Sq, Skv, Hq, G, st, causal, scale, scale_log2, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma: bf16 on the tensor cores, head
// width 32, 64 or 128
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kStagesDq = 3;    // K / V tiles in flight (dQ kernel)
constexpr int kStagesKv = 3;    // Q / dO tiles in flight (dK / dV kernel)
constexpr int kThreads = 256;   // 2 consumer warpgroups
constexpr int kLoader = 128;    // the thread that also loads, in warpgroup
                                // 1: it runs every tile of the dQ kernel
constexpr uint32_t kStatBytes = 2 * kBN * 4;  // lse log2 e and D, 64 rows

template <int HD>
struct BwdTiles {
  static constexpr uint32_t kWide = kBM * 2 * HD;     // bytes of 128 rows
  static constexpr uint32_t kNarrow = kBN * 2 * HD;   // ... of 64 rows
  static constexpr int kBlocks = HD >= 64 ? HD / 64 : 1;   // column blocks
  static constexpr uint32_t kRow = row_bytes<HD>();  // a row of one block
  // two wide tiles, a ring of stages of two narrow tiles (and in the dK /
  // dV kernel a statistics block), 1 + 2 x stages mbarriers, alignment
  // slack
  static constexpr uint32_t kSmemDq =
      1024 + 2 * kWide + kStagesDq * 2 * kNarrow + 8 * (1 + 2 * kStagesDq);
  static constexpr uint32_t kSmemKv = 1024 + 2 * kWide +
                                      kStagesKv * (2 * kNarrow + kStatBytes) +
                                      8 * (1 + 2 * kStagesKv);
};

// `bytes` contiguous bytes from device memory by the bulk-copy engine,
// completing on `bar` as the TMA tiles do
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// One block per (query head, batch, 128-row query tile), longest first: two
// warpgroups of 64 query rows each.  D_i = dO_i . o_i and lse_i come first,
// into registers and into the statistics scratch; then for every 64-row kv
// tile the mask reaches:
//   S = Q K^T, dP = dO V^T  (SS wgmma, K-major)
//   P = exp2(S scale log2 e - lse log2 e), 0 where the forward masked
//   dS = P (dP - D)
//   dQ += dS_hi K + dS_lo K  (dS from registers, K MN-major)
// and dQ scale is written once.  S and dP are two groups, so P's
// exponentials run while dP is on the tensor cores.  Under the causal mask
// warpgroup 0's last tile may lie wholly above its diagonal: it skips it.
// kLoader refills a stage once both warpgroups are done with it.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stats,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                   int G, int causal, float scale, float scale_log2) {
  using Tl = BwdTiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + Tl::kWide;
  const uint32_t sK = sdO + Tl::kWide;
  const uint32_t sV = sK + kStagesDq * Tl::kNarrow;
  const uint32_t q_full = sV + kStagesDq * Tl::kNarrow;
  const uint32_t full = q_full + 8, empty = full + 8 * kStagesDq;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int n_q = (Sq + kBM - 1) / kBM;
  const int q0 = (n_q - 1 - (int)blockIdx.z) * kBM;
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int n_k = (Skv + kBN - 1) / kBN;
  const int n_tiles = causal ? min(n_k, q_last / kBN + 1) : n_k;
  const int tid = threadIdx.x;

  auto load_kv = [&](int n) {
    const int s = n % kStagesDq;
    mbar_expect_tx(full + 8 * s, 2 * Tl::kNarrow);
#pragma unroll
    for (int c = 0; c < Tl::kBlocks; ++c) {
      tma_load(sK + s * Tl::kNarrow + c * kColBlock, &tk, full + 8 * s,
               64 * c, n * kBN, hk, b);
      tma_load(sV + s * Tl::kNarrow + c * kColBlock, &tv, full + 8 * s,
               64 * c, n * kBN, hk, b);
    }
  };
  if (tid == kLoader) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesDq; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == kLoader) {
    mbar_expect_tx(q_full, 2 * Tl::kWide);
#pragma unroll
    for (int c = 0; c < Tl::kBlocks; ++c) {
      tma_load(sQ + c * kQColBlock, &tq, q_full, 64 * c, q0, h, b);
      tma_load(sdO + c * kQColBlock, &tdo, q_full, 64 * c, q0, h, b);
    }
    for (int n = 0; n < min(kStagesDq, n_tiles); ++n) load_kv(n);
  }
  __syncwarp();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  const int q0w = q0 + wg * 64;
  // this thread's two rows (accumulator layout of wgmma m64nNk16)
  const int qpos0 = q0w + warp * 16 + (lane >> 2), qpos1 = qpos0 + 8;

  // D and lse log2 e of the two rows, D in f32 from the bf16 o and dO:
  // each of the 4 threads of a row reads a quarter of it, 16 bytes a load
  const long long rowO = (long long)Hq * HD;
  const long long col = (long long)h * HD + 2 * quad;
  const long long at0 = ((long long)b * Sq + qpos0) * rowO + col;
  const long long at1 = at0 + 8 * rowO;
  float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r ? qpos1 : qpos0;
    if (qpos >= Sq) continue;
    const long long at = ((long long)b * Sq + qpos) * rowO +
                         (long long)h * HD + quad * (HD / 4);
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < HD / 4; c += 8) {
      const uint4 xo = *reinterpret_cast<const uint4*>(o + at + c);
      const uint4 xg = *reinterpret_cast<const uint4*>(dout + at + c);
      const uint32_t wo[4] = {xo.x, xo.y, xo.z, xo.w};
      const uint32_t wg4[4] = {xg.x, xg.y, xg.z, xg.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wo[i]));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wg4[i]));
        d += x.x * g.x + x.y * g.y;
      }
    }
    (r ? d1 : d0) = d;
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  const float* lrow = lse + ((long long)b * Hq + h) * Sq;
  const float l0 = qpos0 < Sq ? lrow[qpos0] * kLog2e : 0.0f;
  const float l1 = qpos1 < Sq ? lrow[qpos1] * kLog2e : 0.0f;
  if (quad == 0 && q0w < Sq) {
    // rows past Sq in a live tile get 0 and 0; the dK / dV kernel masks them
    float* st = stats + stat_at(b, h, Hq, (Sq + kBN - 1) / kBN, q0w / kBN);
    const int i0 = qpos0 - q0w;
    st[i0] = l0;
    st[i0 + 8] = l1;
    st[kBN + i0] = d0;
    st[kBN + i0 + 8] = d1;
  }

  float acc[HD / 2];
  zero(acc);
  float sc[kBN / 2], dp[kBN / 2];   // S, then P; dP, then dS
  uint32_t hi[kBN / 4], lo[kBN / 4];
  const uint32_t sQw = sQ + wg * 64 * Tl::kRow;
  const uint32_t sdOw = sdO + wg * 64 * Tl::kRow;
  // this warpgroup's tiles: those its rows see (none wholly past Sq)
  const int n_w = q0w >= Sq ? 0
                  : causal ? min(n_k, min(q0w + 63, Sq - 1) / kBN + 1)
                           : n_k;
  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStagesDq, k0 = n * kBN;
    const uint32_t sKs = sK + s * Tl::kNarrow;
    mbar_wait(full + 8 * s, (n / kStagesDq) & 1);
    if (n < n_w) {
      zero(sc);   // the first k16 step overwrites them: no live range
      zero(dp);
      wgmma_fence();
      issue_qk<HD>(sc, sQw, sKs);
      wgmma_commit();
      issue_qk<HD>(dp, sdOw, sV + s * Tl::kNarrow);
      wgmma_commit();
      // P's exponentials while dP is on the tensor cores
      wgmma_wait<1>();
      fence_regs(sc);
      const bool masked =
          k0 + kBN > Skv || q0w + 64 > Sq || (causal && k0 + kBN - 1 > q0w);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(sc[4 * j + e] * scale_log2 - l0);
          float p1 = exp2f(sc[4 * j + 2 + e] * scale_log2 - l1);
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * quad + e;
            if (!kept(qpos0, kpos, Sq, Skv, causal)) p0 = 0.0f;
            if (!kept(qpos1, kpos, Sq, Skv, causal)) p1 = 0.0f;
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - d0);
          dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d1);
        }
      }
      split_all(dp, hi, lo);
      wgmma_fence();
      issue_pv(acc, hi, lo, sKs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
    }
    mbar_arrive(empty + 8 * s);
    if (tid == kLoader && n + kStagesDq < n_tiles) {
      mbar_wait(empty + 8 * s, (n / kStagesDq) & 1);
      load_kv(n + kStagesDq);
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (qpos0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + at0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (qpos1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + at1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

// One block per (kv head, batch, 128-row kv tile), the kv tiles that the
// most query tiles reach first: two warpgroups of 64 kv rows each, K and V
// loaded once.  For every query head of the GQA group and every 64-row query
// tile the mask reaches, in that order (no atomics: the group's sum is this
// loop), with the tile's Q, dO and row statistics in a ring of stages:
//   S^T = K Q^T, dP^T = V dO^T  (SS wgmma, K-major)
//   P^T = exp2(S^T scale log2 e - lse log2 e), 0 where the forward masked
//   dS^T = P^T (dP^T - D)
//   dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q  (from
//   registers, dO and Q MN-major)
// and dK scale and dV are written once.  S^T and dP^T are two groups, so
// P^T's exponentials run while dP^T is on the tensor cores, and dS^T is
// split while dV's products run.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq,
                     int G, int causal, float scale, float scale_log2) {
  using Tl = BwdTiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + Tl::kWide;
  const uint32_t sQ = sV + Tl::kWide;
  const uint32_t sdO = sQ + kStagesKv * Tl::kNarrow;
  const uint32_t sSt = sdO + kStagesKv * Tl::kNarrow;
  const uint32_t kv_full = sSt + kStagesKv * kStatBytes;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStagesKv;
  // the statistics ring, as the consumers read it
  const float* st_ring =
      reinterpret_cast<const float*>(smem_raw + (sSt - base));

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBM;
  const int n_q64 = (Sq + kBN - 1) / kBN;
  const int qt_begin = causal ? k0 / kBN : 0;
  const int per_head = max(0, n_q64 - qt_begin);
  const int n_iter = G * per_head;
  const int tid = threadIdx.x;

  auto load_q = [&](int n) {
    const int s = n % kStagesKv;
    const int h = hk * G + n / per_head, qt = qt_begin + n % per_head;
    mbar_expect_tx(full + 8 * s, 2 * Tl::kNarrow + kStatBytes);
#pragma unroll
    for (int c = 0; c < Tl::kBlocks; ++c) {
      tma_load(sQ + s * Tl::kNarrow + c * kColBlock, &tq, full + 8 * s,
               64 * c, qt * kBN, h, b);
      tma_load(sdO + s * Tl::kNarrow + c * kColBlock, &tdo, full + 8 * s,
               64 * c, qt * kBN, h, b);
    }
    bulk_load(sSt + s * kStatBytes, stats + stat_at(b, h, Hq, n_q64, qt),
              kStatBytes, full + 8 * s);
  };
  if (tid == kLoader) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesKv; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == kLoader) {
    mbar_expect_tx(kv_full, 2 * Tl::kWide);
#pragma unroll
    for (int c = 0; c < Tl::kBlocks; ++c) {
      tma_load(sK + c * kQColBlock, &tk, kv_full, 64 * c, k0, hk, b);
      tma_load(sV + c * kQColBlock, &tv, kv_full, 64 * c, k0, hk, b);
    }
    for (int n = 0; n < min(kStagesKv, n_iter); ++n) load_q(n);
  }
  __syncwarp();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  const int k0w = k0 + wg * 64;
  // this thread's two kv rows (accumulator layout of wgmma m64nNk16)
  const int kpos0 = k0w + warp * 16 + (lane >> 2), kpos1 = kpos0 + 8;
  const uint32_t sKw = sK + wg * 64 * Tl::kRow;
  const uint32_t sVw = sV + wg * 64 * Tl::kRow;

  float dka[HD / 2], dva[HD / 2];
  zero(dka);
  zero(dva);
  float sc[kBN / 2], dp[kBN / 2];   // S^T, then P^T; dP^T, then dS^T
  uint32_t phi[kBN / 4], plo[kBN / 4], shi[kBN / 4], slo[kBN / 4];
  mbar_wait(kv_full, 0);
  for (int n = 0; n < n_iter; ++n) {
    const int s = n % kStagesKv;
    const int q0 = (qt_begin + n % per_head) * kBN;
    const uint32_t sQs = sQ + s * Tl::kNarrow;
    const uint32_t sdOs = sdO + s * Tl::kNarrow;
    mbar_wait(full + 8 * s, (n / kStagesKv) & 1);
    // a warpgroup wholly past Skv, or a tile wholly above its diagonal,
    // adds exactly 0
    if (k0w < Skv && !(causal && k0w > q0 + 63)) {
      zero(sc);   // the first k16 step overwrites them: no live range
      zero(dp);
      wgmma_fence();
      issue_qk<HD>(sc, sKw, sQs);
      wgmma_commit();
      issue_qk<HD>(dp, sVw, sdOs);
      wgmma_commit();
      const float* lse2 = st_ring + s * (kStatBytes / 4);
      const float* Dr = lse2 + kBN;
      const bool masked =
          q0 + kBN > Sq || k0w + 64 > Skv || (causal && k0w + 63 > q0);
      // P^T's exponentials while dP^T is on the tensor cores
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          const float l = lse2[c];
          float p0 = exp2f(sc[4 * j + e] * scale_log2 - l);
          float p1 = exp2f(sc[4 * j + 2 + e] * scale_log2 - l);
          if (masked) {
            if (!kept(q0 + c, kpos0, Sq, Skv, causal)) p0 = 0.0f;
            if (!kept(q0 + c, kpos1, Sq, Skv, causal)) p1 = 0.0f;
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = Dr[8 * j + 2 * quad + e];
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - d);
          dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
        }
      }
      // dS^T is split while dV's products run
      split_all(sc, phi, plo);
      wgmma_fence();
      issue_pv(dva, phi, plo, sdOs);
      wgmma_commit();
      split_all(dp, shi, slo);
      wgmma_fence();
      issue_pv(dka, shi, slo, sQs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(phi);
      fence_regs(plo);
      fence_regs(shi);
      fence_regs(slo);
    }
    mbar_arrive(empty + 8 * s);
    if (tid == kLoader && n + kStagesKv < n_iter) {
      mbar_wait(empty + 8 * s, (n / kStagesKv) & 1);
      load_q(n + kStagesKv);
    }
    __syncwarp();
  }

  const long long rowKV = (long long)(Hq / G) * HD;
  const long long at0 =
      ((long long)b * Skv + kpos0) * rowKV + (long long)hk * HD + 2 * quad;
  const long long at1 = at0 + 8 * rowKV;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (kpos0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at0 + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at0 + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
    }
    if (kpos1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at1 + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                dka[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at1 + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// stats: the (B, Hq, ceil(Sq / 64), 2, 64) f32 scratch that the first
// kernel writes and the second reads
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* stats, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           const Strides& st, int causal, float scale, cudaStream_t stream) {
  const long long rowO = (long long)Hq * HD;   // dout: contiguous
  // wide (128-row) and narrow (64-row) boxes of each operand
  CUtensorMap tq_w, tdo_w, tk_n, tv_n, tq_n, tdo_n, tk_w, tv_w;
  if (!tensor_map(&tq_w, q, HD, Sq, Hq, B, st.qss, st.qsh, st.qsb, kBM) ||
      !tensor_map(&tdo_w, dout, HD, Sq, Hq, B, rowO, HD, Sq * rowO, kBM) ||
      !tensor_map(&tk_n, k, HD, Skv, Hkv, B, st.kss, st.ksh, st.ksb, kBN) ||
      !tensor_map(&tv_n, v, HD, Skv, Hkv, B, st.vss, st.vsh, st.vsb, kBN) ||
      !tensor_map(&tq_n, q, HD, Sq, Hq, B, st.qss, st.qsh, st.qsb, kBN) ||
      !tensor_map(&tdo_n, dout, HD, Sq, Hq, B, rowO, HD, Sq * rowO, kBN) ||
      !tensor_map(&tk_w, k, HD, Skv, Hkv, B, st.kss, st.ksh, st.ksb, kBM) ||
      !tensor_map(&tv_w, v, HD, Skv, Hkv, B, st.vss, st.vsh, st.vsb, kBM))
    return (int)cudaErrorInvalidValue;
  const int smem_dq = (int)BwdTiles<HD>::kSmemDq;
  const int smem_kv = (int)BwdTiles<HD>::kSmemKv;
  auto kdq = flash_bwd_dq_wgmma<HD>;
  auto kkv = flash_bwd_dkdv_wgmma<HD>;
  cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_dq);
  cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_kv);
  const int G = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;
  kdq<<<dim3(Hq, B, (Sq + kBM - 1) / kBM), kThreads, smem_dq, stream>>>(
      tq_w, tdo_w, tk_n, tv_n, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats,
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, G, causal, scale,
      scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(Hkv, B, (Skv + kBM - 1) / kBM), kThreads, smem_kv, stream>>>(
      tq_n, tdo_n, tk_w, tv_w, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, Hq, G, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// bf16 goes to the wgmma kernels, float32 to the split-TF32 ones
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* stats, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
             int hd, const Strides& st, int causal, float scale,
             cudaStream_t stream) {
  constexpr bool wgmma = std::is_same<T, __nv_bfloat16>::value;
#define BWD_ARGS                                                             \
  q, k, v, o, dout, lse, stats, dq, dk, dv, B, Sq, Skv, Hq, Hkv, st, causal, \
      scale, stream
#define BWD_CASE(HD)                        \
  case HD:                                  \
    if constexpr (wgmma)                    \
      return hopper::launch<HD>(BWD_ARGS);  \
    else                                    \
      return launch_tf32<HD>(BWD_ARGS);
  switch (hd) {
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
#undef BWD_ARGS
}

}  // namespace

extern "C" {

// q, k, v through their (batch, row, head) strides, head axis contiguous;
// o, dout, dq (B, Sq, Hq, hd), dk, dv (B, Skv, Hkv, hd) contiguous; lse
// (B, Hq, Sq) f32 contiguous; stats a scratch the first kernel writes and
// the second reads, (B, Hq, ceil(Sq / 64), 2, 64) f32 on either route.
#define FLASH_BWD_ENTRY(NAME, T)                                              \
  int NAME(const void* q, const void* k, const void* v, const void* o,       \
           const void* dout, const float* lse, float* stats, void* dq,       \
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,      \
           int hd, long long qsb, long long qss, long long qsh,              \
           long long ksb, long long kss, long long ksh, long long vsb,       \
           long long vss, long long vsh, int causal, float scale,            \
           cudaStream_t stream) {                                            \
    const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};           \
    return dispatch<T>(q, k, v, o, dout, lse, stats, dq, dk, dv, B, Sq, Skv, \
                       Hq, Hkv, hd, st, causal, scale, stream);              \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
