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
// query tile of one query head, which also forms D for its rows (into a
// scratch for the next kernel), then a dK / dV kernel, a block per kv tile
// of one kv head, which loops over the query tiles of every query head of
// its group that the mask reaches: the GQA sum is a loop in one block, not
// a sum across blocks.  Each sum runs in a fixed order and nothing is added
// atomically, so two calls give the same bits.
//
// What bounds it: operations, five products of 2 HD flops per (query, key)
// pair the mask keeps (S, dP, dV, dQ, dK), 2.5 times the forward's two.
//
// flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma (bf16, head width 64 or 128:
// every full-size config) run every product on the tensor cores: wgmma on
// 128-byte swizzled tiles that TMA loads through the (B, S, H, hd) strides
// (the pieces shared with the forward are in hopper.cuh).  A block has two
// consumer warpgroups of 64 rows each over a 128-row tile; one thread also
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
//
// flash_bwd_dq and flash_bwd_dkdv (float32, and bf16 at head width 32) run
// the same schedule in f32 FMAs on the CUDA cores with 64-row tiles: each of
// the 256 threads holds 4 rows x 4 columns of a 64 x 64 score tile and 4
// rows x (HD / 16) columns of each accumulator; row statistics reduce over
// the 16 threads that share a row, and D goes to a (B, Hq, Sq) scratch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBR = 64;        // rows of a query or kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPLD = kBR + 1;  // padded row of a 64 x 64 score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// kBR rows x HD of a strided operand from row row0 -> dst (f32, row LD),
// zeros past n_rows
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kBR * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = row0 + r;
    dst[r * LD + d] = s < n_rows ? to_f32(src[(long long)s * row_stride + d])
                                 : 0.0f;
  }
}

// acc[i][j] = sum_d A[(ty * 4 + i) * LD + d] * B[(tx + 16 j) * LD + d]
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// acc[i][c] += sum_r P[(ty * 4 + i) * kPLD + r] * X[r * LD + tx + 16 c]
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[4][HD / 16],
                                           const float* __restrict__ P,
                                           const float* __restrict__ X, int ty,
                                           int tx) {
  constexpr int LD = HD + 1;
#pragma unroll 4
  for (int r = 0; r < kBR; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * kPLD + r];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float x = X[r * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * x;
    }
  }
}

// whether the forward let query row qpos see kv row kpos
__device__ __forceinline__ bool kept(int qpos, int kpos, int Sq, int Skv,
                                     int causal) {
  return qpos < Sq && kpos < Skv && !(causal && kpos > qpos);
}

struct Strides {
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ Dsum, T* __restrict__ dq, int Sq, int Skv,
             int Hq, int G, Strides st, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // kBR x LD
  float* dOs = Qs + kBR * LD;     // kBR x LD
  float* Ks = dOs + kBR * LD;     // kBR x LD
  float* Vs = Ks + kBR * LD;      // kBR x LD
  float* dSs = Vs + kBR * LD;     // kBR x kPLD
  float* lse_s = dSs + kBR * kPLD;
  float* D_s = lse_s + kBR;

  const int n_q = (Sq + kBR - 1) / kBR;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBR;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + (h / G) * st.ksh;
  const T* vb = v + b * st.vsb + (h / G) * st.vsh;
  const long long rowO = (long long)Hq * HD;          // o, dO, dq contiguous
  const long long ob = (long long)b * Sq * rowO + (long long)h * HD;
  const long long lb = ((long long)b * Hq + h) * Sq;

  load_tile<T, HD>(Qs, qb, st.qss, q0, Sq);
  load_tile<T, HD>(dOs, dout + ob, rowO, q0, Sq);
  // D_i = dO_i . o_i, over the 16 threads that share row i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    float part = 0.0f;
    if (s < Sq) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        part += to_f32(dout[ob + s * rowO + tx + 16 * c]) *
                to_f32(o[ob + s * rowO + tx + 16 * c]);
    }
    const float d = sum16(part);
    if (tx == 0) {
      D_s[r] = d;
      lse_s[r] = s < Sq ? lse[lb + s] : 0.0f;
      if (s < Sq) Dsum[lb + s] = d;
    }
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;

  const int q_last = min(q0 + kBR, Sq) - 1;
  const int n_k = (Skv + kBR - 1) / kBR;
  const int kt_end = causal ? min(n_k, q_last / kBR + 1) : n_k;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBR;
    __syncthreads();  // the previous tile's dS K is done with Ks and dSs
    load_tile<T, HD>(Ks, kb, st.kss, k0, Skv);
    load_tile<T, HD>(Vs, vb, st.vss, k0, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, Qs, Ks, ty, tx);
    dot_tile<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = kept(q0 + r, k0 + c, Sq, Skv, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.0f;
        dSs[r * kPLD + c] = p * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();
    accumulate<HD>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(dq + ob + s * rowO + tx + 16 * c, acc[i][c] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ Dsum,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq,
               int G, Strides st, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // kBR x LD, this block's kv rows
  float* Vs = Ks + kBR * LD;      // kBR x LD
  float* Qs = Vs + kBR * LD;      // kBR x LD, a query tile
  float* dOs = Qs + kBR * LD;     // kBR x LD
  float* Ps = dOs + kBR * LD;     // kBR x kPLD: P^T (kv rows x query cols)
  float* dSs = Ps + kBR * kPLD;   // kBR x kPLD: dS^T
  float* lse_s = dSs + kBR * kPLD;
  float* D_s = lse_s + kBR;

  const int k0 = blockIdx.x * kBR;   // causal: the most query tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = Hq / G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long rowO = (long long)Hq * HD;
  const long long rowKV = (long long)Hkv * HD;       // dk, dv contiguous

  load_tile<T, HD>(Ks, k + b * st.ksb + hk * st.ksh, st.kss, k0, Skv);
  load_tile<T, HD>(Vs, v + b * st.vsb + hk * st.vsh, st.vss, k0, Skv);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.0f;

  const int n_q = (Sq + kBR - 1) / kBR;
  const int qt_begin = causal ? k0 / kBR : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + b * st.qsb + h * st.qsh;
    const long long ob = (long long)b * Sq * rowO + (long long)h * HD;
    const long long lb = ((long long)b * Hq + h) * Sq;
    for (int qt = qt_begin; qt < n_q; ++qt) {
      const int q0 = qt * kBR;
      __syncthreads();  // the previous tile's sums are done with the tiles
      load_tile<T, HD>(Qs, qb, st.qss, q0, Sq);
      load_tile<T, HD>(dOs, dout + ob, rowO, q0, Sq);
      if (tid < kBR) {
        const int s = q0 + tid;
        lse_s[tid] = s < Sq ? lse[lb + s] : 0.0f;
        D_s[tid] = s < Sq ? Dsum[lb + s] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<HD>(s, Ks, Qs, ty, tx);     // S^T: kv rows x query columns
      dot_tile<HD>(dp, Vs, dOs, ty, tx);   // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = kept(q0 + c, k0 + r, Sq, Skv, causal)
                              ? expf(s[i][j] * scale - lse_s[c])
                              : 0.0f;
          Ps[r * kPLD + c] = p;
          dSs[r * kPLD + c] = p * (dp[i][j] - D_s[c]);
        }
      }
      __syncthreads();
      accumulate<HD>(dva, Ps, dOs, ty, tx);
      accumulate<HD>(dka, dSs, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= Skv) continue;
    const long long base = ((long long)b * Skv + s) * rowKV + hk * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(dk + base + tx + 16 * c, dka[i][c] * scale);
      store(dv + base + tx + 16 * c, dva[i][c]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* Dsum, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           const Strides& st, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * kBR * (HD + 1) + 2 * kBR * kPLD + 2 * kBR);
  auto kdq = flash_bwd_dq<T, HD>;
  auto kkv = flash_bwd_dkdv<T, HD>;
  cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int G = Hq / Hkv;
  kdq<<<dim3((Sq + kBR - 1) / kBR, Hq, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, Dsum, static_cast<T*>(dq), Sq, Skv,
      Hq, G, st, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((Skv + kBR - 1) / kBR, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, Dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, G, st, causal,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma: bf16 on the tensor cores, head
// width 64 or 128
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
  static constexpr uint32_t kWide = kQColBlock * (HD / 64);    // 128 rows
  static constexpr uint32_t kNarrow = kColBlock * (HD / 64);   // 64 rows
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

// Where the row statistics that flash_bwd_dkdv_wgmma reads by bulk copy
// lie: for each (batch, query head) and 64-row query tile t, the rows'
// lse log2 e, then their D, 512 contiguous bytes.
__device__ __forceinline__ long long stat_at(int b, int h, int Hq, int n_q64,
                                             int t) {
  return (((long long)b * Hq + h) * n_q64 + t) * (2 * kBN);
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
    for (int c = 0; c < HD / 64; ++c) {
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
    for (int c = 0; c < HD / 64; ++c) {
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
  const uint32_t sQw = sQ + wg * 64 * kRowBytes;
  const uint32_t sdOw = sdO + wg * 64 * kRowBytes;
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
    for (int c = 0; c < HD / 64; ++c) {
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
    for (int c = 0; c < HD / 64; ++c) {
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
  const uint32_t sKw = sK + wg * 64 * kRowBytes;
  const uint32_t sVw = sV + wg * 64 * kRowBytes;

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

// bf16 at head width 64 or 128 goes to the tensor-core kernels; float32, and
// bf16 at head width 32, to the CUDA-core ones
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* Dsum, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
             int hd, const Strides& st, int causal, float scale,
             cudaStream_t stream) {
  constexpr bool tensor_cores = std::is_same<T, __nv_bfloat16>::value;
#define BWD_ARGS                                                            \
  q, k, v, o, dout, lse, Dsum, dq, dk, dv, B, Sq, Skv, Hq, Hkv, st, causal, \
      scale, stream
  switch (hd) {
    case 32:
      return launch<T, 32>(BWD_ARGS);
    case 64:
      if constexpr (tensor_cores)
        return hopper::launch<64>(BWD_ARGS);
      else
        return launch<T, 64>(BWD_ARGS);
    case 128:
      if constexpr (tensor_cores)
        return hopper::launch<128>(BWD_ARGS);
      else
        return launch<T, 128>(BWD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

}  // namespace

extern "C" {

// q, k, v through their (batch, row, head) strides, head axis contiguous;
// o, dout, dq (B, Sq, Hq, hd), dk, dv (B, Skv, Hkv, hd) contiguous; lse
// (B, Hq, Sq) f32 contiguous; Dsum a scratch the first kernel writes:
// (B, Hq, Sq) f32 on the CUDA cores, (B, Hq, ceil(Sq / 64), 2, 64) f32 on
// the tensor cores.
#define FLASH_BWD_ENTRY(NAME, T)                                             \
  int NAME(const void* q, const void* k, const void* v, const void* o,      \
           const void* dout, const float* lse, float* Dsum, void* dq,       \
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,     \
           int hd, long long qsb, long long qss, long long qsh,             \
           long long ksb, long long kss, long long ksh, long long vsb,      \
           long long vss, long long vsh, int causal, float scale,           \
           cudaStream_t stream) {                                           \
    const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};          \
    return dispatch<T>(q, k, v, o, dout, lse, Dsum, dq, dk, dv, B, Sq, Skv, \
                       Hq, Hkv, hd, st, causal, scale, stream);             \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
