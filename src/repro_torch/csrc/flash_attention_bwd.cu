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
// all in f32 on the CUDA cores, with the results written in the operands'
// dtype.  Two kernels, launched in this order on one stream:
//   * flash_bwd_dq, one block per (batch, query head, 64-row query tile):
//     forms D for its rows (written to a (B, Hq, Sq) f32 scratch for the
//     next kernel), then loops over the 64-row kv tiles that the mask
//     reaches, recomputing P and dS and summing dQ in registers;
//   * flash_bwd_dkdv, one block per (batch, kv head, 64-row kv tile): keeps
//     its K and V tiles in shared memory and loops over the query tiles of
//     every query head of its group that the mask reaches, recomputing P
//     and dS (transposed: kv rows x query columns) and summing dK and dV in
//     registers, then writes them once.  So the GQA sum is a loop in one
//     block, not a sum across blocks.
// Each sum runs in a fixed order and nothing is added atomically, so two
// calls give the same bits.  Each of the 256 threads holds 4 rows x 4
// columns of a 64 x 64 score tile and 4 rows x (HD / 16) columns of each
// accumulator; row statistics reduce over the 16 threads that share a row.
//
// What bounds it: operations, five products of 2 HD flops per (query, key)
// pair the mask keeps (S, dP, dV, dQ, dK), 2.5 times the forward's two.
// This first version runs them in f32 FMAs from shared memory; the tensor
// cores (wgmma, with P split as the forward splits it) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* Dsum, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
             int hd, const Strides& st, int causal, float scale,
             cudaStream_t stream) {
#define BWD_ARGS                                                            \
  q, k, v, o, dout, lse, Dsum, dq, dk, dv, B, Sq, Skv, Hq, Hkv, st, causal, \
      scale, stream
  switch (hd) {
    case 32:
      return launch<T, 32>(BWD_ARGS);
    case 64:
      return launch<T, 64>(BWD_ARGS);
    case 128:
      return launch<T, 128>(BWD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

}  // namespace

extern "C" {

// q, k, v through their (batch, row, head) strides, head axis contiguous;
// o, dout, dq (B, Sq, Hq, hd), dk, dv (B, Skv, Hkv, hd) contiguous; lse and
// Dsum (B, Hq, Sq) f32 contiguous, Dsum a scratch the first kernel writes.
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
