// Blocked GQA softmax attention (forward), by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention
// (_kernel).  For query row i of head h (kv head h / G) it computes
//   s_ij = (q_i . k_j) * scale      (f32; NEG_INF = -1e30 where j > i under
//                                    the causal mask)
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)
// with the running max m_i and sum l_i of the online softmax kept in f32,
// and writes o in q's dtype (bf16 or f32).
//
// What bounds it: operations.  At the Qwen3-0.6B prefill (B 4, S 1024,
// 16 query heads of 128, causal, bf16) the two products are 17 GFLOP per
// call against about 50 MB of q/k/v/o traffic; at the card's bf16
// tensor-core rate that is about 17 us, at its f32 FMA rate about 0.26 ms.
// This first kernel computes in f32 FMAs on the CUDA cores, so the f32 rate
// is the nearer ceiling; tensor cores (mma.sync / wgmma) are later work.
//
// Design: the Pallas kernel walks a sequential 4th grid axis over kv blocks
// and keeps m, l and acc in VMEM scratch.  Here one block owns one
// (batch, query head, 64-row query tile) and loops over 64-row kv tiles
// itself: the query tile stays in shared memory, the kv tile is staged
// there (K, then V in the same buffer), and each of the 256 threads keeps
// 4 rows x (hd / 16) columns of acc and the 4 rows' m and l in registers.
// Row statistics are reduced across the 16 threads that share the rows
// with warp shuffles.  q, k and v are read through their (B, S, H, hd)
// strides, kv head h / G, without transposed copies.  The ragged query and
// kv edges are masked in the kernel (kv columns past the end get -inf, so
// they weigh exactly 0); kv tiles wholly above the diagonal are skipped,
// since they add exactly 0; query tiles run longest-first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

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
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int Hq, int G, long long qsb, long long qss, long long qsh,
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
    T* orow = o + (((long long)b * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      store(orow + tx + 16 * cc, acc[i][cc] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, long long qsb, long long qss,
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
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hq / Hkv,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int Hq, int Hkv, int hd, long long qsb,
             long long qss, long long qsh, long long ksb, long long kss,
             long long ksh, long long vsb, long long vss, long long vsh,
             int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qsb, qss, qsh,
                           ksb, kss, ksh, vsb, vss, vsh, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qsb, qss, qsh,
                           ksb, kss, ksh, vsb, vss, vsh, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qsb, qss, qsh,
                            ksb, kss, ksh, vsb, vss, vsh, causal, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* k, const void* v, void* o, int B,       \
           int Sq, int Skv, int Hq, int Hkv, int hd, long long qsb,           \
           long long qss, long long qsh, long long ksb, long long kss,        \
           long long ksh, long long vsb, long long vss, long long vsh,        \
           int causal, float scale, cudaStream_t stream) {                    \
    return dispatch<T>(q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, qsb, qss, qsh,    \
                       ksb, kss, ksh, vsb, vss, vsh, causal, scale, stream);  \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
