// Chunked RWKV6 WKV, by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6/kernel.py: wkv6 (_kernel), and computes
// exactly the chunked formula of repro.models.rwkv.wkv_chunked at the
// given chunk L.  Per (batch, head) and chunk, with w the log decay:
//   LW  = cumsum(w) over the chunk's rows,  LWp = LW - w,  Z = LW[L / 2]
//   Q   = r * exp(clip(LWp - Z, -30, 30)),  Kf = k * exp(clip(Z - LW, -30, 30))
//   y_t = sum_{m<t} (Q_t . Kf_m) v_m + (sum_k r_t u k_t) v_t + (r_t e^{LWp_t}) S
//   S  <- e^{LW_end} * S + sum_t (k_t e^{LW_end - LW_t})^T v_t
// The state starts at S0 (zeros for the TPU kernel's function) and the
// final state is written out.  All of it in f32.
//
// What bounds it: operations.  At the RWKV6-7B prefill (B 4, T 1024, 64
// heads of 64, chunk 256, f32) the chunked form does about 13 GFLOP against
// about 0.34 GB of traffic: 0.19 ms at the card's f32 rate, 0.1 ms at its
// memory rate.
//
// Design: the Pallas kernel keeps the K x V state in VMEM scratch over a
// sequential chunk axis.  Here one block owns one (batch, head), keeps the
// state in shared memory and loops over the chunks in order.  A chunk of
// 256 rows does not fit on chip in all its operands, so it is cut into
// sub-tiles of 64 rows.  A first pass walks the chunk's log decays once,
// one thread per channel, and keeps the running sum at every sub-tile
// boundary and at rows L / 2 and L - 1; any sub-tile's LW is then
// recomputed from its boundary value by the same sequential sum, so every
// recomputation is bitwise the first.  Output sub-tile i takes the
// diagonal product with its own rows (masked m < t) and the full products
// with every earlier sub-tile j < i; its share of the state update is
// summed in registers and applied after the chunk's last sub-tile, since
// every row of the chunk reads the state as it was at the chunk's start.
// 256 threads: each holds 4 rows x 4 columns of every 64 x 64 product.
// The chunk L is a runtime value: any L that divides T, down to 1; a
// ragged last sub-tile (L not a multiple of 64) is bounded in every loop.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTS = 64;       // rows per sub-tile; also the most K and V
constexpr int kThreads = 256;
constexpr int kLD = kTS + 1;  // padded row of the (row x channel) tiles
constexpr float kClamp = 30.0f;

__device__ __forceinline__ float clamp_exp(float x) {
  return expf(fminf(fmaxf(x, -kClamp), kClamp));
}

// rows x n of a (T, H, n)-strided operand -> dst[t * ld + c]
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long row_stride, int rows,
                                          int n) {
  for (int idx = threadIdx.x; idx < rows * n; idx += kThreads) {
    const int t = idx / n, c = idx % n;
    dst[t * ld + c] = src[(long long)t * row_stride + c];
  }
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ S0,
            float* __restrict__ y, float* __restrict__ S_out, int T, int H,
            int K, int V, int L) {
  extern __shared__ float smem[];
  float* Ss = smem;                 // K x V state, row stride kTS
  float* Zs = Ss + kTS * kTS;       // LW[L / 2]
  float* LWe = Zs + kTS;            // LW[L - 1]
  float* us = LWe + kTS;            // the bonus u of this head
  float* diag = us + kTS;           // sum_k r u k of the sub-tile's rows
  float* Qi = diag + kTS;           // LWp, then Q of output sub-tile i
  float* Ri = Qi + kTS * kLD;       // r e^{LWp} of sub-tile i, then A
  float* Tj = Ri + kTS * kLD;       // w, then LW, then K2 of a sub-tile
  float* Kf = Tj + kTS * kLD;       // Kf of a sub-tile
  float* Vj = Kf + kTS * kLD;       // v of a sub-tile, row stride kTS
  float* carry = Vj + kTS * kTS;    // LW before each sub-tile of the chunk

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const long long rowK = (long long)H * K, rowV = (long long)H * V;
  const float* rb = r + (long long)b * T * rowK + (long long)h * K;
  const float* kb = k + (long long)b * T * rowK + (long long)h * K;
  const float* wb = w + (long long)b * T * rowK + (long long)h * K;
  const float* vb = v + (long long)b * T * rowV + (long long)h * V;
  float* yb = y + (long long)b * T * rowV + (long long)h * V;
  const long long sbase = ((long long)b * H + h) * K * V;

  for (int idx = tid; idx < K * V; idx += kThreads)
    Ss[(idx / V) * kTS + idx % V] = S0 ? S0[sbase + idx] : 0.0f;
  if (tid < K) us[tid] = u[(long long)h * K + tid];

  const int nsub = (L + kTS - 1) / kTS;
  for (int t0 = 0; t0 < T; t0 += L) {
    // pass 1: the sequential log-decay sum, one thread per channel
    float run = 0.0f;
    for (int s = 0; s < nsub; ++s) {
      const int rows = min(kTS, L - s * kTS);
      __syncthreads();
      load_rows(Tj, kLD, wb + (long long)(t0 + s * kTS) * rowK, rowK, rows, K);
      __syncthreads();
      if (tid < K) {
        carry[s * kTS + tid] = run;
        for (int t = 0; t < rows; ++t) {
          run += Tj[t * kLD + tid];
          if (s * kTS + t == L / 2) Zs[tid] = run;
        }
      }
    }
    if (tid < K) LWe[tid] = run;

    float sacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[a][c] = 0.0f;

    for (int i = 0; i < nsub; ++i) {
      const int ri0 = t0 + i * kTS;
      const int rows_i = min(kTS, L - i * kTS);
      __syncthreads();
      load_rows(Tj, kLD, wb + (long long)ri0 * rowK, rowK, rows_i, K);
      load_rows(Vj, kTS, vb + (long long)ri0 * rowV, rowV, rows_i, V);
      __syncthreads();
      if (tid < K) {
        float c = carry[i * kTS + tid];
        for (int t = 0; t < rows_i; ++t) {
          const float wv = Tj[t * kLD + tid];
          c += wv;
          Tj[t * kLD + tid] = c;        // LW
          Qi[t * kLD + tid] = c - wv;   // LWp
        }
      }
      __syncthreads();
      for (int idx = tid; idx < rows_i * K; idx += kThreads) {
        const int t = idx / K, kk = idx % K;
        const long long g = (long long)(ri0 + t) * rowK + kk;
        const float rr = rb[g], kv = kb[g];
        const float lw = Tj[t * kLD + kk], lwp = Qi[t * kLD + kk];
        Qi[t * kLD + kk] = rr * clamp_exp(lwp - Zs[kk]);
        Ri[t * kLD + kk] = rr * expf(lwp);
        Kf[t * kLD + kk] = kv * clamp_exp(Zs[kk] - lw);
        Tj[t * kLD + kk] = kv * expf(LWe[kk] - lw);   // K2, exponent <= 0
      }
      for (int t = warp; t < rows_i; t += kThreads / 32) {
        float p = 0.0f;
        for (int kk = lane; kk < K; kk += 32) {
          const long long g = (long long)(ri0 + t) * rowK + kk;
          p += rb[g] * us[kk] * kb[g];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) diag[t] = p;
      }
      __syncthreads();

      // bonus and inter-chunk terms; this sub-tile's share of the state
      float yacc[4][4], areg[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int vv = tx + 16 * c;
          float inter = 0.0f;
          if (t < rows_i && vv < V) {
            for (int kk = 0; kk < K; ++kk)
              inter += Ri[t * kLD + kk] * Ss[kk * kTS + vv];
            yacc[a][c] = diag[t] * Vj[t * kTS + vv] + inter;
          } else {
            yacc[a][c] = 0.0f;
          }
        }
      }
      for (int t = 0; t < rows_i; ++t) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float k2 = Tj[t * kLD + ty * 4 + a];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sacc[a][c] += k2 * Vj[t * kTS + tx + 16 * c];
        }
      }
      // intra-chunk, diagonal sub-tile: A[t][m] = Q_t . Kf_m for m < t
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) areg[a][c] = 0.0f;
      for (int kk = 0; kk < K; ++kk) {
        float qv[4], kf[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = Qi[(ty * 4 + a) * kLD + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) kf[c] = Kf[(tx + 16 * c) * kLD + kk];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) areg[a][c] += qv[a] * kf[c];
      }
      __syncthreads();  // every thread is done reading Ri
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = ty * 4 + a, m = tx + 16 * c;
          Ri[t * kLD + m] = m < t ? areg[a][c] : 0.0f;
        }
      __syncthreads();
      for (int m = 0; m < rows_i; ++m) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float av = Ri[(ty * 4 + a) * kLD + m];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            yacc[a][c] += av * Vj[m * kTS + tx + 16 * c];
        }
      }

      // intra-chunk, earlier sub-tiles j < i (full, unmasked)
      for (int j = 0; j < i; ++j) {
        const int rj0 = t0 + j * kTS;
        __syncthreads();
        load_rows(Tj, kLD, wb + (long long)rj0 * rowK, rowK, kTS, K);
        load_rows(Vj, kTS, vb + (long long)rj0 * rowV, rowV, kTS, V);
        __syncthreads();
        if (tid < K) {
          float c = carry[j * kTS + tid];
          for (int t = 0; t < kTS; ++t) {
            c += Tj[t * kLD + tid];
            Tj[t * kLD + tid] = c;
          }
        }
        __syncthreads();
        for (int idx = tid; idx < kTS * K; idx += kThreads) {
          const int t = idx / K, kk = idx % K;
          Kf[t * kLD + kk] = kb[(long long)(rj0 + t) * rowK + kk]
                             * clamp_exp(Zs[kk] - Tj[t * kLD + kk]);
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) areg[a][c] = 0.0f;
        for (int kk = 0; kk < K; ++kk) {
          float qv[4], kf[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) qv[a] = Qi[(ty * 4 + a) * kLD + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) kf[c] = Kf[(tx + 16 * c) * kLD + kk];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) areg[a][c] += qv[a] * kf[c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            Ri[(ty * 4 + a) * kLD + tx + 16 * c] = areg[a][c];
        __syncthreads();
        for (int m = 0; m < kTS; ++m) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float av = Ri[(ty * 4 + a) * kLD + m];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              yacc[a][c] += av * Vj[m * kTS + tx + 16 * c];
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        if (t >= rows_i) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int vv = tx + 16 * c;
          if (vv < V) yb[(long long)(ri0 + t) * rowV + vv] = yacc[a][c];
        }
      }
    }

    __syncthreads();  // every row of the chunk has read the old state
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kk = ty * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int vv = tx + 16 * c;
        if (kk < K && vv < V)
          Ss[kk * kTS + vv] = expf(LWe[kk]) * Ss[kk * kTS + vv] + sacc[a][c];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * V; idx += kThreads)
    S_out[sbase + idx] = Ss[(idx / V) * kTS + idx % V];
}

size_t smem_bytes(int L) {
  const size_t nsub = (L + kTS - 1) / kTS;
  return sizeof(float) * (2 * kTS * kTS + 4 * kTS + 4 * kTS * kLD + nsub * kTS);
}

}  // namespace

extern "C" {

int wkv6_f32(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* S0, float* y, float* S, int B, int T,
             int H, int K, int V, int L, cudaStream_t stream) {
  if (K < 1 || K > kTS || V < 1 || V > kTS || L < 1 || T % L != 0 ||
      smem_bytes(L) > 232448)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  cudaFuncSetAttribute(wkv6_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  wkv6_kernel<<<B * H, kThreads, smem, stream>>>(r, k, v, w, u, S0, y, S, T,
                                                 H, K, V, L);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
