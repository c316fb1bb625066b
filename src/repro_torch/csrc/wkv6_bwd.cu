// Chunked RWKV6 WKV (backward), by hand for Hopper (sm_90a).
//
// The gradient of csrc/wkv6.cu's forward: of the chunked formula of
// repro.models.rwkv.wkv_chunked at the given chunk L, with respect to r, k,
// v, the log decay w, the bonus u and the initial state S0, from the
// cotangents dy of y and dS of the final state.  Per (batch, head) and
// chunk, with the forward's LW, LWp, Z, Q, Kf, A, R = r e^{LWp}, K2 =
// k e^{LW_end - LW}, S the state at the chunk's start and dS' the
// cotangent of the state at its end:
//   dv  = A^T dy + diag dy + K2 dS'              dA = tril_{-1}(dy v^T)
//   dQ  = dA Kf,  dKf = dA^T Q,  dR = dy S^T,  dK2 = v dS'^T
//   dr  = dQ eQ + dR e^{LWp} + ddiag u k         ddiag_t = dy_t . v_t
//   dk  = dKf eK + dK2 e^{LW_end - LW} + ddiag u r
//   dS  = e^{LW_end} dS' + R^T dy                (the previous chunk's dS')
// and for the log decay, with gQ = dQ Q and gK = dKf Kf where the clip at
// +-30 passes them (0 outside, as autograd of torch.clamp):
//   dLWp = gQ + dR R,   E = -gK - dK2 K2,   dZ = sum_t (gK - gQ),
//   dLW_end = sum_t dK2 K2 + sum_v dS' S e^{LW_end},
//   dw_t = sum_{s >= t} (dLWp_s + E_s) - dLWp_t + dLW_end + [t <= L/2] dZ
// (LW = cumsum(w), LWp = LW - w, Z = LW[L / 2], LW_end = LW[L - 1]).
// du sums ddiag r k over the rows: each block writes its (batch, head)
// partial, and the wrapper adds the batches in order.  All of it in f32.
//
// Two kernels, launched in this order on one stream, one block per (batch,
// head) each, 256 threads:
//   1. wkv6_bwd_states walks the chunks in order, as the forward does, and
//      writes the state at each chunk's start to a (B, H, n, K, V) scratch
//      that the wrapper allocates.  The forward's routes keep no such
//      states (the per-head kernel holds its state in shared memory; the
//      chunk-parallel route's S_c live in a scratch freed with the call),
//      and recomputing them costs one K2^T v product a chunk, against the
//      backward's eight, so the forward is left as serving runs it.
//   2. wkv6_bwd walks the chunks in reverse with dS' in shared memory.  A
//      chunk is cut into sub-tiles of 64 rows, as the per-head forward cuts
//      it (any L that divides T, down to 1; a ragged last sub-tile is
//      zero-padded), and the sub-tiles are taken last first, so that the
//      reversed sum of dLW carries across them.  For sub-tile i: dQ_i sums
//      dA_ij Kf_j over the sub-tiles j <= i, and dKf_i and dv_i sum dA_ji^T
//      Q_j and A_ji^T dy_j over j >= i, each other sub-tile's Kf or Q
//      recomputed from its LW, which a channel's thread resums from the
//      chunk's carries in the forward's order.  Then the elementwise terms,
//      dv's K2 dS' and diag terms, dS's R^T dy share (held in registers
//      over the chunk), and dw's reversed sum by one thread a channel.  dZ
//      and dLW_end are known only at the chunk's end; the same threads then
//      add them to the chunk's dw.
// Every sum runs in a fixed order, nothing is added atomically, so two
// calls give the same bits.  This first version runs the products in f32
// FMAs from shared memory (each 64 x 64 x 64, every pair of sub-tiles
// taken twice); the tensor cores and a chunk-parallel walk are later work.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTS = 64;        // rows per sub-tile; also the most K and V
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 columns of a tile each
constexpr int kLD = kTS + 1;   // padded row of every shared tile
constexpr int kTile = kTS * kLD;
constexpr float kClamp = 30.0f;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float clampf(float x) {
  return fminf(fmaxf(x, -kClamp), kClamp);
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// acc[a][b] = sum_c A[(ty 4 + a) kLD + c] B[(tx + 16 b) kLD + c]
__device__ __forceinline__ void dot_rows(float (&acc)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kTS; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty * 4 + a) * kLD + c];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * kLD + c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += x[a] * y[b];
  }
}

// acc[a][b] += sum_m P[(ty 4 + a) kLD + m] X[m kLD + tx + 16 b]
__device__ __forceinline__ void acc_rows(float (&acc)[4][4],
                                         const float* __restrict__ P,
                                         const float* __restrict__ X, int ty,
                                         int tx) {
#pragma unroll 8
  for (int m = 0; m < kTS; ++m) {
    float p[4], x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = P[(ty * 4 + a) * kLD + m];
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = X[m * kLD + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += p[a] * x[b];
  }
}

// acc[a][b] += sum_t P[t kLD + ty 4 + a] X[t kLD + tx + 16 b]
__device__ __forceinline__ void acc_cols(float (&acc)[4][4],
                                         const float* __restrict__ P,
                                         const float* __restrict__ X, int ty,
                                         int tx) {
#pragma unroll 8
  for (int t = 0; t < kTS; ++t) {
    float p[4], x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = P[t * kLD + ty * 4 + a];
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = X[t * kLD + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += p[a] * x[b];
  }
}

// nr rows x n channels of a (T, H, n)-strided operand -> dst, zero-padded
// to 64 x 64
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int nr,
                                          int n) {
  for (int idx = threadIdx.x; idx < kTS * kTS; idx += kThreads) {
    const int t = idx / kTS, c = idx % kTS;
    dst[t * kLD + c] =
        t < nr && c < n ? src[(long long)t * row_stride + c] : 0.0f;
  }
}

// The chunk's carries (LW before each sub-tile), Z = LW[L / 2] and LW_end,
// one thread a channel summing w in order.  Threads past K write zeros.
__device__ __forceinline__ void chunk_carries(float* carry, float* Zs,
                                              float* LWe,
                                              const float* __restrict__ wb,
                                              long long rowK, int L, int K) {
  const int ch = threadIdx.x;
  if (ch >= kTS) return;
  float lw = 0.0f, z = 0.0f;
  for (int t = 0; t < L; ++t) {
    if (t % kTS == 0) carry[(t / kTS) * kTS + ch] = ch < K ? lw : 0.0f;
    if (ch < K) lw += wb[(long long)t * rowK + ch];
    if (t == L / 2) z = lw;
  }
  Zs[ch] = ch < K ? z : 0.0f;
  LWe[ch] = ch < K ? lw : 0.0f;
}

// LW of a sub-tile's nr rows from its carry, in the carry pass's order
__device__ __forceinline__ void lw_rows(float* dst, const float* __restrict__ wb,
                                        long long rowK, int nr, int K,
                                        float carry) {
  const int ch = threadIdx.x;
  if (ch >= kTS) return;
  float lw = carry;
  for (int t = 0; t < kTS; ++t) {
    if (t < nr && ch < K) lw += wb[(long long)t * rowK + ch];
    dst[t * kLD + ch] = t < nr && ch < K ? lw : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
wkv6_bwd_states(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ S0,
                float* __restrict__ Sc, int T, int H, int K, int V, int L) {
  extern __shared__ float smem[];
  float* Ss = smem;              // K x V, row kLD
  float* LWt = Ss + kTile;       // LW, then K2, of a sub-tile
  float* Vt = LWt + kTile;       // v of a sub-tile
  float* LWe = Vt + kTile;
  float* Zs = LWe + kTS;
  float* carry = Zs + kTS;       // nsub x kTS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long rowK = (long long)H * K, rowV = (long long)H * V;
  const long long base = (long long)b * T;
  const float* kb = k + base * rowK + (long long)h * K;
  const float* wb = w + base * rowK + (long long)h * K;
  const float* vb = v + base * rowV + (long long)h * V;
  const long long sbh = ((long long)b * H + h);
  const int n = T / L, nsub = (L + kTS - 1) / kTS;

  for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
    const int i = idx / kTS, j = idx % kTS;
    Ss[i * kLD + j] = i < K && j < V && S0 != nullptr
                          ? S0[(sbh * K + i) * V + j] : 0.0f;
  }
  for (int c = 0; c < n; ++c) {
    const long long t0 = (long long)c * L;
    __syncthreads();
    float* out = Sc + (sbh * n + c) * K * V;
    for (int idx = tid; idx < K * V; idx += kThreads)
      out[idx] = Ss[(idx / V) * kLD + idx % V];
    chunk_carries(carry, Zs, LWe, wb + t0 * rowK, rowK, L, K);
    float U[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) U[a][bb] = 0.0f;
    for (int s = 0; s < nsub; ++s) {
      const int nr = min(kTS, L - s * kTS);
      const long long ts = t0 + s * kTS;
      __syncthreads();
      lw_rows(LWt, wb + ts * rowK, rowK, nr, K, carry[s * kTS + tid % kTS]);
      load_rows(Vt, vb + ts * rowV, rowV, nr, V);
      __syncthreads();
      for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
        const int t = idx / kTS, ch = idx % kTS;
        LWt[t * kLD + ch] =
            t < nr && ch < K
                ? kb[(ts + t) * rowK + ch] * expf(LWe[ch] - LWt[t * kLD + ch])
                : 0.0f;
      }
      __syncthreads();
      acc_cols(U, LWt, Vt, ty, tx);    // U[k][v] += sum_t K2[t][k] v[t][v]
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = ty * 4 + a, j = tx + 16 * bb;
        Ss[i * kLD + j] = expf(LWe[i]) * Ss[i * kLD + j] + U[a][bb];
      }
  }
}

struct Out {
  float *dr, *dk, *dv, *dw, *du, *dS0;
};

__global__ void __launch_bounds__(kThreads)
wkv6_bwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ dy,
         const float* __restrict__ dSfin, const float* __restrict__ Sc,
         Out out, int T, int H, int K, int V, int L) {
  extern __shared__ float smem[];
  float* Ss = smem;              // the state at the chunk's start
  float* dSs = Ss + kTile;       // dS': the cotangent of its end state
  float* Li = dSs + kTile;       // LW of sub-tile i, then ddiag r k
  float* Qi = Li + kTile;        // Q_i, then gK - gQ
  float* Kfi = Qi + kTile;       // Kf_i, then dK2 K2
  float* Vi = Kfi + kTile;       // v_i
  float* DYi = Vi + kTile;       // dy_i
  float* X = DYi + kTile;        // Kf_j or Q_j, then R
  float* Y = X + kTile;          // v_j or dy_j, then K2
  float* P1 = Y + kTile;         // dA_ij or A_ji, then dLWp
  float* P2 = P1 + kTile;        // dA_ji, then E
  float* Lt = P2 + kTile;        // LW of sub-tile j
  float* Zs = Lt + kTile;
  float* LWe = Zs + kTS;
  float* us = LWe + kTS;
  float* dZa = us + kTS;         // sum_t (gK - gQ) over the chunk
  float* dLWea = dZa + kTS;      // sum_t dK2 K2, then dLW_end
  float* diag = dLWea + kTS;     // sum_k r u k of sub-tile i's rows
  float* ddiag = diag + kTS;     // dy . v of sub-tile i's rows
  float* carry = ddiag + kTS;    // nsub x kTS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long rowK = (long long)H * K, rowV = (long long)H * V;
  const long long base = (long long)b * T;
  const long long offK = base * rowK + (long long)h * K;
  const long long offV = base * rowV + (long long)h * V;
  const float *rb = r + offK, *kb = k + offK, *wb = w + offK;
  const float *vb = v + offV, *dyb = dy + offV;
  float *drb = out.dr + offK, *dkb = out.dk + offK, *dwb = out.dw + offK;
  float* dvb = out.dv + offV;
  const long long sbh = ((long long)b * H + h);
  const int n = T / L, nsub = (L + kTS - 1) / kTS;

  for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
    const int i = idx / kTS, j = idx % kTS;
    dSs[i * kLD + j] = i < K && j < V && dSfin != nullptr
                           ? dSfin[(sbh * K + i) * V + j] : 0.0f;
  }
  if (tid < kTS) us[tid] = tid < K ? u[h * K + tid] : 0.0f;
  float du_acc = 0.0f, rc_run = 0.0f;   // the channel threads' sums

  for (int c = n - 1; c >= 0; --c) {
    const long long t0 = (long long)c * L;
    __syncthreads();
    const float* Sin = Sc + (sbh * n + c) * K * V;
    for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
      const int i = idx / kTS, j = idx % kTS;
      Ss[i * kLD + j] = i < K && j < V ? Sin[i * V + j] : 0.0f;
    }
    chunk_carries(carry, Zs, LWe, wb + t0 * rowK, rowK, L, K);
    if (tid < kTS) dZa[tid] = dLWea[tid] = 0.0f;
    rc_run = 0.0f;
    float dSacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) dSacc[a][bb] = 0.0f;

    for (int i = nsub - 1; i >= 0; --i) {
      const int nr = min(kTS, L - i * kTS);
      const long long ti = t0 + i * kTS;
      // ---- sub-tile i's own tiles ----
      __syncthreads();
      lw_rows(Li, wb + ti * rowK, rowK, nr, K, carry[i * kTS + tid % kTS]);
      load_rows(Vi, vb + ti * rowV, rowV, nr, V);
      load_rows(DYi, dyb + ti * rowV, rowV, nr, V);
      __syncthreads();
      for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
        const int t = idx / kTS, ch = idx % kTS;
        float q = 0.0f, kf = 0.0f;
        if (t < nr && ch < K) {
          const long long g = (ti + t) * rowK + ch;
          const float lw = Li[t * kLD + ch];
          q = rb[g] * expf(clampf(lw - wb[g] - Zs[ch]));
          kf = kb[g] * expf(clampf(Zs[ch] - lw));
        }
        Qi[t * kLD + ch] = q;
        Kfi[t * kLD + ch] = kf;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        float pd = 0.0f, pdd = 0.0f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int ch = tx + 16 * bb;
          if (t < nr && ch < K) {
            const long long g = (ti + t) * rowK + ch;
            pd += rb[g] * us[ch] * kb[g];
          }
          if (t < nr && ch < V) {
            const long long g = (ti + t) * rowV + ch;
            pdd += dyb[g] * vb[g];
          }
        }
        pd = sum16(pd);
        pdd = sum16(pdd);
        if (tx == 0) {
          diag[t] = pd;
          ddiag[t] = pdd;
        }
      }
      __syncthreads();

      // ---- dQ_i = sum_{j <= i} dA_ij Kf_j ----
      float dQ[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) dQ[a][bb] = 0.0f;
      for (int j = 0; j <= i; ++j) {
        const float *Kfj = Kfi, *Vj = Vi;
        if (j < i) {
          const long long tj = t0 + j * kTS;
          __syncthreads();
          lw_rows(Lt, wb + tj * rowK, rowK, kTS, K, carry[j * kTS + tid % kTS]);
          load_rows(Y, vb + tj * rowV, rowV, kTS, V);
          __syncthreads();
          for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
            const int t = idx / kTS, ch = idx % kTS;
            X[t * kLD + ch] =
                ch < K ? kb[(tj + t) * rowK + ch] *
                             expf(clampf(Zs[ch] - Lt[t * kLD + ch]))
                       : 0.0f;
          }
          Kfj = X;
          Vj = Y;
        }
        float dA[4][4];
        dot_rows(dA, DYi, Vj, ty, tx);
        __syncthreads();   // the last product is done with P1
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int t = ty * 4 + a, m = tx + 16 * bb;
            P1[t * kLD + m] = (j < i || m < t) ? dA[a][bb] : 0.0f;
          }
        __syncthreads();
        acc_rows(dQ, P1, Kfj, ty, tx);
      }

      // ---- dKf_i = sum_{j >= i} dA_ji^T Q_j, dv_i = sum A_ji^T dy_j ----
      float dKf[4][4], dv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) dKf[a][bb] = dv[a][bb] = 0.0f;
      for (int j = i; j < nsub; ++j) {
        const float *Qj = Qi, *DYj = DYi;
        if (j > i) {
          const int nj = min(kTS, L - j * kTS);
          const long long tj = t0 + j * kTS;
          __syncthreads();
          lw_rows(Lt, wb + tj * rowK, rowK, nj, K, carry[j * kTS + tid % kTS]);
          load_rows(Y, dyb + tj * rowV, rowV, nj, V);
          __syncthreads();
          for (int idx = tid; idx < kTS * kTS; idx += kThreads) {
            const int t = idx / kTS, ch = idx % kTS;
            float q = 0.0f;
            if (t < nj && ch < K) {
              const long long g = (tj + t) * rowK + ch;
              q = rb[g] * expf(clampf(Lt[t * kLD + ch] - wb[g] - Zs[ch]));
            }
            X[t * kLD + ch] = q;
          }
          Qj = X;
          DYj = Y;
        }
        __syncthreads();
        float A[4][4], dA[4][4];
        dot_rows(A, Qj, Kfi, ty, tx);
        dot_rows(dA, DYj, Vi, ty, tx);
        __syncthreads();   // the last sums are done with P1 and P2
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int t = ty * 4 + a, m = tx + 16 * bb;
            const bool keep = j > i || m < t;
            P1[t * kLD + m] = keep ? A[a][bb] : 0.0f;
            P2[t * kLD + m] = keep ? dA[a][bb] : 0.0f;
          }
        __syncthreads();
        acc_cols(dv, P1, DYj, ty, tx);
        acc_cols(dKf, P2, Qj, ty, tx);
      }

      // ---- the elementwise terms of sub-tile i ----
      float dR[4][4], dK2[4][4];
      dot_rows(dR, DYi, Ss, ty, tx);    // dR[t][k] = sum_v dy[t][v] S[k][v]
      dot_rows(dK2, Vi, dSs, ty, tx);   // dK2[t][k] = sum_v v[t][v] dS'[k][v]
      __syncthreads();   // every product is done with the tiles below
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int t = ty * 4 + a, ch = tx + 16 * bb;
          const int e = t * kLD + ch;
          float R = 0.0f, K2 = 0.0f, dLWp = 0.0f, E = 0.0f, gz = 0.0f,
                k2k2 = 0.0f, duk = 0.0f;
          if (t < nr && ch < K) {
            const long long g = (ti + t) * rowK + ch;
            const float lw = Li[e], rr = rb[g], kk = kb[g];
            const float lwp = lw - wb[g];
            const float xq = lwp - Zs[ch], xk = Zs[ch] - lw;
            const float eQ = expf(clampf(xq)), eK = expf(clampf(xk));
            const float eP = expf(lwp), e2 = expf(LWe[ch] - lw);
            R = rr * eP;
            K2 = kk * e2;
            const float bonus = ddiag[t] * us[ch];
            drb[g] = dQ[a][bb] * eQ + dR[a][bb] * eP + bonus * kk;
            dkb[g] = dKf[a][bb] * eK + dK2[a][bb] * e2 + bonus * rr;
            const float gQ =
                fabsf(xq) <= kClamp ? dQ[a][bb] * (rr * eQ) : 0.0f;
            const float gK =
                fabsf(xk) <= kClamp ? dKf[a][bb] * (kk * eK) : 0.0f;
            k2k2 = dK2[a][bb] * K2;
            dLWp = gQ + dR[a][bb] * R;
            E = -gK - k2k2;
            gz = gK - gQ;
            duk = ddiag[t] * rr * kk;
          }
          X[e] = R;
          Y[e] = K2;
          P1[e] = dLWp;
          P2[e] = E;
          Qi[e] = gz;
          Kfi[e] = k2k2;
          Li[e] = duk;
        }
      __syncthreads();
      acc_rows(dv, Y, dSs, ty, tx);     // dv[m][v] += sum_k K2[m][k] dS'[k][v]
      acc_cols(dSacc, X, DYi, ty, tx);  // dS[k][v] += sum_t R[t][k] dy[t][v]
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int m = ty * 4 + a, ch = tx + 16 * bb;
          if (m < nr && ch < V)
            dvb[(ti + m) * rowV + ch] =
                dv[a][bb] + diag[m] * DYi[m * kLD + ch];
        }
      // dw's reversed sum, one thread a channel, last row first
      if (tid < K) {
        for (int t = nr - 1; t >= 0; --t) {
          const int e = t * kLD + tid;
          dwb[(ti + t) * rowK + tid] = rc_run + P2[e];
          rc_run += P1[e] + P2[e];
          dZa[tid] += Qi[e];
          dLWea[tid] += Kfi[e];
          du_acc += Li[e];
        }
      }
    }

    // ---- the chunk's end: dZ and dLW_end into dw, then dS ----
    __syncthreads();
    if (tid < K) {
      float sv = 0.0f;
      for (int j = 0; j < V; ++j)
        sv += dSs[tid * kLD + j] * Ss[tid * kLD + j];
      const float dlwe = dLWea[tid] + sv * expf(LWe[tid]);
      const float dz = dZa[tid];
      for (int t = 0; t < L; ++t)
        dwb[(t0 + t) * rowK + tid] += dlwe + (t <= L / 2 ? dz : 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = ty * 4 + a, j = tx + 16 * bb;
        dSs[i * kLD + j] = expf(LWe[i]) * dSs[i * kLD + j] + dSacc[a][bb];
      }
  }
  __syncthreads();
  if (tid < K) out.du[sbh * K + tid] = du_acc;
  if (out.dS0 != nullptr)
    for (int idx = tid; idx < K * V; idx += kThreads)
      out.dS0[sbh * K * V + idx] = dSs[(idx / V) * kLD + idx % V];
}

}  // namespace

extern "C" {

// r, k, w, dr, dk, dw: (B, T, H, K); v, dy, dv: (B, T, H, V); u: (H, K);
// S0 (nullable), dS (nullable), dS0 (nullable): (B, H, K, V); Sc: a
// (B, H, T / L, K, V) scratch; du: (B, H, K) per-(batch, head) partials.
// All f32 and contiguous.
int wkv6_bwd_f32(const float* r, const float* k, const float* v,
                 const float* w, const float* u, const float* S0,
                 const float* dy, const float* dS, float* Sc, float* dr,
                 float* dk, float* dv, float* dw, float* du, float* dS0,
                 int B, int T, int H, int K, int V, int L,
                 cudaStream_t stream) {
  if (K < 1 || V < 1 || K > kTS || V > kTS || L < 1 || T % L)
    return (int)cudaErrorInvalidValue;
  const int nsub = (L + kTS - 1) / kTS;
  const size_t smem1 = sizeof(float) * (3 * kTile + 2 * kTS + nsub * kTS);
  const size_t smem2 = sizeof(float) * (12 * kTile + 7 * kTS + nsub * kTS);
  if (smem2 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(wkv6_bwd_states,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem1);
  cudaFuncSetAttribute(wkv6_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem2);
  wkv6_bwd_states<<<B * H, kThreads, smem1, stream>>>(k, v, w, S0, Sc, T, H,
                                                      K, V, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd<<<B * H, kThreads, smem2, stream>>>(
      r, k, v, w, u, dy, dS, Sc, Out{dr, dk, dv, dw, du, dS0}, T, H, K, V,
      L);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
