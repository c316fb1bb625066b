// Fused middle of one Alg. 4.1 iteration, by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/gnep_iter/kernel.py: fused_iter_sweep
// (_kernel).  Per lane b and candidate price cand[b,c], walking the
// p-sorted classes j in order:
//   inc  = bids[b,j] >= cand[b,c] ? inc_max[b,j] : 0
//   cum += inc;  fill = clip(spare - (cum - inc), 0, inc)
//   sacc += fill;  pacc += fill * p[b,j]
// then obj[b,c] = (cand - rho_bar) * (sum_r_low + sacc)
//                 + (p_r_low + pacc) - const,
// best[b] = first argmax of obj[b,:], rho[b] = cand[b,best], and the
// winning candidate's fill row, replayed, as fill_best[b,:].
//
// What bounds it: operations.  It reads O(B * N) values and writes
// O(B * (N + Nc)), but does about nine f64 operations for every
// (candidate, class) pair, O(B * Nc * N) in all.
//
// Design: the TPU kernel carries its accumulators and a running argmax in
// scratch across two sequential grid axes.  Here one block owns one lane,
// so the argmax is a block reduction and nothing crosses blocks: each
// thread takes candidates c = tid, tid + blockDim, ... and keeps cum /
// sacc / pacc in registers while it walks the class axis, which the block
// stages through shared memory in chunks that every thread reads by
// broadcast.  Only the winning row of fill is written (B x N, not
// B x Nc x N): one thread replays the winner's recurrence, which is
// bitwise the row the sweep computed.
//
// Bitwise contract with the plain torch version (kernels/gnep_iter/ref.py
// fused_middle_reference): the same operations in the same order, each
// rounded on its own.  The build passes -fmad=false so no multiply-add is
// contracted into an FMA.  Ties keep the smaller index, like torch.argmax.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // classes staged per step

__device__ __forceinline__ float clip0(float x, float hi) {
  return fminf(fmaxf(x, 0.0f), hi);
}
__device__ __forceinline__ double clip0(double x, double hi) {
  return fmin(fmax(x, 0.0), hi);
}

// (value, index) pair with first-max order: larger value wins, equal
// values keep the smaller index.
template <typename T>
__device__ __forceinline__ bool beats(T v, long long i, T bv, long long bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_iter_kernel(const T* __restrict__ bids, const T* __restrict__ inc_max,
                  const T* __restrict__ p, const T* __restrict__ cand,
                  const T* __restrict__ spare, const T* __restrict__ rho_bar,
                  const T* __restrict__ sum_r_low,
                  const T* __restrict__ p_r_low, const T* __restrict__ cnst,
                  T* __restrict__ fill_best, T* __restrict__ obj,
                  long long* __restrict__ best, T* __restrict__ rho,
                  int Nc, int N) {
  __shared__ T s_bid[kChunk], s_inc[kChunk], s_p[kChunk];
  __shared__ T s_val[kThreads / 32];
  __shared__ long long s_idx[kThreads / 32];

  const int b = blockIdx.x;
  const T* lane_bids = bids + (size_t)b * N;
  const T* lane_inc = inc_max + (size_t)b * N;
  const T* lane_p = p + (size_t)b * N;
  const T* lane_cand = cand + (size_t)b * Nc;
  const T sp = spare[b], rb = rho_bar[b], srl = sum_r_low[b];
  const T prl = p_r_low[b], cst = cnst[b];

  T my_val = 0;
  long long my_idx = -1;  // -1: no candidate yet
  for (int c0 = 0; c0 < Nc; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const T cv = c < Nc ? lane_cand[c] : T(0);
    T cum = 0, sacc = 0, pacc = 0;
    for (int j0 = 0; j0 < N; j0 += kChunk) {
      const int jn = min(kChunk, N - j0);
      __syncthreads();
      for (int j = threadIdx.x; j < jn; j += kThreads) {
        s_bid[j] = lane_bids[j0 + j];
        s_inc[j] = lane_inc[j0 + j];
        s_p[j] = lane_p[j0 + j];
      }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        const T inc = s_bid[j] >= cv ? s_inc[j] : T(0);
        cum = cum + inc;
        const T f = clip0(sp - (cum - inc), inc);
        sacc = sacc + f;
        pacc = pacc + f * s_p[j];
      }
    }
    if (c < Nc) {
      const T o = (cv - rb) * (srl + sacc) + (prl + pacc) - cst;
      obj[(size_t)b * Nc + c] = o;
      if (my_idx < 0 || beats(o, (long long)c, my_val, my_idx)) {
        my_val = o;
        my_idx = c;
      }
    }
  }

  // first-max argmax across the block: warps by shuffle, then warp 0
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_down_sync(0xffffffffu, my_val, off);
    const long long i = __shfl_down_sync(0xffffffffu, my_idx, off);
    if (i >= 0 && (my_idx < 0 || beats(v, i, my_val, my_idx))) {
      my_val = v;
      my_idx = i;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = my_val;
    s_idx[warp] = my_idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bv = s_val[0];
    long long bi = s_idx[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (s_idx[w] >= 0 && (bi < 0 || beats(s_val[w], s_idx[w], bv, bi))) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    }
    const T r = lane_cand[bi];
    best[b] = bi;
    rho[b] = r;
    // replay the winner: the same recurrence with cand = rho
    T cum = 0;
    T* row = fill_best + (size_t)b * N;
    for (int j = 0; j < N; ++j) {
      const T inc = lane_bids[j] >= r ? lane_inc[j] : T(0);
      cum = cum + inc;
      row[j] = clip0(sp - (cum - inc), inc);
    }
  }
}

template <typename T>
int launch(const T* bids, const T* inc_max, const T* p, const T* cand,
           const T* spare, const T* rho_bar, const T* sum_r_low,
           const T* p_r_low, const T* cnst, T* fill_best, T* obj,
           long long* best, T* rho, int B, int Nc, int N,
           cudaStream_t stream) {
  if (B > 0) {
    fused_iter_kernel<T><<<B, kThreads, 0, stream>>>(
        bids, inc_max, p, cand, spare, rho_bar, sum_r_low, p_r_low, cnst,
        fill_best, obj, best, rho, Nc, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_iter_sweep_f32(const float* bids, const float* inc_max,
                         const float* p, const float* cand,
                         const float* spare, const float* rho_bar,
                         const float* sum_r_low, const float* p_r_low,
                         const float* cnst, float* fill_best, float* obj,
                         long long* best, float* rho, int B, int Nc, int N,
                         cudaStream_t stream) {
  return launch(bids, inc_max, p, cand, spare, rho_bar, sum_r_low, p_r_low,
                cnst, fill_best, obj, best, rho, B, Nc, N, stream);
}

int fused_iter_sweep_f64(const double* bids, const double* inc_max,
                         const double* p, const double* cand,
                         const double* spare, const double* rho_bar,
                         const double* sum_r_low, const double* p_r_low,
                         const double* cnst, double* fill_best, double* obj,
                         long long* best, double* rho, int B, int Nc, int N,
                         cudaStream_t stream) {
  return launch(bids, inc_max, p, cand, spare, rho_bar, sum_r_low, p_r_low,
                cnst, fill_best, obj, best, rho, B, Nc, N, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
