// RM (P5) candidate-price sweep for B lanes, by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/gnep_sweep/kernel.py: rm_sweep_batched
// (_kernel_batched) and rm_sweep (_kernel), which is this kernel at B = 1.
//
// For every lane b and candidate row c, walking the p-sorted classes j in
// order:  cum += inc[b,c,j];  fill = clip(spare[b] - (cum - inc), 0, inc);
// sum_fill += fill;  p_fill += fill * p[b,j].
//
// What bounds it: bytes.  The (B, Nc, N) inc tensor is read once and the
// fill tensor of the same shape written once (about 1 GB in f64 at the
// main path's 256 x 502 x 500); the arithmetic is eight operations per
// element, far below the card's rate for that traffic.
//
// Design: the TPU kernel carries the running sums in VMEM scratch across a
// sequential grid axis; Hopper blocks run in no order, so one block owns
// one (lane, tile of 128 candidates) and each thread owns one candidate,
// keeping cum / sum_fill / p_fill in registers while it walks the whole
// class axis.  A thread's row is contiguous in memory, so the block stages
// 128 x 32 tiles through shared memory: the warps load and store them with
// consecutive threads on consecutive classes, and each thread then walks
// its row of the tile.  The class order of every running sum is the
// sequential one; the plain version sums with torch.cumsum and a tree
// reduction, so the two agree within the reordering bound, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kTileC = 128;  // candidates per block, one per thread
constexpr int kTileN = 32;   // classes staged per step (one per lane of a warp)
constexpr int kWarps = kTileC / 32;

__device__ __forceinline__ float clip0(float x, float hi) {
  return fminf(fmaxf(x, 0.0f), hi);
}
__device__ __forceinline__ double clip0(double x, double hi) {
  return fmin(fmax(x, 0.0), hi);
}

template <typename T>
__global__ void __launch_bounds__(kTileC)
rm_sweep_kernel(const T* __restrict__ inc, const T* __restrict__ spare,
                const T* __restrict__ p, T* __restrict__ fill,
                T* __restrict__ sum_fill, T* __restrict__ p_fill,
                int Nc, int N) {
  __shared__ T tile[kTileC][kTileN + 1];
  __shared__ T p_tile[kTileN];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kTileC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t lane_base = (size_t)b * Nc * N;
  const T sp = spare[b];
  T cum = 0, sacc = 0, pacc = 0;

  for (int j0 = 0; j0 < N; j0 += kTileN) {
    const int jn = min(kTileN, N - j0);
    for (int r = warp; r < kTileC; r += kWarps) {
      const int c = c0 + r;
      tile[r][lane] = (c < Nc && lane < jn)
          ? inc[lane_base + (size_t)c * N + j0 + lane] : T(0);
    }
    if (threadIdx.x < kTileN) {
      p_tile[threadIdx.x] = threadIdx.x < jn
          ? p[(size_t)b * N + j0 + threadIdx.x] : T(0);
    }
    __syncthreads();

    T* row = tile[threadIdx.x];
    for (int jj = 0; jj < jn; ++jj) {
      const T x = row[jj];
      cum = cum + x;
      const T f = clip0(sp - (cum - x), x);
      row[jj] = f;
      sacc = sacc + f;
      pacc = pacc + f * p_tile[jj];
    }
    __syncthreads();

    for (int r = warp; r < kTileC; r += kWarps) {
      const int c = c0 + r;
      if (c < Nc && lane < jn) {
        fill[lane_base + (size_t)c * N + j0 + lane] = tile[r][lane];
      }
    }
    __syncthreads();
  }
  const int c = c0 + threadIdx.x;
  if (c < Nc) {
    sum_fill[(size_t)b * Nc + c] = sacc;
    p_fill[(size_t)b * Nc + c] = pacc;
  }
}

template <typename T>
int launch(const T* inc, const T* spare, const T* p, T* fill, T* sum_fill,
           T* p_fill, int B, int Nc, int N, cudaStream_t stream) {
  if (B > 0 && Nc > 0) {
    const dim3 grid(B, (Nc + kTileC - 1) / kTileC);
    rm_sweep_kernel<T><<<grid, kTileC, 0, stream>>>(inc, spare, p, fill,
                                                    sum_fill, p_fill, Nc, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rm_sweep_f32(const float* inc, const float* spare, const float* p,
                 float* fill, float* sum_fill, float* p_fill, int B, int Nc,
                 int N, cudaStream_t stream) {
  return launch(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N, stream);
}

int rm_sweep_f64(const double* inc, const double* spare, const double* p,
                 double* fill, double* sum_fill, double* p_fill, int B, int Nc,
                 int N, cudaStream_t stream) {
  return launch(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
