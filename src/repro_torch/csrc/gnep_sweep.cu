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
// fill tensor of the same shape written once: 2 x 514 MB in f64 at the main
// path's 256 x 502 x 500, 0.31 ms at 3.35 TB/s.  The arithmetic is far
// below the card's rate for that traffic (counted below).
//
// Design: a warp owns a row (lane b, candidate c), which is contiguous in
// memory (N values), and a persistent grid of 128-thread blocks walks the
// B * Nc rows with a grid stride, so no partial second wave is left.
//   * Loads first.  A warp issues every load of its row (up to kStripes
//     stripes of 32 x VEC values, 128 bytes a thread) before it uses any, so
//     each waiting warp keeps a whole row (4,000 bytes at N = 500) in
//     flight; inc is read and fill written with streaming hints (evict
//     first), p through the read-only path, where the rows of one lane hit.
//   * The running sum is a striped warp scan.  In stripe k, thread t holds
//     the VEC consecutive values at k * 32 VEC + t VEC; it adds them in
//     order, five __shfl_up_sync steps make the inclusive scan of the 32
//     thread totals, one more shifts it to the exclusive prefix, and thread
//     31's total carries to the next stripe.  Each thread then walks its VEC
//     values in order from carry + prefix: cum, fill, and its own sum_fill
//     and p_fill terms; a five-step butterfly adds the 32 partial sums and
//     thread 0 writes them.
//   * VEC = 16 bytes / sizeof(T) (2 in f64, 4 in f32) where every row of
//     inc, p and fill starts on a 16-byte boundary; VEC = 1 (scalar access,
//     the same code) otherwise, e.g. for an odd N in f64.  The wrapper
//     (kernels/gnep_sweep/kernel.py: access_width) picks the entry point;
//     the 16-byte entry points refuse a misaligned operand.
// Instructions per stripe and thread, f64, VEC = 2: 1 add for the thread
// total, 5 shuffle-adds, 2 shuffles (prefix, carry), 2 adds for the carry,
// and 8 operations per value (add, 2 subtracts, max, min, add, multiply,
// add); a shuffle of a double is two 32-bit shuffles.  At the main shape
// (128,512 rows of 8 stripes, and a 20-shuffle butterfly per row) that is
// 17 M warp shuffles (about 65 us at one per clock on each of 132 SMs at
// 2 GHz) and 0.79 G f64 operations (24 per stripe and thread; about 47 us
// at 64 per clock and SM), both issued while other warps wait on memory.
//
// Rounding: the class order of each running sum is the stripe order above
// (sequential within a thread, a tree across the warp); the plain version
// sums with torch.cumsum and a tree reduction, so the two agree within the
// reordering bound, not bitwise.  The source builds with -fmad=false
// (kernels/_build.py), so no multiply and add contract into an FMA.
#include <cstdint>
#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 128;          // four warps a block
constexpr unsigned kFull = 0xffffffffu;

// Stripes a thread keeps in registers per pass over a row: 128 bytes of
// values at 16-byte access (N <= 512 in f64, 1,024 in f32 in one pass),
// 16 stripes at scalar access.  Longer rows take several passes; the carry
// runs on, so the order of the sums does not depend on the pass length.
template <typename T, int VEC>
constexpr int kStripes = VEC == 1 ? 16 : 128 / (VEC * (int)sizeof(T));

__device__ __forceinline__ float clip0(float x, float hi) {
  return fminf(fmaxf(x, 0.0f), hi);
}
__device__ __forceinline__ double clip0(double x, double hi) {
  return fmin(fmax(x, 0.0), hi);
}

// 16-byte and scalar accesses: inc and fill stream (ld/st .cs), p is read
// through the read-only path (every row of a lane reads the same p).
__device__ __forceinline__ void load_stream(const double* s, double (&x)[2]) {
  const double2 v = __ldcs(reinterpret_cast<const double2*>(s));
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void load_stream(const float* s, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(s));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_stream(const T* s, T (&x)[1]) {
  x[0] = __ldcs(s);
}
__device__ __forceinline__ void load_ro(const double* s, double (&x)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(s));
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void load_ro(const float* s, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(s));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_ro(const T* s, T (&x)[1]) {
  x[0] = __ldg(s);
}
__device__ __forceinline__ void store_stream(double* d, const double (&x)[2]) {
  __stcs(reinterpret_cast<double2*>(d), make_double2(x[0], x[1]));
}
__device__ __forceinline__ void store_stream(float* d, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(d), make_float4(x[0], x[1], x[2], x[3]));
}
template <typename T>
__device__ __forceinline__ void store_stream(T* d, const T (&x)[1]) {
  __stcs(d, x[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rm_sweep_rows(const T* __restrict__ inc, const T* __restrict__ spare,
              const T* __restrict__ p, T* __restrict__ fill,
              T* __restrict__ sum_fill, T* __restrict__ p_fill, int Nc, int N,
              long long rows) {
  constexpr int kS = 32 * VEC;               // values per stripe
  constexpr int kK = kStripes<T, VEC>;       // stripes per pass
  const int t = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  for (long long row = (long long)blockIdx.x * (kThreads / 32)
                       + (threadIdx.x >> 5);
       row < rows; row += nwarps) {
    const long long b = row / Nc;
    const T* in = inc + row * N;
    T* out = fill + row * N;
    const T* pb = p + b * N;
    const T sp = __ldg(spare + b);
    T carry = 0, sacc = 0, pacc = 0;
    for (int j0 = 0; j0 < N; j0 += kK * kS) {
      T x[kK][VEC];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int j = j0 + k * kS + t * VEC;
        if (j < N) {
          load_stream(in + j, x[k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[k][v] = T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (j0 + k * kS < N) {               // the same for the whole warp
          T s = x[k][0];
#pragma unroll
          for (int v = 1; v < VEC; ++v) s = s + x[k][v];
          T incl = s;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const T y = __shfl_up_sync(kFull, incl, d);
            if (t >= d) incl = incl + y;
          }
          T excl = __shfl_up_sync(kFull, incl, 1);
          if (t == 0) excl = T(0);
          const T total = __shfl_sync(kFull, incl, 31);
          T cum = carry + excl;
          carry = carry + total;
          const int j = j0 + k * kS + t * VEC;
          if (j < N) {
            T pv[VEC];
            load_ro(pb + j, pv);
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const T xv = x[k][v];
              cum = cum + xv;
              const T f = clip0(sp - (cum - xv), xv);
              x[k][v] = f;
              sacc = sacc + f;
              pacc = pacc + f * pv[v];
            }
            store_stream(out + j, x[k]);
          }
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sacc = sacc + __shfl_xor_sync(kFull, sacc, d);
      pacc = pacc + __shfl_xor_sync(kFull, pacc, d);
    }
    if (t == 0) {
      sum_fill[row] = sacc;
      p_fill[row] = pacc;
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <typename T, int VEC>
int launch(const T* inc, const T* spare, const T* p, T* fill, T* sum_fill,
           T* p_fill, int B, int Nc, int N, cudaStream_t stream) {
  if (VEC > 1 && ((long long)N * sizeof(T) % 16 != 0 || !aligned16(inc)
                  || !aligned16(p) || !aligned16(fill))) {
    return (int)cudaErrorMisalignedAddress;
  }
  const long long rows = (long long)B * Nc;
  if (rows > 0) {
    // persistent grid: as many blocks as are resident at once, fewer when
    // the rows run out first
    const long long want = (rows + kThreads / 32 - 1) / (kThreads / 32);
    const long long resident =
        device_fit<rm_sweep_rows<T, VEC>, kThreads>().resident();
    const int grid = (int)(want < resident ? want : resident);
    rm_sweep_rows<T, VEC><<<grid, kThreads, 0, stream>>>(
        inc, spare, p, fill, sum_fill, p_fill, Nc, N, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scalar access: any alignment.
int rm_sweep_f32(const float* inc, const float* spare, const float* p,
                 float* fill, float* sum_fill, float* p_fill, int B, int Nc,
                 int N, cudaStream_t stream) {
  return launch<float, 1>(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N,
                          stream);
}

int rm_sweep_f64(const double* inc, const double* spare, const double* p,
                 double* fill, double* sum_fill, double* p_fill, int B, int Nc,
                 int N, cudaStream_t stream) {
  return launch<double, 1>(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N,
                           stream);
}

// 16-byte access: N * sizeof(T) a multiple of 16 and inc, p and fill on
// 16-byte boundaries, else cudaErrorMisalignedAddress without a launch.
int rm_sweep_v16_f32(const float* inc, const float* spare, const float* p,
                     float* fill, float* sum_fill, float* p_fill, int B,
                     int Nc, int N, cudaStream_t stream) {
  return launch<float, 4>(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N,
                          stream);
}

int rm_sweep_v16_f64(const double* inc, const double* spare, const double* p,
                     double* fill, double* sum_fill, double* p_fill, int B,
                     int Nc, int N, cudaStream_t stream) {
  return launch<double, 2>(inc, spare, p, fill, sum_fill, p_fill, B, Nc, N,
                           stream);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
