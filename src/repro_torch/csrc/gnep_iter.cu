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
// What bounds it.  At the main path's inputs, bytes: the operands are read
// once and the outputs written once (about 6 MB in f64 at 256 lanes of 500
// classes), because the work the inputs need is small (below).  Where every
// candidate price is distinct, FP64 instructions: nine a (candidate, class)
// step, none contracted into an FMA, over up to (n + 2) x n steps a lane.
// Below both lies the floor that the bitwise order sets: a walk is a chain
// of L_b dependent steps (each running sum is added in class order, as the
// plain version adds it), and its nine FP64 instructions a step (two issue
// cycles each for a warp, eight cycles from one dependent add to the next)
// cannot be spread over more threads, so a lane takes at least about 18 L_b
// clocks for its walks however many threads it has, and a replay's cum
// chain about 8 L_b more.
//
// What the design does about each.
//  * Live columns only.  A column with inc_max == 0 (either sign) and a
//    finite p adds +-0 to cum, sacc and pacc, which never hold -0 (they
//    start at +0, and a sum of nonzero values is never -0), so it changes no
//    bit of them.  Padded classes sort last with inc_max = +0 and p = 0, so
//    each lane walks j < L_b = 1 + its last column that is not skippable.
//    A zero-headroom class with an infinite p is walked (0 * inf = NaN).
//  * One walk per distinct price.  obj[b,c] is a function of cand[b,c]'s
//    bits and the lane's data, so candidates with equal bits have
//    bit-equal objectives.  Every candidate with rho_bar[b]'s bits forms one
//    group (the padded slots, column N and, at a cold start, every bid),
//    walked once for its smallest index; every other candidate is walked
//    for itself.  Bits, not values, are compared, so +0 and -0 never merge.
//    For the first-max argmax a group counts at its smallest index, which is
//    where torch.argmax finds the first of equal maxima.
//  * Walks packed into warps.  The walks of a lane are compacted (ballot
//    and a block prefix) into a list, and each pass of 256 gives one walk
//    a thread, so 25 walks fill one warp and not 25 warps' worth of issue
//    slots.  The first 32 go to a warp chosen by blockIdx, so that the two
//    blocks an SM holds issue theirs from different sub-partitions.  A block
//    owns a lane, so the argmax is a block reduction; a persistent grid
//    (occupancy times SMs, queried once per device) walks the lanes.
//  * Pipelined walks.  A warp issues in order, so each walk is
//    software-pipelined over groups of kGroup classes: the cum chain of the
//    next group runs beside the fills and the sacc / pacc chains of this
//    one.  max(x, 0) in f64 is an integer mask of the bits, which keeps the
//    FP64 pipe for the arithmetic.
//  * Staged once.  A lane's (bid, inc_max, p) are staged in shared memory as
//    one 16-byte-aligned record a class (32 bytes in f64: two vector loads a
//    step), in chunks of kChunk classes; a lane with L_b <= kChunk (every
//    lane up to 1,024 classes) stages once, longer ones stage every chunk of
//    every pass.  The list of walks holds kList candidates; longer
//    candidate rows are taken in segments.
//  * Replay without a serial global loop.  Only cum's prefix is an ordered
//    chain: the block admits the winner's increments into the records'
//    fourth slot, thread 0 runs the chain over them in place (its loads
//    issued a group ahead), and then the whole block computes
//    fill = clip(spare - (cum - inc), 0, inc) for every class at once and
//    writes the row coalesced.  Past L_b cum keeps its bits, so the tail is
//    computed from the last prefix.
//  * Replay off the critical path where it can be.  On the main path the
//    rho_bar group wins (its price admits every class), so where a lane's
//    walks leave a warp free, that warp replays the group's chain while the
//    others walk; the replay after the argmax runs only when another price
//    wins.
//  * No early exit.  A walk does not stop when cum reaches spare: rounding
//    in (cum + inc) - inc can bring a later column's fill above 0.
//
// Bitwise contract with the plain torch version (kernels/gnep_iter/ref.py
// fused_middle_reference): the same operations in the same order, each
// rounded on its own.  The build passes -fmad=false so no multiply-add is
// contracted into an FMA.  Ties keep the smaller index, like torch.argmax.
#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // classes staged at once
constexpr int kList = 2048;   // candidates compacted at once
constexpr int kGroup = 8;     // classes a walk takes per pipelined step
constexpr unsigned kFull = 0xffffffffu;

// One staged class: bid, inc_max, p, and the replay's cum prefix.
template <typename T>
struct alignas(4 * sizeof(T)) Col {
  T bid, inc, p, cum;
};

// max(x, 0), in f64 as integer operations on the bits (fewer instructions
// than the FP64 pipe's max): a negative x (-0 too) becomes +0, anything
// else is kept.
__device__ __forceinline__ double relu(double x) {
  const long long v = __double_as_longlong(x);
  return __longlong_as_double(v & ~(v >> 63));
}
__device__ __forceinline__ float relu(float x) {
  return x > 0.0f ? x : 0.0f;
}

// min(max(x, 0), hi): the plain version's clamp and minimum for every x
// that is not NaN, without the NaN handling that fmax and fmin add to
// every step.
template <typename T>
__device__ __forceinline__ T clip0(T x, T hi) {
  const T m = relu(x);
  return m < hi ? m : hi;
}

__device__ __forceinline__ unsigned long long bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ unsigned bits(float x) {
  return (unsigned)__float_as_int(x);
}

// (value, index) pair with first-max order: larger value wins, equal
// values keep the smaller index.
template <typename T>
__device__ __forceinline__ bool beats(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
struct Shared {
  Col<T> col[kChunk];
  int walk[kList];
  int red_a[kWarps], red_b[kWarps];
  T red_v[kWarps];
  T o_group, cum_end;
};

// Block-wide max of a and min of b (every thread gets both).
__device__ __forceinline__ void block_max_min(int& a, int& b, int* sa,
                                              int* sb) {
  a = __reduce_max_sync(kFull, a);
  b = __reduce_min_sync(kFull, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
  for (int w = 1; w < kWarps; ++w) {
    a = max(a, sa[w]);
    b = min(b, sb[w]);
  }
  __syncthreads();
}

// Stage classes [j0, j0 + n) of a lane into shared memory.
template <typename T>
__device__ __forceinline__ void stage(Col<T>* col, const T* bids,
                                      const T* inc, const T* p, int j0,
                                      int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    col[j].bid = bids[j0 + j];
    col[j].inc = inc[j0 + j];
    col[j].p = p[j0 + j];
  }
}

// A group of kGroup classes in one walk: their admitted increments, their p
// and, once chained, cum after each.
template <typename T>
struct Group {
  T inc[kGroup], p[kGroup], c[kGroup];
};

// Load a group of staged classes: admit each (bid >= cv) and take its p.
template <typename T>
__device__ __forceinline__ void admit(const Col<T>* col, T cv, Group<T>& g) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const Col<T> c = col[k];
    g.inc[k] = c.bid >= cv ? c.inc : T(0);
    g.p[k] = c.p;
  }
}

// Advance cum over an admitted group (chain), and fold an earlier chained
// group's fills into sacc and pacc (finish): independent chains, so one
// group's cum adds issue beside the other's fills.
template <typename T>
__device__ __forceinline__ void chain_finish(Group<T>& next, T& cum,
                                             const Group<T>& cur, T sp,
                                             T& sacc, T& pacc) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    next.c[k] = cum = cum + next.inc[k];
    const T f = clip0(sp - (cur.c[k] - cur.inc[k]), cur.inc[k]);
    sacc = sacc + f;
    pacc = pacc + f * cur.p[k];
  }
}

template <typename T>
__device__ __forceinline__ void finish(const Group<T>& cur, T sp, T& sacc,
                                       T& pacc) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const T f = clip0(sp - (cur.c[k] - cur.inc[k]), cur.inc[k]);
    sacc = sacc + f;
    pacc = pacc + f * cur.p[k];
  }
}

// One candidate's walk over n staged classes, continuing cum, sacc and pacc.
// Each running sum is added class by class in order, as the plain version
// adds it.  The walk is software-pipelined over groups of kGroup classes:
// the cum chain of one group issues beside the fills and the sacc / pacc
// chains of the group before it, so that neither waits on the other.
template <typename T>
__device__ __forceinline__ void walk(const Col<T>* col, int n, T cv, T sp,
                                     T& cum, T& sacc, T& pacc) {
  const int groups = n / kGroup;
  int j = 0;
  if (groups >= 2) {
    Group<T> a, b;
    admit(col, cv, a);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) a.c[k] = cum = cum + a.inc[k];
    admit(col + kGroup, cv, b);
    // here a is group q, chained, and b group q + 1, admitted
    int q = 0;
    for (; q + 3 < groups; q += 2) {
      chain_finish(b, cum, a, sp, sacc, pacc);
      admit(col + (q + 2) * kGroup, cv, a);
      chain_finish(a, cum, b, sp, sacc, pacc);
      admit(col + (q + 3) * kGroup, cv, b);
    }
    chain_finish(b, cum, a, sp, sacc, pacc);
    if (q + 2 < groups) {
      admit(col + (q + 2) * kGroup, cv, a);
      chain_finish(a, cum, b, sp, sacc, pacc);
      finish(a, sp, sacc, pacc);
    } else {
      finish(b, sp, sacc, pacc);
    }
    j = groups * kGroup;
  }
  for (; j < n; ++j) {
    const Col<T> k = col[j];
    const T inc = k.bid >= cv ? k.inc : T(0);
    cum = cum + inc;
    const T f = clip0(sp - (cum - inc), inc);
    sacc = sacc + f;
    pacc = pacc + f * k.p;
  }
}

// The running sum of the n values in col[].cum, in order, from cum, written
// back in place; returns the last.  The next group's loads are issued before
// this group's stores, so the chain waits only on its adds.
template <typename T>
__device__ __forceinline__ T prefix(Col<T>* col, int n, T cum) {
  int j = 0;
  if (n >= kGroup) {
    T a[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) a[k] = col[k].cum;
#pragma unroll 1
    for (; j + 2 * kGroup <= n; j += kGroup) {
      T next[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) next[k] = col[j + kGroup + k].cum;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        cum = cum + a[k];
        col[j + k].cum = cum;
        a[k] = next[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      cum = cum + a[k];
      col[j + k].cum = cum;
    }
    j += kGroup;
  }
  for (; j < n; ++j) {
    cum = cum + col[j].cum;
    col[j].cum = cum;
  }
  return cum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_iter_kernel(const T* __restrict__ bids, const T* __restrict__ inc_max,
                  const T* __restrict__ p, const T* __restrict__ cand,
                  const T* __restrict__ spare, const T* __restrict__ rho_bar,
                  const T* __restrict__ sum_r_low,
                  const T* __restrict__ p_r_low, const T* __restrict__ cnst,
                  T* __restrict__ fill_best, T* __restrict__ obj,
                  long long* __restrict__ best, T* __restrict__ rho, int B,
                  int Nc, int N, int sms) {
  __shared__ Shared<T> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The first walks go to warp rot: the blocks that share an SM (blockIdx
  // about sms apart) then issue them from different SM sub-partitions.
  const int rot = (blockIdx.x / sms) % 4;
  const int slot = (tid + kThreads - 32 * rot) % kThreads;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* lane_bids = bids + (size_t)b * N;
    const T* lane_inc = inc_max + (size_t)b * N;
    const T* lane_p = p + (size_t)b * N;
    const T* lane_cand = cand + (size_t)b * Nc;
    T* lane_obj = obj + (size_t)b * Nc;
    const T sp = spare[b], rb = rho_bar[b], srl = sum_r_low[b];
    const T prl = p_r_low[b], cst = cnst[b];
    const auto rb_bits = bits(rb);

    // Stage the first chunk; find the last live class and the smallest
    // candidate index of the rho_bar group.
    int last = -1, first_rb = Nc;
    for (int j = tid; j < N; j += kThreads) {
      const T inc = lane_inc[j], pv = lane_p[j];
      if (j < kChunk) {
        sh.col[j].bid = lane_bids[j];
        sh.col[j].inc = inc;
        sh.col[j].p = pv;
      }
      if (!(inc == T(0) && isfinite(pv))) last = j;
    }
    for (int c = tid; c < Nc; c += kThreads) {
      if (bits(lane_cand[c]) == rb_bits) {
        first_rb = c;
        break;
      }
    }
    block_max_min(last, first_rb, sh.red_a, sh.red_b);
    const int L = last + 1;
    const bool chunked = L > kChunk;

    T my_val = 0;
    int my_idx = -1;  // -1: no candidate yet
    bool spec = false;  // the rho_bar group replayed during the walks
    for (int s0 = 0; s0 < Nc; s0 += kList) {
      const int s1 = min(Nc, s0 + kList);
      // compact the segment's walks: every candidate outside the rho_bar
      // group, and the group's smallest index
      int W = 0;
      for (int c0 = s0; c0 < s1; c0 += kThreads) {
        const int c = c0 + tid;
        const bool walk = c < s1 && (c == first_rb
                                     || bits(lane_cand[c]) != rb_bits);
        const unsigned vote = __ballot_sync(kFull, walk);
        if (lane == 0) sh.red_a[warp] = __popc(vote);
        __syncthreads();
        int base = W, total = 0;
        for (int w = 0; w < kWarps; ++w) {
          base += w < warp ? sh.red_a[w] : 0;
          total += sh.red_a[w];
        }
        if (walk) sh.walk[base + __popc(vote & ((1u << lane) - 1u))] = c;
        W += total;
        __syncthreads();
      }
      // the rho_bar group wins on the main path (its price admits every
      // class): where the walks leave a warp free, it replays the group
      // while the others walk
      if (s0 == 0) {
        spec = !chunked && first_rb < Nc && W <= kThreads - 32;
        if (spec && slot >= kThreads - 32) {
          for (int j = lane; j < L; j += 32) {
            sh.col[j].cum = sh.col[j].bid >= rb ? sh.col[j].inc : T(0);
          }
          __syncwarp();
          if (lane == 0) sh.cum_end = prefix(sh.col, L, T(0));
        }
      }
      for (int w0 = 0; w0 < W; w0 += kThreads) {
        const bool active = w0 + slot < W;
        const int c = active ? sh.walk[w0 + slot] : 0;
        const T cv = active ? lane_cand[c] : T(0);
        T cum = 0, sacc = 0, pacc = 0;
        for (int j0 = 0; j0 < L; j0 += kChunk) {
          const int jn = min(kChunk, L - j0);
          if (chunked) {
            __syncthreads();
            stage(sh.col, lane_bids, lane_inc, lane_p, j0, jn);
            __syncthreads();
          }
          if (active) walk(sh.col, jn, cv, sp, cum, sacc, pacc);
        }
        if (active) {
          const T o = (cv - rb) * (srl + sacc) + (prl + pacc) - cst;
          lane_obj[c] = o;
          if (c == first_rb) sh.o_group = o;
          if (my_idx < 0 || beats(o, c, my_val, my_idx)) {
            my_val = o;
            my_idx = c;
          }
        }
      }
    }

    // first-max argmax across the block: warps by shuffle, then each
    // thread over the warps' winners
    for (int off = 16; off > 0; off >>= 1) {
      const T v = __shfl_down_sync(kFull, my_val, off);
      const int i = __shfl_down_sync(kFull, my_idx, off);
      if (i >= 0 && (my_idx < 0 || beats(v, i, my_val, my_idx))) {
        my_val = v;
        my_idx = i;
      }
    }
    if (lane == 0) {
      sh.red_v[warp] = my_val;
      sh.red_b[warp] = my_idx;
    }
    __syncthreads();
    T bv = sh.red_v[0];
    int bi = sh.red_b[0];
    for (int w = 1; w < kWarps; ++w) {
      if (sh.red_b[w] >= 0 && (bi < 0 || beats(sh.red_v[w], sh.red_b[w],
                                                bv, bi))) {
        bv = sh.red_v[w];
        bi = sh.red_b[w];
      }
    }
    const T r = lane_cand[bi];
    if (tid == 0) {
      best[b] = bi;
      rho[b] = r;
    }
    // the rest of the rho_bar group takes its walk's objective
    if (first_rb < Nc) {
      const T og = sh.o_group;
      for (int c = first_rb + 1 + tid; c < Nc; c += kThreads) {
        if (bits(lane_cand[c]) == rb_bits) lane_obj[c] = og;
      }
    }

    // replay the winner: thread 0 runs cum's prefix, the block the fills;
    // a rho_bar group winner was replayed during the walks
    const bool replayed = spec && bits(r) == rb_bits;
    T* row = fill_best + (size_t)b * N;
    T cum = 0;
    for (int j0 = 0; j0 < L; j0 += kChunk) {
      const int jn = min(kChunk, L - j0);
      if (chunked) {
        __syncthreads();
        stage(sh.col, lane_bids, lane_inc, lane_p, j0, jn);
      }
      __syncthreads();
      if (!replayed) {
        for (int j = tid; j < jn; j += kThreads) {
          sh.col[j].cum = sh.col[j].bid >= r ? sh.col[j].inc : T(0);
        }
        __syncthreads();
        if (tid == 0) cum = prefix(sh.col, jn, cum);
        __syncthreads();
      }
      for (int j = tid; j < jn; j += kThreads) {
        const Col<T>& k = sh.col[j];
        const T inc = k.bid >= r ? k.inc : T(0);
        row[j0 + j] = clip0(sp - (k.cum - inc), inc);
      }
    }
    // past L cum keeps its bits (it adds +-0, and is never -0)
    if (tid == 0 && !replayed) sh.cum_end = cum;
    __syncthreads();
    const T cum_end = sh.cum_end;
    for (int j = L + tid; j < N; j += kThreads) {
      const T inc = lane_bids[j] >= r ? lane_inc[j] : T(0);
      row[j] = clip0(sp - (cum_end - inc), inc);
    }
    __syncthreads();  // shared memory is reused by the next lane
  }
}

template <typename T>
int launch(const T* bids, const T* inc_max, const T* p, const T* cand,
           const T* spare, const T* rho_bar, const T* sum_r_low,
           const T* p_r_low, const T* cnst, T* fill_best, T* obj,
           long long* best, T* rho, int B, int Nc, int N,
           cudaStream_t stream) {
  if (B > 0) {
    // persistent grid: a block a lane, as many as are resident at once
    const Fit fit = device_fit<fused_iter_kernel<T>, kThreads>();
    const long long resident = fit.resident();
    const int grid = (int)(B < resident ? B : resident);
    fused_iter_kernel<T><<<grid, kThreads, 0, stream>>>(
        bids, inc_max, p, cand, spare, rho_bar, sum_r_low, p_r_low, cnst,
        fill_best, obj, best, rho, B, Nc, N, fit.sms);
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
