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
// What bounds it.  At the RWKV6-7B prefill (B 4, T 1024, 64 heads of 64,
// chunk 256, f32) the chunked form does about 13 GFLOP against about 0.34
// GB of operands read and results written: 0.19 ms at the card's f32 rate
// on the CUDA cores, 0.1 ms at its memory rate, 0.076 ms for the three TF32
// products below at the tensor-core rate.  So with the products on the
// tensor cores, bytes bound it.  The three passes below move about 0.59 GB
// (k, v and w are read by the first pass and again by the third, and the
// state scratch goes through the second), and mma.sync issues TF32 at
// about half the dense rate; those are this design's own floors.
//
// Three routes; the wrapper (kernels/rwkv6/kernel.py: route) picks one.
//
// Chunk-parallel (L >= 64, K == V a multiple of 4, operands 16-byte
// aligned: every RWKV6 prefill whose chunk is 64 or more, as 1,024 -> 256
// and 48,000 -> 375).  Three kernels on the stream, in parallel over chunks:
//   1. wkv6_state, one block per (batch, head, chunk).  A first sweep sums
//      w over each 16-row segment, and one thread per channel forms the LW
//      before each 64-row sub-tile (the carry) and LW_end from those sums,
//      adding them in the order the scan below does.  A second sweep scans
//      each sub-tile, takes Z from the scan's own LW of row L / 2, and sums
//      U = K2^T V on the tensor cores, its k and v double-buffered.  U, D =
//      e^{LW_end}, Z and the carries go to scratch that the wrapper
//      allocates.
//   2. wkv6_prefix, one thread per (batch, head, state element): walks the
//      chunks in order, stores the state at each chunk's start over U_c
//      and carries S <- D_c S + U_c, the reference's carry in its order;
//      the last S is the state output.
//   3. wkv6_output, one block per (batch, head, chunk, 64-row sub-tile i),
//      a chunk's sub-tiles adjacent in blockIdx (heaviest first) so that
//      their re-reads of the chunk hit L2.  The bonus term in f32 FMAs,
//      the inter term (r e^{LWp}) S_c, the diagonal product Q_i Kf_i^T
//      masked m < t and times V_i, and the full products Q_i Kf_j^T V_j of
//      every earlier sub-tile j < i, whose k, w and v stream in by
//      cp.async, double-buffered (k and v) across j.  The sub-tile's own
//      loads come in two groups: r, w and k for the elementwise step, then
//      S_c and v for the products.
// An L that is no multiple of 64 (reached at T >= 32,768: 48,000 -> 375,
// 64,000 -> 500) ends each chunk in a ragged sub-tile of L - 64 (nsub - 1)
// rows, nsub = ceil(L / 64): wkv6_state<false, true> and wkv6_output<true>
// bound
// their rows there (zeros past them, which add nothing to a sum and leave
// LW_end equal to the last row's LW), and Z = LW[L / 2] may fall inside a
// segment (375 -> row 11 of segment 11), so it comes from the scan itself.
// The instances at multiples of 64 compile without those bounds.
// The scan (scan_rows): 256 threads, each one channel of a 16-row segment;
// each sums its segment in order, then adds the carry and the totals of the
// earlier segments.  Every kernel starts from the same carry and adds in
// the same order, so a row's LW has the same bits in every block.
// The products are mma.sync m16n8k8 TF32 with f32 accumulators.  A single
// TF32 product keeps 11 bits of each operand and misses the 1e-4 gate by
// 4-5x, so each product is three: a_hi b_hi + a_hi b_lo + a_lo b_hi, with
// hi and lo the top two 11-bit pieces of x (masks, not cvt, which issues at
// a quarter rate), as good as f32 here.  The products go out kind by kind
// over independent accumulators.  The masked A goes from the accumulator to
// the next product's A operand in registers: the k order inside an 8-wide
// step is free, so the accumulator's columns (2q, 2q + 1) serve as k
// (q, q + 4), and V's rows are read in that order.  Exponentials are
// __expf (ex2.approx).  Shared rows are 68 floats (4 mod 32): fragment
// loads are free of bank conflicts and 16-byte cp.async rows stay aligned.
// wkv6_output holds six 64 x 68 tiles (Q, two k and two v buffers, w):
// 106 KB and 128 registers a thread, two blocks an SM.
//
// Tile-parallel (L < 64, the chunk-parallel route's other conditions: every
// RWKV6 prompt whose length is not a multiple of 64, as the 1,023-, 1,000-,
// 1,040- and 992-token prompts' chunks 1, 8, 16, 32, and long prompts'
// chunks that do not divide 64, as 50,000 -> 10).  It replaces the per-head
// kernel below for those chunks, which walked every chunk of a (batch,
// head) in order in one block: B * H blocks, T / L dependent steps each,
// six barriers and unprefetched loads a chunk, and at L < 64 most of its
// threads idle in the products.  Bytes bound the same work here as above
// (about 0.1 ms at the RWKV6-7B prefill), and at L = 1 the walk's
// multiply-adds (2 K V a row) are the most work there is.  The carry S <-
// e^{LW_end} S + K2^T V has no clip, so the carries of the chunks of a tile
// compose, in exact arithmetic, into the tile's own carry.  A tile holds m
// = L (64 / L) rows, whole chunks: 64 where L divides 64, else fewer (63 at
// L = 3, 60 at 10 and 12, L itself from 33 up).  The tiles' carries are
// then the chunk-parallel route's at L = m, and passes 1 and 2 above run on
// ceil(T / m) tiles, the last ragged (T % m rows, a whole number of
// chunks): wkv6_state<true, false>, whose row bounds the chunk-parallel
// instance at multiples of 64 compiles without, and wkv6_prefix<8>, its
// loads 8 tiles ahead of its carries.  Pass 3 is wkv6_tile_output, one
// block per
// (batch, head, tile): B * H * ceil(T / m) blocks, each m / L dependent
// steps from its tile's state.  Inside a chunk it computes what the
// reference does, with the chunk's own Z and clip; between chunks it goes
// through the state only, never through a decay factored across the tile
// (w down to -8 spans e^{512} over 64 rows, past f32).  The chunks' own
// products go to the tensor cores over the whole tile at once, masked to
// one chunk (split TF32, as above); the state walk runs on the CUDA cores,
// its state in registers, four rows at a time and no barrier, since below
// 16 rows a chunk fills no m16n8k8 tile (and L = 1, every odd prompt
// length, is the commonest chunk).  The walk's 2 K V multiply-adds a row,
// with the shared loads and shuffles that feed them, are the output pass's
// largest part (scripts/attribute_wkv6_tile.py).  Its scratch is the
// tiles' U and D only: (B, H, ceil(T / m), K, K), never a state per chunk
// (4.3 GB at L = 1 and (4, 1023, 64, 64)).
//
// Per-head (other widths: K != V, K no multiple of 4, or an operand off a
// 16-byte boundary; and the route the others are held to on the card):
// wkv6_kernel, the CUDA-core kernel of the first port.  The Pallas
// kernel keeps the K x V state in VMEM scratch over a
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
#include <cstdint>

#include "wkv6.cuh"

namespace {

constexpr int kLD = kTS + 1;  // padded row of the (row x channel) tiles

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


// --------------------------------------------------------------------------
// the chunk-parallel route: wkv6_state, wkv6_prefix, wkv6_output (their
// shared pieces in wkv6.cuh)
// --------------------------------------------------------------------------

// Pass 1: one block per (batch, head, chunk).  A first sweep sums each
// 16-row segment of w, from which one thread per channel forms the carries,
// Z and LW_end by the scan's own additions; a second sweep scans each
// sub-tile and sums U = K2^T V, its k and v double-buffered.  kRagged: L
// is no multiple of 64, and the chunk's last sub-tile has L - 64 (nsub - 1)
// rows (zeros past them); Z = LW[L / 2] may then fall inside a segment
// (375 -> row 11 of segment 11), so sweep 2 takes it from the scan of the
// thread whose segment holds that row.  kTiles: the tile-parallel route's
// tiles of L = m <= 64 rows, one sub-tile each, the last of which may be
// ragged (T % m rows: zeros past them); no carries or Z.  The instance at
// multiples of 64 compiles without those bounds.
template <bool kTiles, bool kRagged>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_state(const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ w, float* __restrict__ U,
           float* __restrict__ carry_out, float* __restrict__ Z_out,
           float* __restrict__ D_out, int T, int H, int K, int L) {
  extern __shared__ float smem[];
  float* seg_sum = smem + 4 * kTile;    // 4 x 64
  float* run = seg_sum + 4 * kTS;       // LW before the current sub-tile
  float* lwe = run + kTS;               // LW_end
  float* tot = lwe + kTS;               // segment totals, 4 nsub x 64
  // k (then K2 = k e^{LW_end - LW}) in buffer 2x, v in 2x + 1
  auto buf = [&](int x) { return smem + x * kTile; };

  const int n = kTiles ? (T + L - 1) / L : T / L;
  const int nsub = kTiles ? 1 : kRagged ? (L + kTS - 1) / kTS : L / kTS;
  const int c = blockIdx.x % n, bh = blockIdx.x / n;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, seg = tid >> 6, ch = tid & 63;
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)c * L) * row
                         + (long long)h * K;
  const long long chunk = (long long)bh * n + c;
  const int rows = kTiles ? min(L, T - c * L) : kTS;     // of sub-tile 0
  const int last = kRagged ? L - (nsub - 1) * kTS : kTS;  // of the last

  if (K < kTS || rows < kTS) zero_smem(smem, 4 * kTile);
  __syncthreads();
  load_tile(buf(0), k + base, row, rows, K);  // sweep 2's first tiles
  load_tile(buf(1), v + base, row, rows, K);
  cp_commit();

  float wv[kSeg], wn[kSeg], lw[kSeg];
  for (int s = 0; s < nsub; ++s) {             // sweep 1
    load_w(wv, w + base + (long long)s * kTS * row, row, K,
           kRagged && s == nsub - 1 ? last : rows);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kSeg; ++t) sum += wv[t];
    tot[(s * 4 + seg) * kTS + ch] = sum;
  }
  __syncthreads();
  if (tid < kTS) {
    // the carries as scan_rows forms them: LW after sub-tile s is
    // (((carry + t0) + t1) + t2) + t3 (a ragged sub-tile's empty segments
    // add zeros, so LW_end is LW of the chunk's last row); at a multiple of
    // 64, Z = LW[L / 2], the first row of its segment, is that segment's
    // base plus w of the row
    const int zseg = L / 2 / kSeg;
    float carry = 0.0f;
    for (int s = 0; s < nsub; ++s) {
      if (!kTiles && tid < K) carry_out[(chunk * nsub + s) * K + tid] = carry;
      for (int sg = 0; sg < 4; ++sg) {
        if (!kTiles && !kRagged && s * 4 + sg == zseg && tid < K)
          Z_out[chunk * K + tid] =
              carry + w[base + (long long)(L / 2) * row + tid];
        carry += tot[(s * 4 + sg) * kTS + tid];
      }
    }
    lwe[tid] = carry;
    if (tid < K) D_out[chunk * K + tid] = expf(carry);
    run[tid] = 0.0f;
  }
  load_w(wv, w + base, row, K, rows);

  // sweep 2.  Warp wp owns state rows 16 (wp % 4) .. + 15 and columns
  // 32 (wp / 4) .. + 31.
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.0f;
  for (int s = 0; s < nsub; ++s) {
    const int bs = s & 1;
    __syncthreads();                           // the other buffers are free
    if (s + 1 < nsub) {
      const long long off = base + (long long)(s + 1) * kTS * row;
      const int rn = kRagged && s + 2 == nsub ? last : kTS;
      load_tile(buf(2 - 2 * bs), k + off, row, rn, K);
      load_tile(buf(3 - 2 * bs), v + off, row, rn, K);
      if (kRagged && rn < kTS) {               // the ragged last sub-tile
        zero_rows(buf(2 - 2 * bs), rn);
        zero_rows(buf(3 - 2 * bs), rn);
      }
      load_w(wn, w + off, row, K, rn);
    }
    cp_commit();
    scan_rows(wv, seg_sum, run[ch], lw);
    if (kRagged && s == L / 2 / kTS && seg == L / 2 % kTS / kSeg && ch < K) {
      const int zrow = L / 2 % kSeg;
      float z = lw[0];
#pragma unroll
      for (int t = 1; t < kSeg; ++t) z = t == zrow ? lw[t] : z;
      Z_out[chunk * K + ch] = z;
    }
    cp_wait<1>();
    __syncthreads();
    float* Ks = buf(2 * bs);
    const float* Vs = buf(2 * bs + 1);
    if (ch < K) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float* p = Ks + (seg * kSeg + t) * kLDT + ch;
        *p = *p * __expf(lwe[ch] - lw[t]);
      }
    }
    __syncthreads();
    if (seg == 3) run[ch] = lw[kSeg - 1];
    if (s + 1 < nsub) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) wv[t] = wn[t];
    }
#pragma unroll
    for (int ks = 0; ks < kTS / 8; ++ks) {
      const float* kr = Ks + (8 * ks + q) * kLDT + m0 + g;   // A = K2^T
      const float a[4] = {kr[0], kr[8], kr[4 * kLDT], kr[4 * kLDT + 8]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      const float* vr = Vs + (8 * ks + q) * kLDT + n0 + g;
      float bb[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bb[nt][0] = vr[8 * nt];
        bb[nt][1] = vr[4 * kLDT + 8 * nt];
      }
      mma3<4>(acc, ah, al, bb);
    }
  }
  float* Ub = U + chunk * K * K;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + 8 * nt + 2 * q;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kk = m0 + g + 8 * (x >> 1), vv = col + (x & 1);
      if (kk < K && vv < K) Ub[kk * K + vv] = acc[nt][x];
    }
  }
}

// Pass 2: one thread per (batch, head, state element), the chunks in order,
// the loads of kAhead chunks issued before their carries: the chain of
// carries waits on device memory once every kAhead chunks (the
// tile-parallel route's 8; the chunk-parallel route's few chunks keep 1).
template <int kAhead>
__global__ void __launch_bounds__(kThreads)
wkv6_prefix(float* __restrict__ U, const float* __restrict__ D,
            const float* __restrict__ S0, float* __restrict__ S_out, int BH,
            int n, int K) {
  const long long KV = (long long)K * K;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BH * KV) return;
  const long long bh = idx / KV, e = idx % KV;
  const int kk = (int)(e / K);
  float s = S0 ? S0[idx] : 0.0f;
  for (int c0 = 0; c0 < n; c0 += kAhead) {
    float uc[kAhead], dc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long chunk = bh * n + c0 + j;
      if (c0 + j < n) {
        uc[j] = U[chunk * KV + e];
        dc[j] = D[chunk * K + kk];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < n) {
        U[(bh * n + c0 + j) * KV + e] = s;   // the state at the chunk's start
        s = dc[j] * s + uc[j];
      }
    }
  }
  S_out[idx] = s;
}

// Rows visited in order: c0, the first row of the previous row's chunk,
// becomes row i's; true where row i starts its chunk.
template <bool kPow2>
__device__ __forceinline__ bool next_row(int i, int L, int& c0) {
  if (kPow2)
    c0 = i & -L;
  else if (i == c0 + L)
    c0 = i;
  return c0 == i;
}

// y[16 rows of warp rg] += A V, A = Q Kf^T over the 32 key rows of half hf
// (masked m < t when diag), both from shared tiles of one 64-row sub-tile.
// L < 64 cuts the sub-tile into chunks of L rows from row 0, and a diagonal
// A keeps only the pairs inside one chunk: m at or past the first row of
// t's chunk (chunk_start).  At the default L = 64 (a constant) those tests
// fold away.
template <bool kPow2 = true>
__device__ __forceinline__ void attend(const float* Qs, const float* Kf,
                                       const float* Vt, float (*acc)[4],
                                       bool diag, int L = kTS) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int t0 = 16 * (warp & 3), m0 = 32 * (warp >> 2);
  const bool chunks = L < kTS;
  // every m > every t, or every m before the chunk of row t0: A = 0
  if (diag && (t0 + 15 < m0 ||
               (chunks && m0 + 31 < chunk_start<kPow2>(t0, L))))
    return;
  float a[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[nt][x] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kTS / 8; ++ks) {
    const float* qr = Qs + (t0 + g) * kLDT + 8 * ks + q;
    const float qa[4] = {qr[0], qr[8 * kLDT], qr[4], qr[8 * kLDT + 4]};
    uint32_t qh[4], ql[4];
    split4(qa, qh, ql);
    const float* kr = Kf + (m0 + g) * kLDT + 8 * ks + q;
    float bb[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bb[nt][0] = kr[8 * nt * kLDT];
      bb[nt][1] = kr[8 * nt * kLDT + 4];
    }
    mma3<4>(a, qh, ql, bb);
  }
  if (diag) {
    // the first rows of the chunks of rows t0 + g and t0 + g + 8
    const int t = t0 + g, c0 = chunks ? chunk_start<kPow2>(t, L) : 0;
    const int c8 = chunks ? chunk_start<kPow2>(t + 8, L) : 0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + 8 * nt + 2 * q;
      if (!(m < t && (!chunks || m >= c0))) a[nt][0] = 0.0f;
      if (!(m + 1 < t && (!chunks || m + 1 >= c0))) a[nt][1] = 0.0f;
      if (!(m < t + 8 && (!chunks || m >= c8))) a[nt][2] = 0.0f;
      if (!(m + 1 < t + 8 && (!chunks || m + 1 >= c8))) a[nt][3] = 0.0f;
    }
  }
  // k step nt covers key rows m0 + 8 nt .. + 7, k index q <-> row 2q and
  // q + 4 <-> row 2q + 1: then the accumulator is the A fragment
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float fa[4] = {a[nt][0], a[nt][2], a[nt][1], a[nt][3]};
    uint32_t ah[4], al[4];
    split4(fa, ah, al);
    const float* vr = Vt + (m0 + 8 * nt + 2 * q) * kLDT + g;
    float bb[kTS / 8][2];
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt) {
      bb[vt][0] = vr[8 * vt];
      bb[vt][1] = vr[kLDT + 8 * vt];
    }
    mma3<kTS / 8>(acc, ah, al, bb);
  }
}

// Ys <- the sum of the two halves' accumulators of attend (warp wp's rows
// 16 (wp % 4) .. + 15, all columns), once every warp is done reading Ys.
__device__ __forceinline__ void sum_halves(float* Ys, const float (*acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, t0w = 16 * (warp & 3);
  __syncthreads();
#pragma unroll
  for (int hf = 1; hf >= 0; --hf) {
    if (warp >> 2 == hf) {
#pragma unroll
      for (int vt = 0; vt < kTS / 8; ++vt) {
        float* o = Ys + (t0w + g) * kLDT + 8 * vt + 2 * q;
        const float* a = acc[vt];
        if (hf) {
          o[0] = a[0];
          o[1] = a[1];
          o[8 * kLDT] = a[2];
          o[8 * kLDT + 1] = a[3];
        } else {
          o[0] += a[0];
          o[1] += a[1];
          o[8 * kLDT] += a[2];
          o[8 * kLDT + 1] += a[3];
        }
      }
    }
    __syncthreads();
  }
}

// Pass 3: one block per (batch, head, chunk, 64-row sub-tile).  Warp wp
// owns output rows 16 (wp % 4) .. + 15, all columns, and sums over half
// wp / 4 of every contraction (key rows, state rows); the halves are added
// at the end.  kBounded: L is no multiple of 64, and the chunk's last
// sub-tile has L - 64 (nsub - 1) rows (zeros past them in every tile that
// holds it); the earlier sub-tiles it reads are whole.
template <bool kBounded>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_output(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ Sc,
            const float* __restrict__ carry_in, const float* __restrict__ Z_in,
            float* __restrict__ y, int T, int H, int K, int L) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // r, then Q; the output at the end
  float* Ws = Qs + 5 * kTile;           // w of the sub-tile in flight
  float* seg_sum = Ws + kTile;
  float* Zs = seg_sum + 4 * kTS;
  float* us = Zs + kTS;
  float* diag = us + kTS;
  // two k buffers (k, then Kf; S_c in the second at first) and two v
  // buffers (r e^{LWp} in the second at first)
  auto kbuf = [&](int x) { return Qs + (1 + x) * kTile; };
  auto vbuf = [&](int x) { return Qs + (3 + x) * kTile; };

  const int n = T / L, nsub = kBounded ? (L + kTS - 1) / kTS : L / kTS;
  const int i = nsub - 1 - (int)(blockIdx.x % nsub);
  const int rows = kBounded ? min(kTS, L - i * kTS) : kTS;   // of sub-tile i
  const int c = (blockIdx.x / nsub) % n, bh = blockIdx.x / nsub / n;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, seg = tid >> 6, ch = tid & 63;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int t0w = 16 * (warp & 3), hf = warp >> 2;
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)c * L) * row
                         + (long long)h * K;
  const long long chunk = (long long)bh * n + c;
  const float* carry = carry_in + chunk * nsub * K;
  const long long off_i = base + (long long)i * kTS * row;

  if (K < kTS || rows < kTS) zero_smem(smem, 6 * kTile);
  const float zc = ch < K ? Z_in[chunk * K + ch] : 0.0f;
  float carry_next = ch < K ? carry[i * K + ch] : 0.0f;
  if (tid < kTS) {
    Zs[tid] = zc;
    us[tid] = tid < K ? u[(long long)h * K + tid] : 0.0f;
  }
  __syncthreads();
  load_tile(Qs, r + off_i, row, rows, K);  // group 1: elementwise
  load_tile(Ws, w + off_i, row, rows, K);
  load_tile(kbuf(0), k + off_i, row, rows, K);
  cp_commit();
  load_tile(kbuf(1), Sc + chunk * K * K, K, K, K);  // group 2: products
  load_tile(vbuf(0), v + off_i, row, rows, K);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  float wv[kSeg], lw[kSeg];
#pragma unroll
  for (int t = 0; t < kSeg; ++t) wv[t] = Ws[(seg * kSeg + t) * kLDT + ch];
  scan_rows(wv, seg_sum, carry_next, lw);
  if (i > 0) carry_next = ch < K ? carry[ch] : 0.0f;
  for (int t = warp * 8; t < warp * 8 + 8; ++t) {   // sum_k r u k
    float p = 0.0f;
    for (int kk = lane; kk < K; kk += 32)
      p += Qs[t * kLDT + kk] * us[kk] * kbuf(0)[t * kLDT + kk];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) diag[t] = p;
  }
  __syncthreads();
  if (ch < K) {
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const int e = (seg * kSeg + t) * kLDT + ch;
      const float lwp = lw[t] - wv[t], rr = Qs[e];
      Qs[e] = rr * fast_clamp_exp(lwp - zc);
      vbuf(1)[e] = rr * __expf(lwp);
      kbuf(0)[e] = kbuf(0)[e] * fast_clamp_exp(zc - lw[t]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  float acc[kTS / 8][4];
#pragma unroll
  for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[vt][x] = 0.0f;
  // the inter term (r e^{LWp}) S_c over state rows 32 hf .. + 31
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k0 = 32 * hf + 8 * ks;
    const float* rr = vbuf(1) + (t0w + g) * kLDT + k0 + q;
    const float ra[4] = {rr[0], rr[8 * kLDT], rr[4], rr[8 * kLDT + 4]};
    uint32_t rh[4], rl[4];
    split4(ra, rh, rl);
    const float* sr = kbuf(1) + (k0 + q) * kLDT + g;
    float bb[kTS / 8][2];
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt) {
      bb[vt][0] = sr[8 * vt];
      bb[vt][1] = sr[4 * kLDT + 8 * vt];
    }
    mma3<kTS / 8>(acc, rh, rl, bb);
  }
  if (hf == 0) {                        // the bonus term, once
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = t0w + g + 8 * (x >> 1), vv = 8 * vt + 2 * q + (x & 1);
        acc[vt][x] += diag[t] * vbuf(0)[t * kLDT + vv];
      }
  }
  __syncthreads();                      // kbuf(1), vbuf(1) and Ws are free
  if (i > 0) {
    load_tile(Ws, w + base, row, kTS, K);
    load_tile(kbuf(1), k + base, row, kTS, K);
    load_tile(vbuf(1), v + base, row, kTS, K);
    cp_commit();
  }
  attend(Qs, kbuf(0), vbuf(0), acc, true);

  for (int j = 0; j < i; ++j) {
    const int bj = (j + 1) & 1;
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSeg; ++t) wv[t] = Ws[(seg * kSeg + t) * kLDT + ch];
    scan_rows(wv, seg_sum, carry_next, lw);
    if (j + 1 < i) carry_next = ch < K ? carry[(j + 1) * K + ch] : 0.0f;
    if (ch < K) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float* p = kbuf(bj) + (seg * kSeg + t) * kLDT + ch;
        *p = *p * fast_clamp_exp(zc - lw[t]);
      }
    }
    __syncthreads();                    // Kf ready; Ws and the other set free
    if (j + 1 < i) {
      const long long off = base + (long long)(j + 1) * kTS * row;
      load_tile(Ws, w + off, row, kTS, K);
      load_tile(kbuf(bj ^ 1), k + off, row, kTS, K);
      load_tile(vbuf(bj ^ 1), v + off, row, kTS, K);
      cp_commit();
    }
    attend(Qs, kbuf(bj), vbuf(bj), acc, false);
  }

  // add the two halves in Qs and write the sub-tile's rows out
  sum_halves(Qs, acc);
  const int per_row = K >> 2;
  for (int idx = tid; idx < rows * per_row; idx += kThreads) {
    const int t = idx / per_row, cc = (idx % per_row) * 4;
    *reinterpret_cast<float4*>(y + off_i + (long long)t * row + cc) =
        *reinterpret_cast<const float4*>(Qs + t * kLDT + cc);
  }
}

// Step 4 of wkv6_tile_output, the walk over the tile's first ``rows`` rows
// in chunks of L from row 0.  Thread (warp, lane) holds the 4 x 4 block s
// of the state at rows 4 kg (kg = lane % 16) and columns 4 vg (vg = 2 warp
// + lane / 16).  Four rows at a time: for each row t it forms its share of
// R_t S_c over its 4 state rows, sums K2_t^T v_t into up, and at a
// chunk's last row sets s <- e^{LW_end} s + up; then a reduce-scatter over
// the 16 lanes of kg (15 shuffles, one order) leaves lane kg the sum for
// row kg / 4, column 4 vg + kg % 4 of the group, which it adds, with
// the bonus term, into Ys.  Rows past ``rows`` (zeros) change nothing that
// is stored.
template <bool kPow2>
__device__ __forceinline__ void walk_tile(const float* Rs, const float* K2,
                                          const float* Vs, const float* Ws,
                                          const float* diag, float* Ys,
                                          float (*s)[4], int rows, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane & 15, vg = 2 * warp + (lane >> 4);
  float up[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) up[a][i] = 0.0f;
  int end = L;                          // one past the chunk's last row
  for (int t0 = 0; t0 < rows; t0 += 4) {
    float x[16];                        // x[4 r + i]: row t0 + r, col i
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int t = t0 + rr;
      const float4 ra =
          *reinterpret_cast<const float4*>(Rs + t * kLDT + 4 * kg);
      const float4 ka =
          *reinterpret_cast<const float4*>(K2 + t * kLDT + 4 * kg);
      const float4 va =
          *reinterpret_cast<const float4*>(Vs + t * kLDT + 4 * vg);
      const float rv[4] = {ra.x, ra.y, ra.z, ra.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float vt[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = rv[0] * s[0][i];
#pragma unroll
        for (int a = 1; a < 4; ++a) p = fmaf(rv[a], s[a][i], p);
        x[4 * rr + i] = p;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) up[a][i] = fmaf(kv[a], vt[i], up[a][i]);
      // the chunk's last row: a mask where L is a power of two, else the
      // running end
      if (kPow2 ? ((t + 1) & (L - 1)) == 0 : t + 1 == end) {
        if (!kPow2) end += L;
        const float4 da =
            *reinterpret_cast<const float4*>(Ws + t * kLDT + 4 * kg);
        const float dv[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[a][i] = fmaf(dv[a], s[a][i], up[a][i]);
            up[a][i] = 0.0f;
          }
      }
    }
    halve<8>(x, lane);
    halve<4>(x, lane);
    halve<2>(x, lane);
    halve<1>(x, lane);
    const int t = t0 + (kg >> 2), col = 4 * vg + (kg & 3);
    Ys[t * kLDT + col] += x[0] + diag[t] * Vs[t * kLDT + col];
  }
}

// Pass 3 of the tile-parallel route: one block per (batch, head, tile of m
// = L (64 / L) rows: 64 where L divides 64, else the whole chunks that fit),
// whose chunks of L rows it walks in order from the state at the tile's
// start, S_tile (the prefix pass's, over U).
//   1. r, k, w and v of the tile by cp.async (zeros past its rows: past m,
//      and past a ragged last tile's), S_tile into registers, the bonus
//      sum_k r u k of each row.
//   2. LW inside each chunk (thread (seg, ch) sums its 16 rows in order
//      from 0 at each chunk's first row; where a chunk starts in an earlier
//      segment, the rows of it in this one add the tails of the segments
//      since, in order), then Q, Kf with the chunk's own Z = LW[L / 2] and
//      the clip, R = r e^{LWp} and K2 = k e^{LW_end - LW}, and e^{LW_end}
//      at each chunk's last row.
//   3. The chunks' own products Q Kf^T, masked to m < t inside a chunk,
//      times V, on the tensor cores (attend, split TF32) over the whole
//      tile at once: they do not read the state.
//   4. The walk (walk_tile), on the CUDA cores, no barrier inside it.
// tile_m: m as wkv6_tiled_f32 forms it.  kPow2: L divides 64, the tile is
// 64 rows and a chunk's rows are found by masks; else by division once and
// by steps of L.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_tile_output(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ St,
                 float* __restrict__ y, int T, int H, int K, int L,
                 int tile_m) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // r, then Q; then y
  float* Ks = Qs + kTile;               // k, then Kf
  float* Vs = Ks + kTile;               // v
  float* Ws = Vs + kTile;               // w, then LW; then e^{LW_end} at
                                        // each chunk's last row
  float* Rs = Ws + kTile;               // r e^{LWp}
  float* K2 = Rs + kTile;               // k e^{LW_end - LW}
  float* seg_sum = K2 + kTile;
  float* us = seg_sum + 4 * kTS;
  float* diag = us + kTS;

  const int m = kPow2 ? kTS : tile_m, n = (T + m - 1) / m;  // 64 if kPow2
  const int tile = blockIdx.x % n, bh = blockIdx.x / n;
  const int h = bh % H, b = bh / H;
  const int rows = min(m, T - tile * m);       // a multiple of L
  const int tid = threadIdx.x, seg = tid >> 6, ch = tid & 63;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)tile * m) * row
                         + (long long)h * K;

  if (K < kTS || rows < kTS) zero_smem(smem, 4 * kTile);
  if (tid < kTS) us[tid] = tid < K ? u[(long long)h * K + tid] : 0.0f;
  __syncthreads();
  load_tile(Qs, r + base, row, rows, K);
  load_tile(Ks, k + base, row, rows, K);
  load_tile(Ws, w + base, row, rows, K);
  cp_commit();
  load_tile(Vs, v + base, row, rows, K);
  cp_commit();

  const int kg = lane & 15, vg = 2 * warp + (lane >> 4);
  const float* Sb = St + ((long long)bh * n + tile) * K * K;
  float st[4][4];                       // S[4 kg + a][4 vg + i]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 sa = 4 * kg + a < K && 4 * vg < K
        ? *reinterpret_cast<const float4*>(Sb + (4 * kg + a) * K + 4 * vg)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    st[a][0] = sa.x;
    st[a][1] = sa.y;
    st[a][2] = sa.z;
    st[a][3] = sa.w;
  }
  cp_wait<1>();
  __syncthreads();

  for (int t = warp * 8; t < warp * 8 + 8; ++t) {   // sum_k r u k
    float p = 0.0f;
    for (int kk = lane; kk < K; kk += 32)
      p += Qs[t * kLDT + kk] * us[kk] * Ks[t * kLDT + kk];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) diag[t] = p;
  }
  // the first row of the chunk of the segment's first row, i0
  const int i0 = seg * kSeg, first = chunk_start<kPow2>(i0, L);
  float wv[kSeg], lw[kSeg], run = 0.0f;
  int c0 = first;                       // the first row of row i's chunk
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    wv[t] = Ws[(i0 + t) * kLDT + ch];
    if (next_row<kPow2>(i0 + t, L, c0)) run = 0.0f;
    run += wv[t];
    lw[t] = run;
  }
  if (kPow2 ? L > kSeg : kSeg % L != 0) {   // chunks cross segments
    seg_sum[seg * kTS + ch] = run;
    __syncthreads();
    float carry = 0.0f;
    for (int sg = first / kSeg; sg < seg; ++sg)
      carry += seg_sum[sg * kTS + ch];
#pragma unroll
    for (int t = 0; t < kSeg; ++t)
      if (kPow2 || i0 + t < first + L) lw[t] = carry + lw[t];
  }
#pragma unroll
  for (int t = 0; t < kSeg; ++t) Ws[(i0 + t) * kLDT + ch] = lw[t];
  __syncthreads();                      // LW whole; the bonus has read r, k
  c0 = first;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    const int i = i0 + t, e = i * kLDT + ch;
    next_row<kPow2>(i, L, c0);
    // rows past m (zeros) read their tile's last row for a chunk's Z and
    // LW_end beyond it: finite, and r and k are 0 there
    const int zr = c0 + L / 2, er = c0 + L - 1;
    const float z = Ws[(kPow2 ? zr : min(zr, kTS - 1)) * kLDT + ch];
    const float lwe = Ws[(kPow2 ? er : min(er, kTS - 1)) * kLDT + ch];
    const float lwp = lw[t] - wv[t], rr = Qs[e], kv = Ks[e];
    Qs[e] = rr * fast_clamp_exp(lwp - z);
    Rs[e] = rr * __expf(lwp);
    Ks[e] = kv * fast_clamp_exp(z - lw[t]);
    K2[e] = kv * __expf(lwe - lw[t]);  // exponent <= 0
  }
  __syncthreads();                      // every Z and LW_end is read
  c0 = first;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    const int i = i0 + t;
    next_row<kPow2>(i, L, c0);
    if (i == c0 + L - 1) Ws[i * kLDT + ch] = __expf(lw[t]);
  }
  cp_wait<0>();
  __syncthreads();

  // the chunks' own products; then their two halves' sums into Qs
  float acc[kTS / 8][4];
#pragma unroll
  for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[vt][x] = 0.0f;
  if (L > 1) attend<kPow2>(Qs, Ks, Vs, acc, true, L);
  sum_halves(Qs, acc);

  walk_tile<kPow2>(Rs, K2, Vs, Ws, diag, Qs, st, rows, L);
  __syncthreads();
  const int per_row = K >> 2;
  for (int idx = tid; idx < rows * per_row; idx += kThreads) {
    const int t = idx / per_row, cc = (idx % per_row) * 4;
    *reinterpret_cast<float4*>(y + base + (long long)t * row + cc) =
        *reinterpret_cast<const float4*>(Qs + t * kLDT + cc);
  }
}

size_t state_smem(int L) {
  const size_t nsub = (L + kTS - 1) / kTS;
  return sizeof(float) * (4 * kTile + 6 * kTS + nsub * 4 * kTS);
}
constexpr size_t kOutputSmem = sizeof(float) * (6 * kTile + 7 * kTS);
constexpr size_t kTileOutputSmem = sizeof(float) * (6 * kTile + 6 * kTS);

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// The per-head route: any L that divides T.
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

// The chunk-parallel route: L >= 64 divides T.  U (B, H, T / L, K, K),
// carry (B, H, T / L, ceil(L / 64), K), Z and D (B, H, T / L, K) are the
// wrapper's scratch.  passes is a mask of the kernels to launch (1 state, 2
// prefix, 4 output): 7 for a call, one bit to time one kernel alone.  An L
// that is no multiple of 64 runs the row-bounded instances.
int wkv6_chunked_f32(const float* r, const float* k, const float* v,
                     const float* w, const float* u, const float* S0,
                     float* y, float* S, float* U, float* carry, float* Z,
                     float* D, int B, int T, int H, int K, int L, int passes,
                     cudaStream_t stream) {
  if (K < 4 || K > kTS || K % 4 != 0 || L < kTS || T % L != 0 ||
      state_smem(L) > 232448 || !aligned16(r) ||
      !aligned16(k) || !aligned16(v) || !aligned16(w) || !aligned16(y) ||
      !aligned16(U))
    return (int)cudaErrorInvalidValue;
  const int n = T / L, nsub = (L + kTS - 1) / kTS, BH = B * H;
  const bool ragged = L % kTS != 0;
  cudaError_t err;
  if (passes & 1) {
    const size_t smem = state_smem(L);
    const auto state = ragged ? &wkv6_state<false, true>
                              : &wkv6_state<false, false>;
    err = cudaFuncSetAttribute(state,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    state<<<BH * n, kThreads, smem, stream>>>(k, v, w, U, carry, Z, D, T, H,
                                              K, L);
  }
  if (passes & 2) {
    const long long total = (long long)BH * K * K;
    wkv6_prefix<1><<<(int)((total + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(U, D, S0, S, BH, n, K);
  }
  if (passes & 4) {
    const auto output = ragged ? &wkv6_output<true> : &wkv6_output<false>;
    err = cudaFuncSetAttribute(output,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kOutputSmem);
    if (err != cudaSuccess) return (int)err;
    output<<<BH * n * nsub, kThreads, kOutputSmem, stream>>>(
        r, k, v, w, u, U, carry, Z, y, T, H, K, L);
  }
  return (int)cudaGetLastError();
}

// The tile-parallel route: L <= 64 divides T; tiles of m = L (64 / L) rows,
// whole chunks (64 where L divides 64).  U (B, H, ceil(T / m), K, K) and D
// (B, H, ceil(T / m), K) are the wrapper's scratch; passes as for
// wkv6_chunked_f32 (1 state, 2 prefix, 4 output).
int wkv6_tiled_f32(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* S0, float* y,
                   float* S, float* U, float* D, int B, int T, int H, int K,
                   int L, int passes, cudaStream_t stream) {
  if (K < 4 || K > kTS || K % 4 != 0 || L < 1 || L > kTS || T < 1 ||
      T % L != 0 || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
      !aligned16(w) || !aligned16(y) || !aligned16(U))
    return (int)cudaErrorInvalidValue;
  const int m = L * (kTS / L), n = (T + m - 1) / m, BH = B * H;
  cudaError_t err;
  if (passes & 1) {
    const size_t smem = state_smem(kTS);
    err = cudaFuncSetAttribute(wkv6_state<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    wkv6_state<true, false><<<BH * n, kThreads, smem, stream>>>(
        k, v, w, U, nullptr, nullptr, D, T, H, K, m);
  }
  if (passes & 2) {
    const long long total = (long long)BH * K * K;
    wkv6_prefix<8><<<(int)((total + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(U, D, S0, S, BH, n, K);
  }
  if (passes & 4) {
    const auto output = kTS % L == 0 ? &wkv6_tile_output<true>
                                     : &wkv6_tile_output<false>;
    err = cudaFuncSetAttribute(output,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kTileOutputSmem);
    if (err != cudaSuccess) return (int)err;
    output<<<BH * n, kThreads, kTileOutputSmem, stream>>>(
        r, k, v, w, u, U, y, T, H, K, L, m);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
