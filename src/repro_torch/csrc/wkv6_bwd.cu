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
// du sums ddiag r k over the rows: the kernels write its (batch, head)
// partials, and the wrapper adds the batches in order.  All of it in f32.
// Every sum runs in a fixed order, nothing is added atomically, so two
// calls give the same bits.
//
// What bounds it.  At the RWKV6-7B train shape (B 2, T 1024, 64 heads of
// 64, chunk 256, with S0 and dS) the function does ten products a chunk
// (five strictly lower intra-chunk ones, five of the rows with a K x V
// state): 0.10 ms at the tensor cores' TF32 rate with each product split
// in three, against 0.097 ms for its bytes (operands, gradients and the
// state scratch at 3.35 TB/s), and about 0.75 ms in f32 FMAs on the CUDA
// cores.  So the products go to the tensor cores, and the chunks, which
// the TPU kernel walks in order, run in parallel: the one sequential carry
// left is a K x V reverse prefix over the chunks, as the forward's prefix.
// This design's own floors: each pair of sub-tiles' dA is formed twice (by
// the sub-tile that takes dQ and by the one that takes dKf: six products a
// pair against the function's five), and mma.sync issues TF32 at about half
// the dense rate.
//
// Three routes, as the forward's; the wrapper (kernels/rwkv6/kernel.py:
// bwd_route) picks one.
//
// Chunk-parallel (L >= 64, K == V a multiple of 4, operands and cotangents
// 16-byte aligned: the RWKV6 train and prefill chunk of 256, and at T >=
// 32,768 chunks such as 48,000 -> 375 and 64,000 -> 500).
// It starts from the forward's scratch (csrc/wkv6.cu's passes 1 and 2: the
// chunk-start states S_c, the carries, Z and D = e^{LW_end}), which the
// autograd Function keeps from its forward; a call without it relaunches
// those two passes.  Then four kernels on the stream, the products on the
// tensor cores as the forward's (split, mma3 in wkv6.cuh):
//   1. wkv6_bwd_g, one block per (batch, head, chunk): G_c = R_c^T dy_c
//      summed by sub-tile, its r and dy double-buffered, R = r e^{LWp} with
//      LW rebuilt by scan_rows from the forward's carries (a row's LW has
//      the forward's bits); then the chunk's LW summed in the plain
//      version's order (one running sum a channel): the carry before each
//      sub-tile, Z and LW_end, on which the main pass takes the clips'
//      gradient masks (a row at |x| = 30 within rounding would otherwise
//      count in one version's dw and not in the other's).
//   2. wkv6_bwd_prefix, one thread per (batch, head, state element): the
//      chunks in reverse from dS (or 0), storing dS'_c over G_c and carrying
//      dS' <- D_c dS'_c + G_c; the last value is dS0.
//   3. wkv6_bwd_main, one block of 16 warps per (batch, head, chunk, 64-row
//      sub-tile i), a chunk's sub-tiles adjacent in blockIdx, the heaviest
//      (i = 0) first.  dQ_i = sum_{j <= i} dA_ij Kf_j, the warps splitting
//      the key rows in quarters that are added at the end; then dv_i =
//      sum_{j >= i} A_ji^T dy_j on warps 0-7 and dKf_i = sum_{j >= i}
//      dA_ji^T Q_j on warps 8-15, each group splitting sub-tile j's rows in
//      halves; the pair's own sub-tile masked m < t.  The other sub-tiles'
//      operands (k, v, w, then r, dy, w) stream in by cp.async,
//      double-buffered, and each masked A or dA goes from the accumulator
//      to the next product's A operand in registers.  Then the sub-tile's
//      LW in the plain version's order from pass 1's
//      carry, dR_i = dy_i S_c^T, dK2_i = v_i dS'_c^T and dv_i += K2_i dS'_c,
//      and the elementwise terms: dr, dk and dv in full, dw's reversed sum
//      within the sub-tile, and the sub-tile's per-channel totals of dLWp +
//      E, gK - gQ, dK2 K2 and ddiag r k to a (B, H, n, L / 64, 4, K)
//      scratch.  Twelve 64 x 68 tiles (207 KB): one block an SM, so the
//      block has 16 warps (at most 128 registers a thread) to hide each
//      product's latency; with 8 it ran slower.
//   4. wkv6_bwd_fixup, one block per (batch, head, chunk): dLW_end and dZ
//      from the totals and sum_v dS'_c S_c, then dw += the later sub-tiles'
//      totals + dLW_end + [t <= L / 2] dZ; the chunk-0 block also sums du's
//      (batch, head) partial over the chunks and sub-tiles in reverse.
//
// An L that is no multiple of 64 ends each chunk in a ragged sub-tile of L -
// 64 (nsub - 1) rows, nsub = ceil(L / 64) (375 -> 55): wkv6_bwd_g<false,
// true> and wkv6_bwd_main<true> bound their loads, stores and loops there,
// with zeros past its rows in every shared tile that holds it (over a
// buffer an earlier sub-tile filled too), which add nothing to a product or
// a sum; the instances at multiples of 64 compile without those bounds.
// wkv6_bwd_fixup takes the rows up to L in either case.
//
// Tile-parallel (L < 64, the chunk-parallel route's other conditions: every
// RWKV6 train length that is no multiple of 64, chunks 1 to 32; the short
// power-of-two sequences that time_mix runs at chunk 1; and at T >= 32,768
// chunks that do not divide 64, such as 50,000 -> 10).  It replaces the
// per-head kernels below for those chunks, which took B * H blocks, each
// walking T / L chunks in order twice, every chunk padded to a 64-row
// sub-tile of f32 products (63/64 padding at L = 1), from a (B, H, T / L, K,
// V) scratch of chunk-start states (2.1 GB at L = 1 and (2, 1023, 64, 64);
// 5.2 GB at L = 10 and (1, 50,000, 64, 64)).  Bytes bound the function here
// (about 0.09 ms at (2, 1040, 64, 64): its operands and gradients once), and
// at L = 1 the walks' multiply-adds below (about 8 K V a row, on the CUDA
// cores: every row a state step) are the most work there is.  A tile holds m
// = L (64 / L) rows, whole chunks: 64 where L divides 64, else fewer (63 at
// L = 3, 60 at 10, L itself from 33 up), as the forward's tiles.  The reverse
// carry dS'_{c-1} = D_c dS'_c + R_c^T dy_c has no clip, so the chunks of a
// tile compose into the tile's own carry: G = (r e^{LWp})^T dy and D =
// e^{LW_end} over the tile, every exponent <= 0.  The forward's tile scratch
// (csrc/wkv6.cu, its passes 1 and 2 over ceil(T / m) tiles, the last ragged)
// gives each tile's start state and D, which the autograd Function keeps; a
// call without it relaunches those two passes.  Then five kernels, passes 3
// and 4 in two instances each: one where L divides 64, whose chunks' rows
// are found by masks, and one of m-row tiles, whose chunks' rows are found
// by running bounds or a division:
//   1. wkv6_bwd_g<true, false>: pass 1 above at L = m over the tiles (one
//      sub-tile, its rows bounded, no carries): G of each tile.
//   2. wkv6_bwd_prefix<8>: the tiles in reverse, dS'_tile over G, dS0; its
//      loads 8 tiles ahead of its carries.
//   3. wkv6_bwd_tile_walk and 4. wkv6_bwd_tile, one block of 16 warps per
//      (batch, head, tile) each: B * H * ceil(T / m) blocks, each m / L
//      dependent steps a walk.  Inside a chunk they compute what the plain
//      version does, with the chunk's own LW, Z and clip; between chunks
//      they go through the state and its cotangent only, never through a
//      decay factored across the tile (w down to -8 spans e^{512} over 64
//      rows, past f32).  The state terms take walks on the CUDA cores,
//      state in registers and no barrier: pass 3 walks forward from the
//      tile's start state (dR) and back from its end cotangent (dK2), and
//      pass 4 back again in the other layout (dv's K2 dS'), beside the
//      chunks' own products (dA, dQ, dKf, A^T dy) on the tensor cores over
//      the whole tile at once, masked to one chunk.  dLW_end needs
//      e^{LW_end} <dS'_c, S_c> at every chunk boundary, where the two walks
//      of pass 3 run in opposite directions, and no state a chunk may be
//      kept in device memory (the per-head scratch above): the forward walk
//      keeps on chip the state at the first chunk start of each 8-row
//      window (8 slots at most, 128 KB), and the backward walk takes each
//      chunk's dot there: at L >= 8 a window holds at most one chunk start,
//      whose state the slot is; at L < 8 each half of the window walks
//      forward again from its slot with its states in registers.  The dot
//      is taken from the two states: summed instead from per-row terms
//      (<dS'_{c-1}, S_c> - sum R dR + sum K2 dK2, as the GLA-family
//      backwards do), it cancels where the decays are strong and lands 2.5
//      to 7 times further from an f64 evaluation than JAX's f32 gradient on
//      the -8 clamp (tests/test_torch_wkv6_backward.py).
//   5. wkv6_bwd_tile_du: du's (batch, head) partials, the tiles' added in
//      order.
//
// Per-head (other widths: K != V, K no multiple of 4, or an operand or a
// cotangent off a 16-byte boundary; and the route the others are held to on
// the card): the CUDA-core kernels of the first port, launched in this
// order on one stream, one block per (batch, head) each, 256 threads:
//   1. wkv6_bwd_states walks the chunks in order, as the forward does, and
//      writes the state at each chunk's start to a (B, H, n, K, V) scratch
//      that the wrapper allocates (the per-head forward holds its state in
//      shared memory and keeps none).
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
//   Both in f32 FMAs from shared memory (each 64 x 64 x 64 product, every
//   pair of sub-tiles taken twice).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "wkv6.cuh"

namespace {

// --------------------------------------------------------------------------
// the per-head route: wkv6_bwd_states, wkv6_bwd
// --------------------------------------------------------------------------

constexpr int kLD = kTS + 1;   // padded row of every shared tile
constexpr int kPTile = kTS * kLD;
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
  float* LWt = Ss + kPTile;       // LW, then K2, of a sub-tile
  float* Vt = LWt + kPTile;       // v of a sub-tile
  float* LWe = Vt + kPTile;
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
  float* dSs = Ss + kPTile;       // dS': the cotangent of its end state
  float* Li = dSs + kPTile;       // LW of sub-tile i, then ddiag r k
  float* Qi = Li + kPTile;        // Q_i, then gK - gQ
  float* Kfi = Qi + kPTile;       // Kf_i, then dK2 K2
  float* Vi = Kfi + kPTile;       // v_i
  float* DYi = Vi + kPTile;       // dy_i
  float* X = DYi + kPTile;        // Kf_j or Q_j, then R
  float* Y = X + kPTile;          // v_j or dy_j, then K2
  float* P1 = Y + kPTile;         // dA_ij or A_ji, then dLWp
  float* P2 = P1 + kPTile;        // dA_ji, then E
  float* Lt = P2 + kPTile;        // LW of sub-tile j
  float* Zs = Lt + kPTile;
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


// --------------------------------------------------------------------------
// the chunk-parallel route: wkv6_bwd_g, wkv6_bwd_prefix, wkv6_bwd_main,
// wkv6_bwd_fixup
// --------------------------------------------------------------------------

// Pass 1: one block per (batch, head, chunk).  Sub-tile by sub-tile (r and
// dy double-buffered, w straight to registers): LW from the forward's
// carry, R = r e^{LWp} in place, G += R^T dy.  Warp wp owns G's rows 16 (wp
// % 4) .. + 15 and columns 32 (wp / 4) .. + 31.  Then one thread a channel
// sums the chunk's w as the plain version does (Seq).  kRagged (the
// chunk-parallel route): L is no multiple of 64, and the chunk's last
// sub-tile has L - 64 (nsub - 1) rows (zeros past them); the instance at
// multiples of 64 compiles without these bounds.  kTiles: the tile-parallel
// route's tiles of L = m <= 64 rows (whole chunks), one sub-tile each, the
// last of which may be ragged, with no carries or Seq.
//
// Seq: the chunk's LW summed as the plain version sums it (torch.cumsum on
// the card: one running f32 sum a channel, from 0): the carry before each
// sub-tile, Z = LW[L / 2] and LW_end.  The clips' gradient jumps at |x| =
// 30, so the elementwise step takes each row's clip decision on these bits,
// as autograd of the plain version does; the products keep the forward's
// blocked scan, since the clipped values themselves are continuous.
struct Seq {
  float *carry, *Z, *LWE;
};

template <bool kTiles, bool kRagged>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_g(const float* __restrict__ r, const float* __restrict__ w,
           const float* __restrict__ dy, const float* __restrict__ carry_in,
           float* __restrict__ G, Seq seq, int T, int H, int K, int L) {
  extern __shared__ float smem[];
  float* seg_sum = smem + 4 * kTile;    // 4 x 64
  // r (then R) in buffer 2x, dy in 2x + 1
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
  const float* carry = kTiles ? nullptr : carry_in + chunk * nsub * K;
  // rows of sub-tile 0, and of the last
  const int rows = kTiles ? min(L, T - c * L) : kTS;
  const int last = kRagged ? L - (nsub - 1) * kTS : kTS;

  if (K < kTS || rows < kTS) zero_smem(smem, 4 * kTile);
  __syncthreads();
  load_tile(buf(0), r + base, row, rows, K);
  load_tile(buf(1), dy + base, row, rows, K);
  cp_commit();
  float wv[kSeg], wn[kSeg], lw[kSeg];
  load_w(wv, w + base, row, K, rows);

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
      load_tile(buf(2 - 2 * bs), r + off, row, rn, K);
      load_tile(buf(3 - 2 * bs), dy + off, row, rn, K);
      if (kRagged && rn < kTS) {               // the ragged last sub-tile
        zero_rows(buf(2 - 2 * bs), rn);
        zero_rows(buf(3 - 2 * bs), rn);
      }
      load_w(wn, w + off, row, K, rn);
    }
    cp_commit();
    scan_rows(wv, seg_sum, !kTiles && ch < K ? carry[s * K + ch] : 0.0f,
              lw);
    cp_wait<1>();
    __syncthreads();
    float* Rs = buf(2 * bs);
    const float* Ds = buf(2 * bs + 1);
    if (ch < K) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float* p = Rs + (seg * kSeg + t) * kLDT + ch;
        *p = *p * __expf(lw[t] - wv[t]);
      }
    }
    __syncthreads();
    if (s + 1 < nsub) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) wv[t] = wn[t];
    }
#pragma unroll
    for (int ks = 0; ks < kTS / 8; ++ks) {
      const float* kr = Rs + (8 * ks + q) * kLDT + m0 + g;   // A = R^T
      const float a[4] = {kr[0], kr[8], kr[4 * kLDT], kr[4 * kLDT + 8]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      const float* vr = Ds + (8 * ks + q) * kLDT + n0 + g;
      float bb[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bb[nt][0] = vr[8 * nt];
        bb[nt][1] = vr[4 * kLDT + 8 * nt];
      }
      mma3<4>(acc, ah, al, bb);
    }
  }
  float* Gb = G + chunk * K * K;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + 8 * nt + 2 * q;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kk = m0 + g + 8 * (x >> 1), vv = col + (x & 1);
      if (kk < K && vv < K) Gb[kk * K + vv] = acc[nt][x];
    }
  }
  if (!kTiles && tid < K) {      // a sub-tile's 64 loads, then 64 adds
    float run = 0.0f;
    for (int s = 0; s < nsub; ++s) {
      const float* wc = w + base + (long long)s * kTS * row + tid;
      const int rs = kRagged && s + 1 == nsub ? last : kTS;
      float x[kTS];
#pragma unroll
      for (int t = 0; t < kTS; ++t)
        x[t] = !kRagged || t < rs ? wc[(long long)t * row] : 0.0f;
      seq.carry[(chunk * nsub + s) * K + tid] = run;
#pragma unroll
      for (int t = 0; t < kTS; ++t) {
        run += x[t];
        if (s * kTS + t == L / 2) seq.Z[chunk * K + tid] = run;
      }
    }
    seq.LWE[chunk * K + tid] = run;
  }
}

// Pass 2: one thread per (batch, head, state element), the chunks in
// reverse, the loads of kAhead chunks issued before their carries (the
// tile-parallel route's 8 over its tiles; the chunk-parallel route's few
// chunks keep 1).
template <int kAhead>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_prefix(float* __restrict__ G, const float* __restrict__ D,
                const float* __restrict__ dS, float* __restrict__ dS0, int BH,
                int n, int K) {
  const long long KV = (long long)K * K;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BH * KV) return;
  const long long bh = idx / KV, e = idx % KV;
  const int kk = (int)(e / K);
  float s = dS ? dS[idx] : 0.0f;
  for (int c1 = n - 1; c1 >= 0; c1 -= kAhead) {
    float gc[kAhead], dc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long chunk = bh * n + c1 - j;
      if (c1 - j >= 0) {
        gc[j] = G[chunk * KV + e];
        dc[j] = D[chunk * K + kk];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c1 - j >= 0) {
        // the cotangent of the chunk's end state
        G[(bh * n + c1 - j) * KV + e] = s;
        s = dc[j] * s + gc[j];
      }
    }
  }
  if (dS0) dS0[idx] = s;
}

enum { kFull = 0, kLower = 1, kUpper = 2 };

// The main pass runs 16 warps a block: with its twelve tiles one block fits
// an SM, and 16 warps keep the tensor cores fed where 8 waited on each
// product's latency.
constexpr int kMainThreads = 512;

// load_tile and zero_smem for the main pass's 512 threads
__device__ __forceinline__ void load_tile2(float* dst, const float* src,
                                           long long row_stride, int rows,
                                           int n) {
  const int per_row = n >> 2;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kMainThreads) {
    const int t = idx / per_row, c = (idx % per_row) * 4;
    cp_async16(dst + t * kLDT + c, src + (long long)t * row_stride + c);
  }
}

// scan_rows for the main pass: threads tid and tid + 256 take the same
// (segment, channel) and get the same LW; the lower half writes seg_sum
__device__ __forceinline__ void scan_rows2(const float* wv, float* seg_sum,
                                           float carry, float* lw) {
  const int sc = threadIdx.x & (kThreads - 1), seg = sc >> 6, ch = sc & 63;
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    run += wv[t];
    lw[t] = run;
  }
  if (threadIdx.x < kThreads) seg_sum[seg * kTS + ch] = run;
  __syncthreads();
  float base = carry;
  for (int s = 0; s < seg; ++s) base += seg_sum[s * kTS + ch];
#pragma unroll
  for (int t = 0; t < kSeg; ++t) lw[t] = base + lw[t];
}

// a[nt] (16 x 8 NT) = A B^T for rows row0 .. + 15 of A and rows col0 .. +
// 8 NT - 1 of B, over the 64 channels of both tiles; kLower keeps column <
// row, kUpper row < column, and below L = 64 only the pairs inside one
// chunk of L rows: (row ^ column) < L where L is a power of two (kPow2),
// else the column within the row's chunk (chunk_start, once a row).
// Fragments as mma3's (g = lane / 4, q = lane % 4).
template <int MASK, int NT, bool kPow2 = true>
__device__ __forceinline__ void prod_abt(const float* A, const float* B,
                                         float (*a)[4], int row0, int col0,
                                         int L = kTS) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[nt][x] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kTS / 8; ++ks) {
    const float* ar = A + (row0 + g) * kLDT + 8 * ks + q;
    const float af[4] = {ar[0], ar[8 * kLDT], ar[4], ar[8 * kLDT + 4]};
    uint32_t ah[4], al[4];
    split4(af, ah, al);
    const float* br = B + (col0 + g) * kLDT + 8 * ks + q;
    float bb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bb[nt][0] = br[8 * nt * kLDT];
      bb[nt][1] = br[8 * nt * kLDT + 4];
    }
    mma3<NT>(a, ah, al, bb);
  }
  if (MASK != kFull) {
    // !kPow2: the first rows of the chunks of rows row0 + g and + 8
    const int c0[2] = {kPow2 ? 0 : chunk_start<false>(row0 + g, L),
                       kPow2 ? 0 : chunk_start<false>(row0 + g + 8, L)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rr = row0 + g + 8 * (x >> 1);
        const int cc = col0 + 8 * nt + 2 * q + (x & 1);
        const int cs = c0[x >> 1];
        if ((MASK == kLower ? !(cc < rr) : !(rr < cc))
            || (L < kTS && (kPow2 ? (rr ^ cc) >= L
                            : MASK == kLower ? cc < cs : cc >= cs + L)))
          a[nt][x] = 0.0f;
      }
  }
}

// acc (16 x 64) += P C with P = A B^T (prod_abt, 8 NT columns) and C's rows
// col0 .. + 8 NT - 1: P goes from the accumulator to the A operand in
// registers (k index q <-> P's column 2q, q + 4 <-> 2q + 1, so C's rows are
// read in that order)
template <int MASK, int NT, bool kPow2 = true>
__device__ __forceinline__ void chain(const float* A, const float* B,
                                      const float* C, float (*acc)[4],
                                      int row0, int col0, int L = kTS) {
  // every column >= every row, or every row >= every column: P = 0
  if (MASK == kLower && row0 + 15 <= col0) return;
  if (MASK == kUpper && row0 >= col0 + 8 * NT - 1) return;
  // every column before the rows' first chunk, or after their last: P = 0
  if (L < kTS && MASK == kLower
      && col0 + 8 * NT - 1 < chunk_start<kPow2>(row0, L))
    return;
  if (L < kTS && MASK == kUpper
      && col0 > (kPow2 ? ((row0 + 15) | (L - 1))
                       : chunk_start<false>(row0 + 15, L) + L - 1))
    return;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float a[NT][4];
  prod_abt<MASK, NT, kPow2>(A, B, a, row0, col0, L);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float fa[4] = {a[nt][0], a[nt][2], a[nt][1], a[nt][3]};
    uint32_t ah[4], al[4];
    split4(fa, ah, al);
    const float* cr = C + (col0 + 8 * nt + 2 * q) * kLDT + g;
    float bb[kTS / 8][2];
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt) {
      bb[vt][0] = cr[8 * vt];
      bb[vt][1] = cr[kLDT + 8 * vt];
    }
    mma3<kTS / 8>(acc, ah, al, bb);
  }
}

// acc (16 x 64) += A B for rows row0 .. + 15 of A, B a K x V tile
__device__ __forceinline__ void prod_ab(const float* A, const float* B,
                                        float (*acc)[4], int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kTS / 8; ++ks) {
    const float* ar = A + (row0 + g) * kLDT + 8 * ks + q;
    const float af[4] = {ar[0], ar[8 * kLDT], ar[4], ar[8 * kLDT + 4]};
    uint32_t ah[4], al[4];
    split4(af, ah, al);
    const float* br = B + (8 * ks + q) * kLDT + g;
    float bb[kTS / 8][2];
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt) {
      bb[vt][0] = br[8 * vt];
      bb[vt][1] = br[4 * kLDT + 8 * vt];
    }
    mma3<kTS / 8>(acc, ah, al, bb);
  }
}

// an accumulator of NT 8-column tiles (rows row0 .. + 15, columns col0 ..)
// and a shared tile: stored to it, added to what is there, or taken back
enum { kStore = 0, kAdd = 1, kTake = 2 };
template <int NT, int HOW>
__device__ __forceinline__ void put(float* T, float (*acc)[4], int row0,
                                    int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* o = T + (row0 + g) * kLDT + col0 + 8 * nt + 2 * q;
    float* p[4] = {o, o + 1, o + 8 * kLDT, o + 8 * kLDT + 1};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (HOW == kStore) *p[x] = acc[nt][x];
      if (HOW == kAdd) *p[x] += acc[nt][x];
      if (HOW == kTake) acc[nt][x] += *p[x];
    }
  }
}

struct Grads {
  float *dr, *dk, *dv, *dw, *tot;
};

// Pass 3: one block per (batch, head, chunk, 64-row sub-tile i), 16 warps.
// The scans run on 256 threads' (segment, channel) layout, mirrored in the
// upper 256 (scan_rows2), and the lower half scales the tiles in place.
// kRagged: L is no multiple of 64, and the chunk's last sub-tile has L - 64
// (nsub - 1) rows: every load of it is bounded, zeros stand past its rows
// in every tile that holds it (zero_rows over a buffer that an earlier
// sub-tile filled), so that each product over it adds nothing there, and
// nothing past its rows is read from or written to device memory.
template <bool kRagged>
__global__ void __launch_bounds__(kMainThreads, 1)
wkv6_bwd_main(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ dy,
              const float* __restrict__ Sc, const float* __restrict__ dSc,
              const float* __restrict__ carry_in,
              const float* __restrict__ Z_in, Seq seq, Grads out, int T,
              int H, int K, int L) {
  extern __shared__ float smem[];
  auto tile = [&](int x) { return smem + x * kTile; };
  float* DY = tile(0);      // dy_i
  float* VI = tile(1);      // v_i
  float* KF = tile(2);      // k_i, then Kf_i; LW_i at the end
  float* QI = tile(3);      // r_i, then Q_i; k_i, then K2_i at the end
  float* DQ = tile(4);      // dQ_i
  // the streamed sub-tiles' pairs: k_j (then Kf_j) and v_j, or r_j (then
  // Q_j) and dy_j; at the end dKf_i, dR_i, dK2_i, dv's other half and the
  // totals
  auto X = [&](int p) { return tile(5 + 2 * p); };
  auto Y = [&](int p) { return tile(6 + 2 * p); };
  float* WS = tile(9);      // w of the sub-tile being scanned
  float* SS = tile(10);     // S_c
  float* DSS = tile(11);    // dS'_c
  float* seg_sum = smem + 12 * kTile;
  float* us = seg_sum + 4 * kTS;
  float* lwe = us + kTS;
  float* diag = lwe + kTS;    // sum_k r u k of sub-tile i's rows
  float* ddiag = diag + kTS;  // dy . v of sub-tile i's rows

  const int n = T / L, nsub = kRagged ? (L + kTS - 1) / kTS : L / kTS;
  const int i = (int)(blockIdx.x % nsub);
  const int c = (blockIdx.x / nsub) % n, bh = blockIdx.x / nsub / n;
  // rows of sub-tile i, and of the chunk's last
  const int rows = kRagged ? min(kTS, L - i * kTS) : kTS;
  const int last = kRagged ? L - (nsub - 1) * kTS : kTS;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, sc = tid & (kThreads - 1);
  const int seg = sc >> 6, ch = sc & 63;
  const bool lower = tid < kThreads;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int t0w = 16 * (warp & 3);
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)c * L) * row
                         + (long long)h * K;
  const long long chunk = (long long)bh * n + c;
  const float* carry = carry_in + chunk * nsub * K;
  const long long off_i = base + (long long)i * kTS * row;
  const float zc = ch < K ? Z_in[chunk * K + ch] : 0.0f;

  if (K < kTS || rows < kTS)
    for (int idx = tid; idx < 12 * kTile; idx += kMainThreads) smem[idx] = 0;
  if (tid < kTS) {
    us[tid] = tid < K ? u[(long long)h * K + tid] : 0.0f;
    lwe[tid] = tid < K ? seq.LWE[chunk * K + tid] : 0.0f;
  }
  __syncthreads();
  load_tile2(QI, r + off_i, row, rows, K);    // group 1: the sub-tile
  load_tile2(KF, k + off_i, row, rows, K);
  load_tile2(WS, w + off_i, row, rows, K);
  load_tile2(VI, v + off_i, row, rows, K);
  load_tile2(DY, dy + off_i, row, rows, K);
  cp_commit();
  load_tile2(SS, Sc + chunk * K * K, K, K, K);  // group 2: the states
  load_tile2(DSS, dSc + chunk * K * K, K, K, K);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  float wv[kSeg], lw[kSeg];
#pragma unroll
  for (int t = 0; t < kSeg; ++t) wv[t] = WS[(seg * kSeg + t) * kLDT + ch];
  scan_rows2(wv, seg_sum, ch < K ? carry[i * K + ch] : 0.0f, lw);
  for (int t = warp * 4; t < warp * 4 + 4; ++t) {   // sum r u k, dy . v
    float p = 0.0f, pd = 0.0f;
    for (int kk = lane; kk < K; kk += 32) {
      p += QI[t * kLDT + kk] * us[kk] * KF[t * kLDT + kk];
      pd += DY[t * kLDT + kk] * VI[t * kLDT + kk];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, o);
      pd += __shfl_xor_sync(0xffffffffu, pd, o);
    }
    if (lane == 0) {
      diag[t] = p;
      ddiag[t] = pd;
    }
  }
  __syncthreads();
  if (lower && ch < K) {
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const int e = (seg * kSeg + t) * kLDT + ch;
      QI[e] = QI[e] * fast_clamp_exp(lw[t] - wv[t] - zc);
      KF[e] = KF[e] * fast_clamp_exp(zc - lw[t]);
    }
  }
  __syncthreads();            // Q_i and Kf_i ready; WS and the pairs free

  // the streamed sub-tiles, s = 0 .. nsub - 2: j = s < i for dQ (k, v, w),
  // then j = s + 1 > i for dKf and dv (r, dy, w); pair s % 2
  const int ns = nsub - 1;
  auto issue = [&](int s) {
    const int p = s & 1, j = s < i ? s : s + 1;
    const long long off = base + (long long)j * kTS * row;
    const int rj = kRagged && j == nsub - 1 ? last : kTS;
    load_tile2(X(p), (s < i ? k : r) + off, row, rj, K);
    load_tile2(Y(p), (s < i ? v : dy) + off, row, rj, K);
    load_tile2(WS, w + off, row, rj, K);
    if (kRagged && rj < kTS) {                // the ragged last sub-tile
      zero_rows<kMainThreads>(X(p), rj);
      zero_rows<kMainThreads>(Y(p), rj);
      zero_rows<kMainThreads>(WS, rj);
    }
    cp_commit();
  };
  // wait for streamed sub-tile s, scan its w and scale X(s % 2) in place
  // (Kf_j, or Q_j), then start the next one's loads
  auto take = [&](int s) {
    const int p = s & 1, j = s < i ? s : s + 1;
    cp_wait<0>();
    __syncthreads();
    float ws[kSeg], ls[kSeg];
#pragma unroll
    for (int t = 0; t < kSeg; ++t) ws[t] = WS[(seg * kSeg + t) * kLDT + ch];
    scan_rows2(ws, seg_sum, ch < K ? carry[j * K + ch] : 0.0f, ls);
    if (lower && ch < K) {
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float* e = X(p) + (seg * kSeg + t) * kLDT + ch;
        *e = *e * fast_clamp_exp(s < i ? zc - ls[t] : ls[t] - ws[t] - zc);
      }
    }
    __syncthreads();          // ready; WS and the other pair free
    if (s + 1 < ns) issue(s + 1);
  };
  if (ns > 0) issue(0);

  // dQ_i = sum_{j <= i} dA_ij Kf_j, dA = dy_i v_j^T: warp wp takes rows 16
  // (wp % 4) .. + 15 and key rows 16 (wp / 4) .. + 15; the quarters are
  // added in DQ, last first
  const int kq = 16 * (warp >> 2);
  float acc[kTS / 8][4];
#pragma unroll
  for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[vt][x] = 0.0f;
  chain<kLower, 2>(DY, VI, KF, acc, t0w, kq);
  for (int s = 0; s < i; ++s) {
    take(s);
    chain<kFull, 2>(DY, Y(s & 1), X(s & 1), acc, t0w, kq);
  }
  if (kq == 48) put<kTS / 8, kStore>(DQ, acc, t0w, 0);
  for (int qq = 32; qq >= 0; qq -= 16) {
    __syncthreads();
    if (kq == qq) put<kTS / 8, kAdd>(DQ, acc, t0w, 0);
  }

  // dv_i = sum_{j >= i} A_ji^T dy_j on warps 0-7, A^T = Kf_i Q_j^T; dKf_i =
  // sum_{j >= i} dA_ji^T Q_j on warps 8-15, dA^T = v_i dy_j^T; each warp
  // rows 16 (wp % 4) .. + 15 and half (wp / 4) % 2 of sub-tile j's rows
  const bool dv_warp = warp < 8;
  const int jh = 32 * ((warp >> 2) & 1);
#pragma unroll
  for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[vt][x] = 0.0f;
  if (dv_warp) chain<kUpper, 4>(KF, QI, DY, acc, t0w, jh);
  else chain<kUpper, 4>(VI, DY, QI, acc, t0w, jh);
  for (int s = i; s < ns; ++s) {
    take(s);
    const float* Qj = X(s & 1);
    const float* DYj = Y(s & 1);
    if (dv_warp) chain<kFull, 4>(KF, Qj, DYj, acc, t0w, jh);
    else chain<kFull, 4>(VI, DYj, Qj, acc, t0w, jh);
  }

  // the second halves out (dKf_i to X(0), dv_i's to Y(1)); LW_i summed as
  // the plain version sums it (Seq), and K2_i
  __syncthreads();            // every product is done with the tiles
  if (jh) put<kTS / 8, kStore>(dv_warp ? Y(1) : X(0), acc, t0w, 0);
  load_tile2(QI, k + off_i, row, rows, K);
  load_tile2(WS, w + off_i, row, rows, K);
  if (kRagged && rows < kTS) zero_rows<kMainThreads>(WS, rows);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (!dv_warp && !jh) put<kTS / 8, kAdd>(X(0), acc, t0w, 0);   // dKf_i
  if (tid < K) {
    const float le = lwe[tid];
    float run = seq.carry[(chunk * nsub + i) * K + tid];
#pragma unroll 8
    for (int t = 0; t < kTS; ++t) {
      const int e = t * kLDT + tid;
      run += WS[e];
      KF[e] = run;
      QI[e] = QI[e] * __expf(le - run);
    }
  }
  __syncthreads();

  // dv_i += K2_i dS'_c, then dv_i + diag dy_i out (warps 0-3); dR_i = dy_i
  // S_c^T (warps 4-7) and dK2_i = v_i dS'_c^T (warps 12-15)
  if (dv_warp && !jh) {
    put<kTS / 8, kTake>(Y(1), acc, t0w, 0);
    prod_ab(QI, DSS, acc, t0w);
#pragma unroll
    for (int vt = 0; vt < kTS / 8; ++vt) {
      const int col = 8 * vt + 2 * q;
      if (col >= K) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = t0w + g + 8 * hr;
        if (kRagged && m >= rows) continue;
        const float* d = DY + m * kLDT + col;
        *reinterpret_cast<float2*>(out.dv + off_i + (long long)m * row
                                   + col) =
            make_float2(acc[vt][2 * hr] + diag[m] * d[0],
                        acc[vt][2 * hr + 1] + diag[m] * d[1]);
      }
    }
  } else if (jh) {
    const float* A = dv_warp ? DY : VI;
    const float* B = dv_warp ? SS : DSS;
    float* O = dv_warp ? Y(0) : X(1);
    float a[4][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      prod_abt<kFull, 4>(A, B, a, t0w, 32 * half);
      put<4, kStore>(O, a, t0w, 32 * half);
    }
  }
  __syncthreads();

  // the elementwise terms, thread (segment e8, ch): its 8 rows last first
  float* part = Y(1);         // 4 quantities x 8 segments x 64 channels
  const int e8 = tid >> 6;
  float dwv[8];
  if (ch < K) {
    const float le = lwe[ch], uu = us[ch], zs = seq.Z[chunk * K + ch];
    const float* dKf = X(0);
    const float* dR = Y(0);
    const float* dK2 = X(1);
    float run = 0.0f, gz = 0.0f, k2s = 0.0f, dus = 0.0f;
#pragma unroll
    for (int t = 7; t >= 0; --t) {
      const int rr = e8 * 8 + t, e = rr * kLDT + ch;
      if (kRagged && rr >= rows) {      // past the ragged sub-tile's rows
        dwv[t] = 0.0f;
        continue;
      }
      const long long gi = off_i + (long long)rr * row + ch;
      const float lwt = KF[e], rv = r[gi], kv = k[gi];
      const float lwp = lwt - w[gi], xq = lwp - zs, xk = zs - lwt;
      const float eQ = fast_clamp_exp(xq), eK = fast_clamp_exp(xk);
      const float eP = __expf(lwp), e2 = __expf(le - lwt);
      const float dq = DQ[e], dkf = dKf[e], drr = dR[e], dk2 = dK2[e];
      const float bonus = ddiag[rr] * uu;
      out.dr[gi] = dq * eQ + drr * eP + bonus * kv;
      out.dk[gi] = dkf * eK + dk2 * e2 + bonus * rv;
      const float gQ = fabsf(xq) <= kClamp ? dq * (rv * eQ) : 0.0f;
      const float gK = fabsf(xk) <= kClamp ? dkf * (kv * eK) : 0.0f;
      const float k2k2 = dk2 * (kv * e2);
      const float E = -gK - k2k2;
      dwv[t] = run + E;
      run += gQ + drr * (rv * eP) + E;     // dLWp + E
      gz += gK - gQ;
      k2s += k2k2;
      dus += ddiag[rr] * rv * kv;
    }
    part[(0 * 8 + e8) * kTS + ch] = run;
    part[(1 * 8 + e8) * kTS + ch] = gz;
    part[(2 * 8 + e8) * kTS + ch] = k2s;
    part[(3 * 8 + e8) * kTS + ch] = dus;
  }
  __syncthreads();
  if (ch < K) {
    float later = 0.0f;                  // the later segments' dLWp + E
    for (int s = 7; s > e8; --s) later += part[s * kTS + ch];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (!kRagged || e8 * 8 + t < rows)
        out.dw[off_i + (long long)(e8 * 8 + t) * row + ch] = later + dwv[t];
    if (e8 == 0) {
      float* tt = out.tot + (chunk * nsub + i) * 4 * K;
      tt[ch] = later + part[ch];
      for (int x = 1; x < 4; ++x) {
        float sum = 0.0f;
        for (int s = 0; s < 8; ++s) sum += part[(x * 8 + s) * kTS + ch];
        tt[x * K + ch] = sum;
      }
    }
  }
}

// Pass 4: one block per (batch, head, chunk).  A warp a state row sums
// dS'_c S_c along it; one thread a channel forms what each sub-tile's rows of
// dw still lack (before and after row L / 2); then the block adds it over the
// chunk, 16 bytes a thread (a ragged last sub-tile's too: it takes rows
// up to L).
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_fixup(const float* __restrict__ Sc, const float* __restrict__ dSc,
               const float* __restrict__ D, const float* __restrict__ tot,
               float* __restrict__ dw, float* __restrict__ du, int T, int H,
               int K, int L) {
  // sum_v dS' S a state row, then nsub x 64 past row L / 2, then up to it
  extern __shared__ float add[];
  const int n = T / L, nsub = (L + kTS - 1) / kTS;
  float* svs = add + 2 * nsub * kTS;
  const int c = blockIdx.x % n, bh = blockIdx.x / n;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)c * L) * row
                         + (long long)h * K;
  const long long chunk = (long long)bh * n + c;
  for (int kk = warp; kk < K; kk += kThreads / 32) {
    const float* s = Sc + (chunk * K + kk) * K;
    const float* ds = dSc + (chunk * K + kk) * K;
    float p = 0.0f;
    for (int vv = lane; vv < K; vv += 32) p += ds[vv] * s[vv];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) svs[kk] = p;
  }
  __syncthreads();
  if (tid < K) {
    const float* tc = tot + chunk * nsub * 4 * K + tid;
    const float sv = svs[tid];
    float k2 = 0.0f, dz = 0.0f;
    for (int i = 0; i < nsub; ++i) {
      k2 += tc[(i * 4 + 2) * K];
      dz += tc[(i * 4 + 1) * K];
    }
    const float dlwe = k2 + sv * D[chunk * K + tid];
    float later = 0.0f;              // the later sub-tiles' dLWp + E
    for (int i = nsub - 1; i >= 0; --i) {
      const float a = later + dlwe;
      add[i * kTS + tid] = a;
      add[(nsub + i) * kTS + tid] = a + dz;
      later += tc[i * 4 * K];
    }
    if (c == 0) {
      float sum = 0.0f;
      for (int cc = n - 1; cc >= 0; --cc)
        for (int i = nsub - 1; i >= 0; --i)
          sum += tot[(((long long)bh * n + cc) * nsub * 4 + i * 4 + 3) * K
                     + tid];
      du[(long long)bh * K + tid] = sum;
    }
  }
  __syncthreads();
  const int per_row = K >> 2, items = L * per_row;
  for (int i0 = tid; i0 < items; i0 += 4 * kThreads) {   // 4 loads in flight
    float4 x[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int idx = i0 + y * kThreads, t = idx / per_row;
      if (idx < items)
        x[y] = *reinterpret_cast<const float4*>(
            dw + base + (long long)t * row + (idx % per_row) * 4);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int idx = i0 + y * kThreads, t = idx / per_row;
      if (idx >= items) continue;
      const int cc = (idx % per_row) * 4;
      const float* a = add + ((t <= L / 2 ? nsub : 0) + t / kTS) * kTS + cc;
      x[y].x += a[0];
      x[y].y += a[1];
      x[y].z += a[2];
      x[y].w += a[3];
      *reinterpret_cast<float4*>(dw + base + (long long)t * row + cc) = x[y];
    }
  }
}

// --------------------------------------------------------------------------
// the tile-parallel route: wkv6_bwd_g<true, false>, wkv6_bwd_prefix<8>,
// wkv6_bwd_tile_walk, wkv6_bwd_tile, wkv6_bwd_tile_du
// --------------------------------------------------------------------------

__device__ __forceinline__ void load4(float* d, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  d[0] = a.x;
  d[1] = a.y;
  d[2] = a.z;
  d[3] = a.w;
}

__device__ __forceinline__ void load2(float* d, const float* p) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  d[0] = a.x;
  d[1] = a.y;
}

// ---- pass 3, wkv6_bwd_tile_walk: 16 warps, thread (warp, lane) holds the
// 2 x 4 block of a K x K state at rows 2 kg (kg = 2 warp + lane / 16) and
// columns 4 vg (vg = lane % 16), so a row's product with the state summed
// over its columns runs over the 16 lanes of a half-warp.
constexpr int kWalkThreads = 512;

__device__ __forceinline__ void zero24(float (*x)[4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[a][i] = 0.0f;
}

// up += a b^T over a thread's 2 x 4 block
__device__ __forceinline__ void outer_add(float (*up)[4], const float* a,
                                          const float* b) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int i = 0; i < 4; ++i) up[x][i] = fmaf(a[x], b[i], up[x][i]);
}

// s <- d s + up, up <- 0 (a chunk's carry, by row of the state)
__device__ __forceinline__ void carry(float (*s)[4], float (*up)[4],
                                      const float* d) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[a][i] = fmaf(d[a], s[a][i], up[a][i]);
      up[a][i] = 0.0f;
    }
}

// x[2 rr + a] = b_rr . s[a] over the thread's 4 columns
__device__ __forceinline__ void row_dot(float* x, const float* b,
                                       const float (*s)[4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float p = b[0] * s[a][0];
#pragma unroll
    for (int i = 1; i < 4; ++i) p = fmaf(b[i], s[a][i], p);
    x[a] = p;
  }
}

// The checkpoint slots: a thread's 8 floats of a state, element-major, so
// that a warp's accesses are free of bank conflicts.
__device__ __forceinline__ void put_ck(float* ck, int slot,
                                       const float (*s)[4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ck[(slot * 8 + 4 * a + i) * kWalkThreads + threadIdx.x] = s[a][i];
}

__device__ __forceinline__ void get_ck(float (*s)[4], const float* ck,
                                       int slot) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[a][i] = ck[(slot * 8 + 4 * a + i) * kWalkThreads + threadIdx.x];
}

// LW inside the chunk of rows c0 .. + L - 1, channel ch, as pass 4 sums it
// (one running sum from 0 at the chunk's first row), over w in WS; then R =
// r e^{LWp} over r in RS, K2 = k e^{LW_end - LW} over k in KS, and
// e^{LW_end} at the chunk's last row of WS (rows past ``end``, which cuts
// the tile's last chunk, are not visited).
__device__ __forceinline__ void walk_chunk_lw(float* KS, float* RS, float* WS,
                                              int c0, int end, int ch) {
  float run = 0.0f;
  for (int t = c0; t < end; ++t) {
    const int e = t * kLDT + ch;
    const float wv = WS[e];
    run += wv;
    RS[e] = RS[e] * __expf(run - wv);
    WS[e] = run;
  }
  for (int t = c0; t < end; ++t) {
    const int e = t * kLDT + ch;
    KS[e] = KS[e] * __expf(run - WS[e]);   // exponent <= 0
  }
  WS[(end - 1) * kLDT + ch] = __expf(run);
}

// Pass 3 of the tile-parallel route: one block of 16 warps per (batch,
// head, tile of m rows: 64 where L divides 64, else L (64 / L), whole
// chunks), the state terms that a chunk's state S_c and the cotangent of its
// end state dS'_c give: dR = dy S_c^T into dr, dK2 = v dS'_c^T into dk, and
// dLW_end's e^{LW_end} <dS'_c, S_c> (summed over a state row) into dw at the
// chunk's first row; pass 4 reads them there and writes the gradients over
// them.  It walks forward from S_tile (dR), keeping in slot w of 8 (128 KB)
// the state at the first chunk start in 8-row window w, if any, then back
// from dS'_tile (dK2, and the dot at each chunk's first row).  At L >= 8 a
// window holds at most one chunk start, so slot t / 8 is S_c of the chunk
// that starts at row t; at L < 8 each 4-row half of a window walks forward
// again from its slot (the state at the window's first chunk start) with
// its states in registers.  The two walks run in opposite directions, and
// no state a chunk is kept in device memory.  The dot is taken from the two
// states themselves: telescoped from per-row terms instead (<dS'_{c-1},
// S_c> - sum R dR + sum K2 dK2), it loses the term to cancellation where
// the decays are strong (on the -8 clamp it is e^{-8} of the terms beside
// it).  A row's sums go out by one reduce-scatter over the half-warp every
// 8 rows (4 forward, 2 x 4 back).  The operands (K2, V, R, dy, e^{LW_end})
// are rebuilt with pass 4's LW, bit for bit.  One block an SM (its
// checkpoints), so the state is spread over 16 warps.  kPow2: L divides 64,
// and a chunk's rows are found by masks; else by running chunk bounds (a
// division once a window at L < 8).  tile_m: m as wkv6_bwd_tiled_f32 forms
// it.
template <bool kPow2>
__global__ void __launch_bounds__(kWalkThreads, 1)
wkv6_bwd_tile_walk(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ dy, const float* __restrict__ St,
                   const float* __restrict__ dSt, float* __restrict__ dR,
                   float* __restrict__ dK2, float* __restrict__ dw, int T,
                   int H, int K, int L, int tile_m) {
  extern __shared__ float smem[];
  float* KS = smem;             // k, then K2
  float* VS = KS + kTile;       // v
  float* RS = VS + kTile;       // r, then R
  float* DYS = RS + kTile;      // dy
  float* WS = DYS + kTile;      // w, then LW; e^{LW_end} at chunks' ends
  float* CK = WS + kTile;       // 8 slots of a state

  const int m = kPow2 ? kTS : tile_m, n = (T + m - 1) / m;
  const int ti = (int)(blockIdx.x % n), bh = (int)(blockIdx.x / n);
  const int h = bh % H, b = bh / H;
  const int rows = min(m, T - ti * m);       // a multiple of L
  const int tid = threadIdx.x, ch = tid & 63;
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)ti * m) * row
                         + (long long)h * K;
  const long long st = ((long long)bh * n + ti) * K * K;

  if (K < kTS || rows < kTS)
    for (int idx = tid; idx < 5 * kTile; idx += kWalkThreads)
      smem[idx] = 0.0f;
  __syncthreads();
  load_tile2(KS, k + base, row, rows, K);
  load_tile2(VS, v + base, row, rows, K);
  load_tile2(RS, r + base, row, rows, K);
  load_tile2(DYS, dy + base, row, rows, K);
  load_tile2(WS, w + base, row, rows, K);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // LW, R, K2 and e^{LW_end} by chunk, as pass 4 forms them: thread
  // (group, ch) takes G rows (whole chunks): max(8, L) where L divides 64,
  // else L ceil((64 / L) / 8), 8 groups over the tile's chunks
  if (kPow2) {
    const int G = max(8, L), g0 = (tid >> 6) * G;
    if (g0 < kTS)
      for (int c0 = g0; c0 < g0 + G; c0 += L)
        walk_chunk_lw(KS, RS, WS, c0, c0 + L, ch);
  } else {
    const int G = L * ((kTS / L + 7) / 8), g0 = (tid >> 6) * G;
    for (int c0 = g0; c0 < min(g0 + G, rows); c0 += L)
      walk_chunk_lw(KS, RS, WS, c0, c0 + L, ch);
  }
  __syncthreads();

  const int lane = tid & 31, kg = 2 * (tid >> 5) + (lane >> 4);
  const int vg = lane & 15;
  const bool kin = 2 * kg < K && 4 * vg < K;
  float s[2][4], up[2][4], kv[2], xv[4], dv[4], d[2];
  const float* src = St + st + (2 * kg) * K + 4 * vg;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[a][i] = kin ? src[a * K + i] : 0.0f;
  zero24(up);
  int end = L;                 // !kPow2: one past the current chunk's last row
  for (int t0 = 0; t0 < rows; t0 += 8) {   // forward: dR, and the states
    // the window's first chunk start, where it is the window's first row
    if (kPow2 ? (t0 & (L - 1)) == 0 : end - L == t0) put_ck(CK, t0 >> 3, s);
    float x[16];                        // x[2 rr + a]: row t0 + rr, 2 kg + a
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int t = t0 + rr;
      load4(dv, DYS + t * kLDT + 4 * vg);
      load2(kv, KS + t * kLDT + 2 * kg);
      load4(xv, VS + t * kLDT + 4 * vg);
      row_dot(x + 2 * rr, dv, s);
      outer_add(up, kv, xv);
      if (kPow2 ? ((t + 1) & (L - 1)) == 0 : t + 1 == end) {
        load2(d, WS + t * kLDT + 2 * kg);   // the chunk's last row
        carry(s, up, d);
        if (!kPow2) {
          // the window's first chunk start, inside the window
          if (rr < 7 && end - L < t0) put_ck(CK, t0 >> 3, s);
          end += L;
        }
      }
    }
    halve<8>(x, lane);
    halve<4>(x, lane);
    halve<2>(x, lane);
    halve<1>(x, lane);
    const int t = t0 + (vg >> 1), kk = 2 * kg + (vg & 1);
    if (t < rows && kk < K) dR[base + (long long)t * row + kk] = x[0];
  }
  src = dSt + st + (2 * kg) * K + 4 * vg;   // back: dS'
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[a][i] = kin ? src[a * K + i] : 0.0f;
  zero24(up);
  int start = rows - L;        // !kPow2: the first row of the current chunk
  for (int w0 = (rows - 1) & ~7; w0 >= 0; w0 -= 8) {
    // the window's first chunk start (slot w0 / 8 holds its state)
    const int cf = kPow2 ? w0 : w0 + (L - w0 % L) % L;
#pragma unroll
    for (int hf = 1; hf >= 0; --hf) {   // the window's halves, last first
      const int h0 = w0 + 4 * hf;
      if (h0 >= rows) continue;
      float sw[4][2][4];                // L < 8: the state at each row
      if (L < 8) {
        float f[2][4], fu[2][4];
        get_ck(f, CK, w0 >> 3);
        zero24(fu);
        int fe = cf + L;                // !kPow2: the re-walk's chunk end
#pragma unroll
        for (int j = 0; j < 4 * hf + 4; ++j) {
          const int t = w0 + j;
          if (j >= 4 * hf) {
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int i = 0; i < 4; ++i) sw[j - 4 * hf][a][i] = f[a][i];
          }
          if (t < rows && (kPow2 || t >= cf)) {
            load2(kv, KS + t * kLDT + 2 * kg);
            load4(xv, VS + t * kLDT + 4 * vg);
            outer_add(fu, kv, xv);
            if (kPow2 ? ((t + 1) & (L - 1)) == 0 : t + 1 == fe) {
              load2(d, WS + t * kLDT + 2 * kg);
              carry(f, fu, d);
              if (!kPow2) fe += L;
            }
          }
        }
      }
      float x[8], q[8];                 // dK2 and the dots, row h0 + jj
#pragma unroll
      for (int jj = 3; jj >= 0; --jj) {
        const int t = h0 + jj;
        x[2 * jj] = x[2 * jj + 1] = q[2 * jj] = q[2 * jj + 1] = 0.0f;
        if (t >= rows) continue;
        load2(kv, RS + t * kLDT + 2 * kg);
        load4(dv, DYS + t * kLDT + 4 * vg);
        load4(xv, VS + t * kLDT + 4 * vg);
        row_dot(x + 2 * jj, xv, s);
        outer_add(up, kv, dv);
        if (kPow2 ? (t & (L - 1)) == 0 : t == start) {   // a chunk's first row
          float sc[2][4];
          if (L < 8) {
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int i = 0; i < 4; ++i) sc[a][i] = sw[jj][a][i];
          } else {
            get_ck(sc, CK, t >> 3);
          }
          load2(d, WS + (t + L - 1) * kLDT + 2 * kg);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            float p = s[a][0] * sc[a][0];
#pragma unroll
            for (int i = 1; i < 4; ++i) p = fmaf(s[a][i], sc[a][i], p);
            q[2 * jj + a] = d[a] * p;
          }
          carry(s, up, d);
          if (!kPow2) start -= L;
        }
      }
      // 8 values over the 16 lanes: bits 4, 2, 1, then the lanes 8 apart
      halve<4>(x, lane);
      halve<2>(x, lane);
      halve<1>(x, lane);
      halve<4>(q, lane);
      halve<2>(q, lane);
      halve<1>(q, lane);
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], 8);
      q[0] += __shfl_xor_sync(0xffffffffu, q[0], 8);
      const int j = vg & 7, t = h0 + (j >> 1), kk = 2 * kg + (j & 1);
      if (vg < 8 && t < rows && kk < K) {
        dK2[base + (long long)t * row + kk] = x[0];
        if (kPow2 ? (t & (L - 1)) == 0 : t % L == 0)
          dw[base + (long long)t * row + kk] = q[0];
      }
    }
  }
}

// ---- pass 4, wkv6_bwd_tile's walk: warps 0-7, thread (warp, lane) holds
// the 4 x 4 block of dS' at rows 4 kg (kg = lane % 16) and columns 4 vg
// (vg = 2 warp + lane / 16), so a row's product K2_t dS' summed over the
// state's rows runs over the 16 lanes of a half-warp (the forward's
// walk_tile layout).
__device__ __forceinline__ void dv_layout(int& kg, int& vg) {
  const int lane = threadIdx.x & 31;
  kg = lane & 15;
  vg = 2 * (threadIdx.x >> 5) + (lane >> 4);
}

// The backward walk over a tile's first ``rows`` rows in chunks of L, last
// first, from the tile's end cotangent s: dv's state term K2_t dS'_c into
// O, and at each chunk's first row dS' <- e^{LW_end} dS' + R^T dy (up sums
// R_t^T dy_t).  Four rows at a time; then a reduce-scatter over the 16
// lanes of kg (15 shuffles, one order) leaves lane kg the sum for row kg /
// 4, column 4 vg + kg % 4.  Rows past ``rows`` (zeros) change nothing that
// is stored.  kPow2: a chunk's first row by a mask, else by a running
// bound.
template <bool kPow2>
__device__ __forceinline__ void walk_dv(const float* Rs, const float* DY,
                                        const float* K2s, const float* Ds,
                                        float* O, float (*s)[4], int rows,
                                        int L) {
  const int lane = threadIdx.x & 31;
  int kg, vg;
  dv_layout(kg, vg);
  float up[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) up[a][i] = 0.0f;
  int start = rows - L;        // !kPow2: the first row of the current chunk
  for (int t0 = ((rows + 3) & ~3) - 4; t0 >= 0; t0 -= 4) {
    float x[16];                        // x[4 rr + i]: row t0 + rr, 4 vg + i
#pragma unroll
    for (int rr = 3; rr >= 0; --rr) {
      const int t = t0 + rr;
      float rv[4], dv[4], kv[4];
      load4(rv, Rs + t * kLDT + 4 * kg);
      load4(dv, DY + t * kLDT + 4 * vg);
      load4(kv, K2s + t * kLDT + 4 * kg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = kv[0] * s[0][i];
#pragma unroll
        for (int a = 1; a < 4; ++a) p = fmaf(kv[a], s[a][i], p);
        x[4 * rr + i] = p;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) up[a][i] = fmaf(rv[a], dv[i], up[a][i]);
      if (t < rows && (kPow2 ? (t & (L - 1)) == 0 : t == start)) {
        float d[4];                     // the chunk's first row
        load4(d, Ds + (t + L - 1) * kLDT + 4 * kg);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[a][i] = fmaf(d[a], s[a][i], up[a][i]);
            up[a][i] = 0.0f;
          }
        if (!kPow2) start -= L;
      }
    }
    halve<8>(x, lane);
    halve<4>(x, lane);
    halve<2>(x, lane);
    halve<1>(x, lane);
    O[(t0 + (kg >> 2)) * kLDT + 4 * vg + (kg & 3)] = x[0];
  }
}

__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int vt = 0; vt < kTS / 8; ++vt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[vt][x] = 0.0f;
}

// a barrier of the block's second group of 8 warps alone
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Pass 4 of the tile-parallel route: one block of 16 warps per (batch,
// head, tile of m rows, whole chunks of L), whose chunks it takes with the
// cotangent of the tile's end state dS'_tile (pass 2's, over G) and pass
// 3's state terms.
//   1. r, k, v, w and dy of the tile by cp.async (zeros past a ragged
//      tile's rows); the bonus sum_k r u k and ddiag = dy . v of each row.
//   2. LW inside each chunk summed as the plain version sums it
//      (torch.cumsum on the card: one running sum a channel from 0 at the
//      chunk's first row), on which every clip and its gradient mask is
//      taken; then Q, Kf (the chunk's own Z and clip), R = r e^{LWp}, K2 =
//      k e^{LW_end - LW} and e^{LW_end} at each chunk's last row.
//   3. Warps 0-7 walk back from dS'_tile (walk_dv: dv's state term), while
//      warps 8-15 take the chunks' own products over the whole tile on the
//      tensor cores, masked to one chunk (split TF32, chain): dQ = dA Kf,
//      dKf = dA^T Q and A^T dy.
//   4. The elementwise terms with pass 3's dR and dK2 (dr, dk and dv out,
//      and per row dLWp + E, E, gK - gQ, K2 dK2 and ddiag r k), then by
//      chunk dLW_end = sum_t K2 dK2 + pass 3's e^{LW_end} <dS'_c, S_c>,
//      dw's reversed sum inside each chunk, and the tile's partial of du.
// Twelve 64 x 68 tiles (205 KB): one block an SM.  kPow2: L divides 64 and
// m = 64, a chunk's rows by masks; else m = L (64 / L) < 64 (tile_m), a
// chunk's first row by a division or a running bound, and step 2 also
// runs over the rows past m as chunks of zeros, so that every tile the
// products read holds finite values there.
constexpr int kTileBwdThreads = 512;

template <bool kPow2>
__global__ void __launch_bounds__(kTileBwdThreads, 1)
wkv6_bwd_tile(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ dy,
              const float* __restrict__ dSt, Grads out, int T, int H, int K,
              int L, int tile_m) {
  extern __shared__ float smem[];
  auto tile = [&](int x) { return smem + x * kTile; };
  float* VS = tile(0);      // v; then du's partial sums
  float* DYS = tile(1);     // dy
  float* QS = tile(2);      // r, then Q
  float* KFS = tile(3);     // k, then Kf; then ddiag r k
  float* LWS = tile(4);     // w, then LW
  float* RS = tile(5);      // LW, then R; then gK - gQ
  float* K2S = tile(6);     // K2; then K2 dK2
  float* DS = tile(7);      // e^{LW_end} at chunks' last rows
  float* DVS = tile(8);     // dv
  float* DQS = tile(9);     // dQ; then dLWp + E
  float* DKS = tile(10);    // dKf; then E
  float* DLS = tile(11);    // the chunks' A^T dy
  float* us = smem + 12 * kTile;
  float* diag = us + kTS;   // sum_k r u k of each row
  float* ddiag = diag + kTS;  // dy . v of each row

  const int m = kPow2 ? kTS : tile_m, n = (T + m - 1) / m;
  const int ti = (int)(blockIdx.x % n), bh = (int)(blockIdx.x / n);
  const int h = bh % H, b = bh / H;
  const int rows = min(m, T - ti * m);       // a multiple of L
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = tid & 63, e8 = tid >> 6;    // rows 8 e8 .. + 7, channel ch
  const long long row = (long long)H * K;
  const long long base = ((long long)b * T + (long long)ti * m) * row
                         + (long long)h * K;
  const long long st = ((long long)bh * n + ti) * K * K;

  if (K < kTS || rows < kTS)
    for (int idx = tid; idx < 5 * kTile; idx += kTileBwdThreads)
      smem[idx] = 0.0f;
  if (tid < kTS) us[tid] = tid < K ? u[(long long)h * K + tid] : 0.0f;
  __syncthreads();
  load_tile2(VS, v + base, row, rows, K);
  load_tile2(DYS, dy + base, row, rows, K);
  load_tile2(QS, r + base, row, rows, K);
  load_tile2(KFS, k + base, row, rows, K);
  load_tile2(LWS, w + base, row, rows, K);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (int t = warp * 4; t < warp * 4 + 4; ++t) {   // sum r u k, dy . v
    float p = 0.0f, pd = 0.0f;
    for (int kk = lane; kk < K; kk += 32) {
      p += QS[t * kLDT + kk] * us[kk] * KFS[t * kLDT + kk];
      pd += DYS[t * kLDT + kk] * VS[t * kLDT + kk];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, o);
      pd += __shfl_xor_sync(0xffffffffu, pd, o);
    }
    if (lane == 0) {
      diag[t] = p;
      ddiag[t] = pd;
    }
  }
  // LW inside each chunk, one running sum a channel: a thread takes G
  // rows, whole chunks: max(8, L) where L divides 64, else L ceil((64 / L) /
  // 8), the 8 groups then running past m, to row 63, over zeros
  const int G = kPow2 ? max(8, L) : L * ((kTS / L + 7) / 8), grp = tid >> 6;
  const bool has_grp = grp * G < kTS;
  if (has_grp) {
    float run = 0.0f;
    int cs = grp * G;          // !kPow2: the next chunk's first row
    for (int t = grp * G; t < (kPow2 ? grp * G + G : min(grp * G + G, kTS));
         ++t) {
      if (kPow2 ? (t & (L - 1)) == 0 : t == cs) {
        run = 0.0f;
        if (!kPow2) cs += L;
      }
      run += LWS[t * kLDT + ch];
      RS[t * kLDT + ch] = run;
    }
  }
  __syncthreads();
  {
    float lw[8], wv[8], zv[8], le[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = 8 * e8 + j, c0 = chunk_start<kPow2>(t, L);
      // !kPow2: a chunk of zeros past m, cut at row 63, takes its Z and
      // LW_end there
      const int zr = c0 + L / 2, er = c0 + L - 1;
      lw[j] = RS[t * kLDT + ch];
      wv[j] = LWS[t * kLDT + ch];
      zv[j] = RS[(kPow2 ? zr : min(zr, kTS - 1)) * kLDT + ch];
      le[j] = RS[(kPow2 ? er : min(er, kTS - 1)) * kLDT + ch];
    }
    __syncthreads();                    // every LW, Z and LW_end is read
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = (8 * e8 + j) * kLDT + ch;
      const float lwp = lw[j] - wv[j], rr = QS[e], kv = KFS[e];
      QS[e] = rr * fast_clamp_exp(lwp - zv[j]);
      KFS[e] = kv * fast_clamp_exp(zv[j] - lw[j]);
      RS[e] = rr * __expf(lwp);
      K2S[e] = kv * __expf(le[j] - lw[j]);   // exponent <= 0
      LWS[e] = lw[j];
      DS[e] = __expf(lw[j]);            // read at chunks' last rows only
    }
  }
  __syncthreads();

  if (warp < 8) {
    float s[4][4];
    int kg, vg;
    dv_layout(kg, vg);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (4 * kg + a < K && 4 * vg < K) {
        load4(s[a], dSt + st + (4 * kg + a) * K + 4 * vg);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[a][i] = 0.0f;
      }
    }
    walk_dv<kPow2>(RS, DYS, K2S, DS, DVS, s, rows, L);
  } else if (L > 1) {
    // the chunks' own products: warp gw takes rows 16 (gw % 4) .. + 15 and
    // key rows 32 (gw / 4) .. + 31; the second half's sums go in first
    const int gw = warp & 7, row0 = 16 * (gw & 3), half = gw >> 2;
    float acc[kTS / 8][4];
    zero_acc(acc);                      // dQ = tril(dy v^T) Kf
    chain<kLower, 4, kPow2>(DYS, VS, KFS, acc, row0, 32 * half, L);
    if (half) put<kTS / 8, kStore>(DQS, acc, row0, 0);
    group_sync();
    if (!half) put<kTS / 8, kAdd>(DQS, acc, row0, 0);
    zero_acc(acc);                      // dKf = tril(dy v^T)^T Q
    chain<kUpper, 4, kPow2>(VS, DYS, QS, acc, row0, 32 * half, L);
    if (half) put<kTS / 8, kStore>(DKS, acc, row0, 0);
    group_sync();
    if (!half) put<kTS / 8, kAdd>(DKS, acc, row0, 0);
    zero_acc(acc);                      // the chunks' A^T dy
    chain<kUpper, 4, kPow2>(KFS, QS, DYS, acc, row0, 32 * half, L);
    if (half) put<kTS / 8, kStore>(DLS, acc, row0, 0);
    group_sync();
    if (!half) put<kTS / 8, kAdd>(DLS, acc, row0, 0);
  }
  __syncthreads();

  // the elementwise terms, thread (e8, ch): rows 8 e8 .. + 7
  if (ch < K) {
    const float uu = us[ch];
    const bool prods = L > 1;
    for (int j = 0; j < 8; ++j) {
      const int t = 8 * e8 + j;
      if (t >= rows) break;
      const int e = t * kLDT + ch, c0 = chunk_start<kPow2>(t, L);
      const long long gi = base + (long long)t * row + ch;
      const float lw = LWS[e], zs = LWS[(c0 + L / 2) * kLDT + ch];
      const float le = LWS[(c0 + L - 1) * kLDT + ch];
      const float rv = r[gi], kv = k[gi];
      const float lwp = lw - w[gi], xq = lwp - zs, xk = zs - lw;
      const float eQ = fast_clamp_exp(xq), eK = fast_clamp_exp(xk);
      const float eP = __expf(lwp), e2 = __expf(le - lw);
      const float dq = prods ? DQS[e] : 0.0f, dkf = prods ? DKS[e] : 0.0f;
      const float drr = out.dr[gi], dk2 = out.dk[gi];   // pass 3's
      const float bonus = ddiag[t] * uu;
      out.dr[gi] = dq * eQ + drr * eP + bonus * kv;
      out.dk[gi] = dkf * eK + dk2 * e2 + bonus * rv;
      const float gQ = fabsf(xq) <= kClamp ? dq * (rv * eQ) : 0.0f;
      const float gK = fabsf(xk) <= kClamp ? dkf * (kv * eK) : 0.0f;
      const float k2k2 = dk2 * (kv * e2);
      const float E = -gK - k2k2;
      DQS[e] = gQ + drr * (rv * eP) + E;   // dLWp + E
      DKS[e] = E;
      RS[e] = gK - gQ;
      K2S[e] = k2k2;
      KFS[e] = ddiag[t] * rv * kv;
    }
  }
  {                                     // dv, 16 bytes a thread
    const int per_row = K >> 2;
    for (int idx = tid; idx < rows * per_row; idx += kTileBwdThreads) {
      const int t = idx / per_row, cc = (idx % per_row) * 4;
      float a[4], c[4], d[4];
      load4(a, DVS + t * kLDT + cc);
      load4(d, DYS + t * kLDT + cc);
      if (L > 1) {
        load4(c, DLS + t * kLDT + cc);
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] += c[x];
      }
      *reinterpret_cast<float4*>(out.dv + base + (long long)t * row + cc) =
          make_float4(a[0] + diag[t] * d[0], a[1] + diag[t] * d[1],
                      a[2] + diag[t] * d[2], a[3] + diag[t] * d[3]);
    }
  }
  __syncthreads();

  // by chunk, thread (group, ch): dLW_end = sum K2 dK2 + pass 3's
  // e^{LW_end} <dS', S> (in dw at the chunk's first row), dZ = sum (gK -
  // gQ), then dw's reversed sum over the chunk; du's sum by group
  const int g_end = min(grp * G + G, rows);
  if (ch < K && has_grp) {
    float su = 0.0f;
    for (int c0 = grp * G; c0 < g_end; c0 += L) {
      float sk = 0.0f, sz = 0.0f;
      for (int t = c0; t < c0 + L; ++t) {
        const int e = t * kLDT + ch;
        sk += K2S[e];
        sz += RS[e];
        su += KFS[e];
      }
      const float dl = sk + out.dw[base + (long long)c0 * row + ch];
      float run = 0.0f;
      for (int t = c0 + L - 1; t >= c0; --t) {
        const int e = t * kLDT + ch;
        out.dw[base + (long long)t * row + ch] =
            run + DKS[e] + dl + (t - c0 <= L / 2 ? sz : 0.0f);
        run += DQS[e];
      }
    }
    VS[grp * kLDT + ch] = su;
  }
  __syncthreads();
  if (tid < K) {                        // du's partial of the tile
    float su = 0.0f;
    for (int g = 0; g < (kPow2 ? kTS / G : (kTS + G - 1) / G); ++g)
      su += VS[g * kLDT + tid];
    out.tot[((long long)bh * n + ti) * K + tid] = su;
  }
}

// Pass 5: one thread per (batch, head, channel): du's (batch, head) partial,
// the tiles' partials added in order.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_tile_du(const float* __restrict__ part, float* __restrict__ du,
                 int BH, int n, int K) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BH * K) return;
  const int bh = idx / K, kk = idx % K;
  float sum = 0.0f;
  for (int i = 0; i < n; ++i) sum += part[((long long)bh * n + i) * K + kk];
  du[idx] = sum;
}

constexpr size_t kGSmem = sizeof(float) * (4 * kTile + 4 * kTS);
constexpr size_t kMainSmem = sizeof(float) * (12 * kTile + 8 * kTS);
constexpr size_t kTileBwdSmem = sizeof(float) * (12 * kTile + 3 * kTS);
constexpr size_t kWalkSmem =
    sizeof(float) * (5 * kTile + 8 * 8 * kWalkThreads);

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// The per-head route.  r, k, w, dr, dk, dw: (B, T, H, K); v, dy, dv:
// (B, T, H, V); u: (H, K); S0 (nullable), dS (nullable), dS0 (nullable):
// (B, H, K, V); Sc: a (B, H, T / L, K, V) scratch; du: (B, H, K)
// per-(batch, head) partials.  All f32 and contiguous.
int wkv6_bwd_f32(const float* r, const float* k, const float* v,
                 const float* w, const float* u, const float* S0,
                 const float* dy, const float* dS, float* Sc, float* dr,
                 float* dk, float* dv, float* dw, float* du, float* dS0,
                 int B, int T, int H, int K, int V, int L,
                 cudaStream_t stream) {
  if (K < 1 || V < 1 || K > kTS || V > kTS || L < 1 || T % L)
    return (int)cudaErrorInvalidValue;
  const int nsub = (L + kTS - 1) / kTS;
  const size_t smem1 = sizeof(float) * (3 * kPTile + 2 * kTS + nsub * kTS);
  const size_t smem2 = sizeof(float) * (12 * kPTile + 7 * kTS + nsub * kTS);
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

// The chunk-parallel route (K == V, L >= 64).  Sc (B, H, n, K, K), carry
// (B, H, n, nsub, K), Z and D (B, H, n, K): the forward's scratch after its
// passes 1 and 2 (csrc/wkv6.cu, wkv6_chunked_f32), n = T / L, nsub =
// ceil(L / 64).  G (B, H, n, K, K), seq_carry (B, H, n, nsub, K), seq_Z and
// LWE (B, H, n, K) and tot (B, H, n, nsub, 4, K): this route's scratch.
// passes is a mask of the kernels to launch (1 G, 2 prefix, 4 main, 8
// fix-up): 15 for a call, one bit to time one kernel alone.  An L that is
// no multiple of 64 runs the row-bounded instances.
int wkv6_bwd_chunked_f32(const float* r, const float* k, const float* v,
                         const float* w, const float* u, const float* dy,
                         const float* dS, const float* Sc,
                         const float* carry, const float* Z, const float* D,
                         float* G, float* seq_carry, float* seq_Z,
                         float* LWE, float* tot, float* dr,
                         float* dk, float* dv, float* dw, float* du,
                         float* dS0, int B, int T, int H, int K, int L,
                         int passes, cudaStream_t stream) {
  if (K < 4 || K > kTS || K % 4 != 0 || L < kTS || T % L != 0 ||
      !aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) ||
      !aligned16(dy) || !aligned16(Sc) || !aligned16(G) || !aligned16(dv) ||
      !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  const int n = T / L, nsub = (L + kTS - 1) / kTS, BH = B * H;
  const bool ragged = L % kTS != 0;
  cudaError_t err;
  if (passes & 1) {
    const auto g = ragged ? &wkv6_bwd_g<false, true>
                          : &wkv6_bwd_g<false, false>;
    err = cudaFuncSetAttribute(g, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kGSmem);
    if (err != cudaSuccess) return (int)err;
    g<<<BH * n, kThreads, kGSmem, stream>>>(
        r, w, dy, carry, G, Seq{seq_carry, seq_Z, LWE}, T, H, K, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const long long total = (long long)BH * K * K;
    wkv6_bwd_prefix<1><<<(int)((total + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(G, D, dS, dS0, BH, n, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const auto pass = ragged ? &wkv6_bwd_main<true> : &wkv6_bwd_main<false>;
    err = cudaFuncSetAttribute(pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMainSmem);
    if (err != cudaSuccess) return (int)err;
    pass<<<BH * n * nsub, kMainThreads, kMainSmem, stream>>>(
        r, k, v, w, u, dy, Sc, G, carry, Z, Seq{seq_carry, seq_Z, LWE},
        Grads{dr, dk, dv, dw, tot}, T, H, K, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 8) {
    wkv6_bwd_fixup<<<BH * n, kThreads,
                     sizeof(float) * (2 * nsub + 1) * kTS, stream>>>(
        Sc, G, D, tot, dw, du, T, H, K, L);
  }
  return (int)cudaGetLastError();
}

// The tile-parallel route (K == V, L <= 64 divides T): tiles of m = L (64 /
// L) rows, whole chunks (64 where L divides 64).  St (B, H, n, K, K) and D
// (B, H, n, K), n = ceil(T / m): the forward's tile scratch after its
// passes 1 and 2 (csrc/wkv6.cu, wkv6_tiled_f32), the state at each tile's
// start and e^{LW_end} of each tile.  G (B, H, n, K, K) and part (B, H, n,
// K): this route's scratch.  passes: a mask of the kernels to launch (1 G,
// 2 prefix, 16 walk, 4 main, 8 du; in that order): 31 for a call.  An L
// that does not divide 64 runs the instances of m-row tiles.
int wkv6_bwd_tiled_f32(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* dy,
                       const float* dS, const float* St, const float* D,
                       float* G, float* part, float* dr, float* dk, float* dv,
                       float* dw, float* du, float* dS0, int B, int T, int H,
                       int K, int L, int passes, cudaStream_t stream) {
  if (K < 4 || K > kTS || K % 4 != 0 || L < 1 || L > kTS || T < 1 ||
      T % L != 0 || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
      !aligned16(w) || !aligned16(dy) || !aligned16(St) || !aligned16(G) ||
      !aligned16(dv) || !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  const int m = L * (kTS / L), n = (T + m - 1) / m, BH = B * H;
  const bool pow2 = kTS % L == 0;
  cudaError_t err;
  if (passes & 1) {
    const auto g = &wkv6_bwd_g<true, false>;
    err = cudaFuncSetAttribute(g, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kGSmem);
    if (err != cudaSuccess) return (int)err;
    g<<<BH * n, kThreads, kGSmem, stream>>>(
        r, w, dy, nullptr, G, Seq{nullptr, nullptr, nullptr}, T, H, K, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const long long total = (long long)BH * K * K;
    wkv6_bwd_prefix<8><<<(int)((total + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(G, D, dS, dS0, BH, n, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 16) {
    const auto walk = pow2 ? &wkv6_bwd_tile_walk<true>
                           : &wkv6_bwd_tile_walk<false>;
    err = cudaFuncSetAttribute(walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWalkSmem);
    if (err != cudaSuccess) return (int)err;
    walk<<<BH * n, kWalkThreads, kWalkSmem, stream>>>(
        r, k, v, w, dy, St, G, dr, dk, dw, T, H, K, L, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const auto tile = pow2 ? &wkv6_bwd_tile<true> : &wkv6_bwd_tile<false>;
    err = cudaFuncSetAttribute(tile,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kTileBwdSmem);
    if (err != cudaSuccess) return (int)err;
    tile<<<BH * n, kTileBwdThreads, kTileBwdSmem, stream>>>(
        r, k, v, w, u, dy, G, Grads{dr, dk, dv, dw, part}, T, H, K, L, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 8) {
    wkv6_bwd_tile_du<<<(BH * K + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(part, du, BH, n, K);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
