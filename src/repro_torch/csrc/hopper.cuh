// Hopper building blocks shared by the tensor-core attention kernels
// (flash_attention.cu's flash_fwd_wgmma, flash_attention_bwd.cu's
// flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma): mbarriers, TMA loads through
// 4-D tensor maps over (B, S, H, hd) strides, wgmma shared-memory
// descriptors with the 128-byte swizzle (64-byte at head width 32), the
// m64nNk16 bf16 products and the split of an f32 fragment into two bf16
// halves.
//
// Tiles: a tile of R rows x HD bf16 columns lies in shared memory as HD / 64
// column blocks of R rows x 128 bytes, each 1024-byte aligned and swizzled
// by TMA as wgmma reads it; at HD = 32 (the backward only) as one block of R
// rows x 64 bytes, under the 64-byte swizzle, whose 8-row groups lie 512
// bytes apart.  The products take a "wide" tile of kBM = 128
// rows (two consumer warpgroups of 64 rows each) against a "narrow" tile of
// kBN = 64 rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace hopper {

constexpr int kBM = 128;        // rows of a wide tile: 2 consumer warpgroups
constexpr int kBN = 64;         // rows of a narrow tile
constexpr uint32_t kRowBytes = 128;  // 64 bf16 columns: the swizzle span
constexpr uint32_t kQColBlock = kBM * kRowBytes;   // a 64-column block of a
                                                   // wide tile
constexpr uint32_t kColBlock = kBN * kRowBytes;    // ... of a narrow tile
constexpr float kLog2e = 1.4426950408889634f;

// bytes of a tile row within one swizzled column block, the swizzle's span
template <int HD>
__host__ __device__ constexpr uint32_t row_bytes() {
  return HD >= 64 ? kRowBytes : 2 * HD;
}
// the descriptor's layout type: 1 the 128-byte swizzle, 2 the 64-byte one
template <int HD>
__host__ __device__ constexpr uint64_t swizzle_type() {
  return HD >= 64 ? 1 : 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that never
// completes is a fault of the kernel: trap (an error that the next
// synchronize reports) instead of spinning on the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}

// One box (64 head columns x the map's rows, of one head of one batch) by
// TMA; rows past the end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout 1) or 64-byte
// (layout 2).  K-major operands (Q, K) step 8-row groups by SBO = 8 rows
// (1024 bytes; 512 under the 64-byte swizzle); the MN-major V steps 8-row
// groups of its K axis (kv rows) by the same SBO and column blocks of N by
// LBO.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Two consumer warpgroups (256 threads) take turns to issue their products
// (named barrier 1 + wg is warpgroup wg's turn; barrier 0 is
// __syncthreads), so that one's softmax runs while the other's products hold
// the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 256;" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, 256;" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;" ::: "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma reads or
// writes: each call marks them as read and written at this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32(d, i) F8(d, i), F8(d, i + 8), F8(d, i + 16), F8(d, i + 24)

// d[32] (+)= A (64 x 16, shared memory) . B (64 x 16, shared memory)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A (64 x 16, registers) . B (16 x 128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(d, 0), F32(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, registers) . B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[16] += A (64 x 16, registers) . B (16 x 32, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef F32
#undef F8

// p = hi + lo + O(2^-17 p), both halves as packed bf16 pairs (low half:
// the lower column), the layout of a wgmma A fragment.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S (+)= Q K^T over the head axis: HD / 16 steps of k16, both operands
// K-major; within a 128-byte (64-byte) row a step moves the start by 32
// bytes.  The A operand (sQw) is 64 rows of a wide tile, the B operand (sKs)
// a narrow tile.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t sQw,
                                         uint32_t sKs) {
  constexpr uint32_t sbo = 8 * row_bytes<HD>();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(sc,
             desc(sQw + (kk >> 2) * kQColBlock + off, 16, sbo,
                  swizzle_type<HD>()),
             desc(sKs + (kk >> 2) * kColBlock + off, 16, sbo,
                  swizzle_type<HD>()),
             kk > 0);
  }
}

// O += P_hi V + P_lo V over the tile's kv rows: kBN / 16 steps of k16, V
// (a narrow tile of HD = 2 N columns) MN-major, a step moves 16 rows (2048
// bytes; 1024 at HD = 32) down every column block.
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&phi)[kBN / 4],
                                         const uint32_t (&plo)[kBN / 4],
                                         uint32_t sVs) {
  constexpr uint32_t row = row_bytes<2 * N>();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc(sVs + kk * 16 * row, kBN * row, 8 * row,
                             swizzle_type<2 * N>());
    wgmma_rs(acc, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
             phi[4 * kk + 3], dv);
    wgmma_rs(acc, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
             plo[4 * kk + 3], dv);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void split_all(const float (&p)[kBN / 2],
                                          uint32_t (&hi)[kBN / 4],
                                          uint32_t (&lo)[kBN / 4]) {
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) split(p[2 * i], p[2 * i + 1], hi[i], lo[i]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, H, hd) bf16 operand, head axis contiguous, as a 4-D tensor map
// (innermost axis first) in boxes of 64 head columns x `rows` rows under the
// 128-byte swizzle (hd 32: 32 columns, the 64-byte swizzle).  TMA takes
// a 16-byte aligned base and strides that are multiples of 16 bytes; the
// stride of an axis of extent 1 is never stepped, so any valid one serves.
// The driver encodes against the calling thread's current context, which a
// thread that has launched nothing yet may lack (PyTorch's autograd worker,
// running a backward first), so the current device's context is made
// current first.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int S,
                       int H, int B, long long ss, long long sh, long long sb,
                       cuuint32_t rows) {
  const EncodeTiled encode = encode_tiled();
  int dev = 0;
  if (encode == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaSetDevice(dev) != cudaSuccess)
    return false;
  const cuuint64_t unit = 2ull * hd;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? 2ull * ss : unit,
                                 H > 1 ? 2ull * sh : unit,
                                 B > 1 ? 2ull * sb : unit};
  const cuuint32_t box[4] = {hd >= 64 ? 64u : (cuuint32_t)hd, rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                hd >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace
