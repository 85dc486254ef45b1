// Tensor-core tiles shared by the attention kernels (attn_fwd_headmean.cu,
// attn_bwd.cu, attn_pair_fwd.cu): bf16 tiles of 64 rows of 64 values in
// shared memory, filled with cp.async and multiplied with Hopper's warpgroup
// MMA (wgmma.mma_async m64n64k16: bf16 operands, fp32 sums).
//
// An operand of head dim D is kDT = ceil(D / 64) tiles side by side: tile t
// holds its columns [64 t, 64 t + 64), and the columns past D are zeros, so
// they add nothing to q k^T and the columns of p v past D are never stored.
// The pair kernels take D = 64 (kDT = 1); the forward and the backward
// take every multiple of 16 up to 128.
//
// A block is one warpgroup of 4 warps, and every product is 64 x 64:
// warp w owns rows [16 w, 16 w + 16) of it, in eight m16n8 accumulators
// acc[nt][4], where lane l holds rows g = l / 4 and g + 8 at columns
// 8 * nt + 2 * t and + 1 (t = l % 4): acc[nt][0..1] on row g, acc[nt][2..3]
// on row g + 8.
//
// A tile row is 128 bytes: eight 16-byte chunks. Chunk c of row r is
// stored at chunk c ^ (r % 8), in a tile that starts 1024-byte aligned:
// wgmma's 128-byte swizzle, which it reads without bank conflicts both as a
// K-major operand (a row holds 64 depth values of one row of the
// product) and as an MN-major one (a row holds 64 columns at one depth).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // columns of a tile: one 128-byte tile row
constexpr int kRows = 64;      // rows of a tile: query rows or keys
constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileElems = kRows * kD;
constexpr int kTileAlign = 1024;   // the swizzle's period

// Element strides of one (B, N, H, D) operand; D has unit stride.
struct Strides {
  long long b, n, h;
};

// Operand `p` at batch element b, head h: its row n starts at the result
// + n * s.n.
template <typename T>
__device__ __forceinline__ T* head_base(T* p, const Strides& s, int b, int h) {
  return p + (b * s.b + h * s.h);
}

// Element offset of 16-byte chunk c of row r in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) { return r * kD + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first kTileAlign-aligned byte at or after p (dynamic shared memory
// is allocated kTileAlign bytes larger for it).
__device__ __forceinline__ unsigned char* align_tiles(unsigned char* p) {
  return p + ((kTileAlign - (smem_addr(p) & (kTileAlign - 1))) & (kTileAlign - 1));
}

// The kTiles tiles of a kernel in shared memory, 1024-byte aligned: with
// one column tile (kDT = 1) a static array, whose address is a constant,
// and so are the swizzled addresses and wgmma descriptors of its tiles;
// with two (above the 48 KB a static array may take) the dynamic shared
// memory, launched tiles_dynamic_bytes<kTiles, kDT>() large. (Dynamic
// tiles at kDT = 1 were slower on an H100: PERF.md, section 6.)
template <int kTiles, int kDT>
__device__ __forceinline__ bf16* tiles_smem() {
  if constexpr (kDT == 1) {
    __shared__ __align__(kTileAlign) bf16 smem[kTiles * kTileElems];
    return smem;
  } else {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    return reinterpret_cast<bf16*>(align_tiles(smem_raw));
  }
}

template <int kTiles, int kDT>
constexpr size_t tiles_dynamic_bytes() {
  return kDT == 1 ? 0 : kTileAlign + kTiles * kTileElems * sizeof(bf16);
}

// Rows [r0, r0 + 64) of an operand with row stride `stride` into kDT
// swizzled tiles (columns [64 t, 64 t + 64) into tile t), 16 bytes per
// thread and step, without waiting; rows >= n and columns >= d (a multiple
// of 8) are filled with zeros.
template <int kDT = 1>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* base, long long stride,
                                                int r0, int n, int d = kD) {
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    for (int idx = threadIdx.x; idx < kRows * 8; idx += kThreads) {
      const int r = idx >> 3, c = idx & 7, row = r0 + r, col = t * kD + c * 8;
      const bool in = row < n && col < d;
      const bf16* src = base + (in ? row * stride + col : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(tile + t * kTileElems + swz(r, c))),
                   "l"(src), "r"(in ? 16 : 0));
    }
  }
}

// kCount floats into dst, 4 bytes per thread and step with cp.async,
// without waiting: src[0, n) and zeros after.
template <int kCount>
__device__ __forceinline__ void load_floats_async(float* dst, const float* src, int n) {
  for (int idx = threadIdx.x; idx < kCount; idx += kThreads) {
    const bool in = idx < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + idx)),
                 "l"(src + (in ? idx : 0)), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most `kPending` committed groups of this thread's copies
// are in flight, then make its copies visible to wgmma (the async proxy).
// A __syncthreads() must follow before another thread's tiles are read.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- warpgroup MMA --------------------------------------------------------
// A batch of wgmma: wg_fence(), the products, wg_commit(), wg_wait<0>(),
// then fence_regs() on every accumulator and register operand of the batch
// (the compiler does not know that the products run after their issue).

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <int kNt>
__device__ __forceinline__ void fence_regs(float (&x)[kNt][4]) {
#pragma unroll
  for (int i = 0; i < kNt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

// Shared-memory descriptor of a swizzled tile for wgmma, `offset` bytes
// from its start: 128-byte swizzle, 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile, uint32_t offset) {
  const uint32_t addr = smem_addr(tile) + offset;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= a x b^T over one 16-value depth slice, 64 x 8 kNt: a and b
// K-major tiles in shared memory (descriptors); `accumulate` 0 overwrites d.
template <int kNt>
__device__ __forceinline__ void wgmma_ss(float (&d)[kNt][4], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<4>(float (&d)[4][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a x b over one 16-value depth slice: a from registers (each warp its
// 16 rows, as to_a makes them), b an MN-major tile in shared memory (its
// rows are the depth, its 64 values per row the columns of d).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Issue acc = a x b^T over the kDT tiles of depth, 64 x 8 kNt: the rows of
// tiles a against the 8 kNt rows of tiles b from row b_row0 (a multiple of
// 8; both K-major).
template <int kNt, int kDT = 1>
__device__ __forceinline__ void dots_async(float (&acc)[kNt][4], const bf16* a, const bf16* b,
                                           int b_row0 = 0) {
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<kNt>(acc, tile_desc(a + t * kTileElems, 32 * kk),
                    tile_desc(b + t * kTileElems, b_row0 * 128 + 32 * kk), 4 * t + kk);
}

// Issue acc += a x tile rows [16 kk, 16 kk + 16): a is depth slice kk of a
// 64 x 64 left factor, the tile the right factor (MN-major).
__device__ __forceinline__ void mma_rows_async(float (&acc)[8][4], const uint32_t (&a)[4],
                                               const bf16* tile, int kk) {
  wgmma_rs(acc, a, tile_desc(tile, 2048 * kk));
}

// Two bf16 values in one register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of depth slice kk (columns [16 kk, 16 kk + 16)) of a
// warp's 16 x 64 fp32 product x, rounded to bf16: to_a(a, x[2 kk], x[2 kk + 1]).
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x0)[4],
                                     const float (&x1)[4]) {
  a[0] = pack(x0[0], x0[1]);
  a[1] = pack(x0[2], x0[3]);
  a[2] = pack(x1[0], x1[1]);
  a[3] = pack(x1[2], x1[3]);
}

// x = hi + lo to about 2^-17: hi = bf16(x), lo = bf16(x - hi), both as
// A operands of depth slice (x0, x1).
__device__ __forceinline__ void to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&x0)[4], const float (&x1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r0[e] = x0[e] - __bfloat162float(__float2bfloat16(x0[e]));
    r1[e] = x1[e] - __bfloat162float(__float2bfloat16(x1[e]));
  }
  to_a(hi, x0, x1);
  to_a(lo, r0, r1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's 16 x 64 fp32 result times `mul`, rounded once to bf16, into
// rows [row0, row0 + 16) of a swizzled tile, then copied 16 bytes per lane
// to the rows r0 + row0 + r < n of an operand with row stride `stride`,
// columns [0, cols) (a multiple of 8). Only the calling warp touches those
// tile rows.
__device__ __forceinline__ void store_rows(bf16* tile, int row0, const float (&acc)[8][4],
                                           float mul, bf16* base, long long stride, int r0,
                                           int n, int cols = kD) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(tile + swz(row0 + g, nt) + 2 * t) =
        pack(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + swz(row0 + g + 8, nt) + 2 * t) =
        pack(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * 8; idx += 32) {
    const int r = row0 + (idx >> 3), c = idx & 7, row = r0 + r;
    if (row < n && c * 8 < cols)
      *reinterpret_cast<uint4*>(base + row * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(r, c));
  }
}

}  // namespace tiles
