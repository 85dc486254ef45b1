// The attention forward's out kernel, shared by attn_fwd_headmean.cu (K1,
// K5 forwards) and attn_pair_fwd.cu (K2f): one warpgroup block per (64
// query rows, head, b) computes
//   out[b, :, h] = bf16( bf16(softmax(q_h k_h^T * scale)) v_h )
// over strided (B, N, H, D) operands, and with a non-null `stats` saves
// each row's (max, 1 / sum of exponentials) to a (B, H, N, 2) fp32
// scratch, from which a second kernel recomputes p = exp(s - max) * (1 /
// sum) tile by tile.
//
// K and V stream through shared memory in tiles of 64 keys,
// double-buffered with cp.async. Sweep 1 over the key tiles keeps the row
// max and the sum of exponentials (rescaled when the max grows); sweep 2
// recomputes S, forms p, rounds it to bf16 in registers and sums p @ v on
// the tensor cores (wgmma, attn_tiles.cuh). The exponential is the fast
// one (__expf: 2 ulp, plus 2^-23 |s - max| relative). Rows and keys past
// N are masked: no padding of N and no limit on it.
//
// Head dim: the template's kDT tiles of 64 columns hold D <= 64 kDT, the
// columns past D zero-filled (attn_tiles.cuh). The pair forward runs kDT =
// 1 at D = 64; the head-mean forward kDT = 1 for D <= 64 and 2 up to 128.
// For D < 64 kDT the zeros cost products: 64 kDT / D times those of q k^T
// and of p v (1.33x at D = 48 and 96, 1.6x at 80, 2x at 32).
//
// Everything here has internal linkage: each source that includes it is
// its own library, and none exports these symbols to another.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attn_tiles.cuh"

namespace {

using namespace tiles;

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  Strides sq, sk, sv, so;
};

// s = the scaled logits of the block's 64 rows (the kDT tiles at sQ)
// against the key tiles at sK starting at key j0, -inf at keys >= N. The
// scale multiplies the float32 sums: D^-0.5 is not a power of two for most
// head dims, so folding it into bf16 q would round q once more.
template <int kDT = 1>
__device__ __forceinline__ void logits(float (&s)[8][4], const bf16* sQ, const bf16* sK, int j0,
                                       int N, float scale) {
  wg_fence();
  dots_async<8, kDT>(s, sQ, sK);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = j0 + 8 * nt + 2 * t + (e & 1) < N ? __fmul_rn(s[nt][e], scale) : -CUDART_INF_F;
}

// Tiles of the out kernel: Q, two stages of K and of V, each kDT tiles.
template <int kDT>
constexpr int kOutTiles = 5 * kDT;

// Head dim D <= 64 kDT: the operands' columns past D are zero-filled tiles.
template <int kDT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_out_kernel(Operands op, float* __restrict__ stats, int N, int H, int D, float scale) {
  constexpr int kOp = kDT * kTileElems;   // one operand's tiles
  bf16* sQ = tiles_smem<kOutTiles<kDT>, kDT>();
  bf16* sK = sQ + kOp;       // two stages
  bf16* sV = sK + 2 * kOp;   // two stages
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int tiles_n = (N + kRows - 1) / kRows;
  const bf16* kb = head_base(op.k, op.sk, b, h);
  const bf16* vb = head_base(op.v, op.sv, b, h);

  load_tile_async<kDT>(sQ, head_base(op.q, op.sq, b, h), op.sq.n, i0, N, D);
  load_tile_async<kDT>(sK, kb, op.sk.n, 0, N, D);
  cp_async_commit();

  // Sweep 1: row max m and sum of exponentials l (per lane, summed over
  // the quad at the end) of rows g and g + 8.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < tiles_n; ++kt) {
    const int cur = (kt & 1) * kOp;
    if (kt + 1 < tiles_n)
      load_tile_async<kDT>(sK + kOp - cur, kb, op.sk.n, (kt + 1) * kRows, N, D);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    logits<kDT>(s, sQ, sK + cur, kt * kRows, N, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        sum += __expf(s[nt][2 * r] - mx) + __expf(s[nt][2 * r + 1] - mx);
      l[r] = l[r] * __expf(m[r] - mx) + sum;
      m[r] = mx;
    }
    __syncthreads();
  }
  // From here on l holds 1 / the sum of exponentials.
  l[0] = 1.f / quad_sum(l[0]);
  l[1] = 1.f / quad_sum(l[1]);

  // Sweep 2: out = bf16(p) @ v, one 64-column accumulator per tile of v.
  load_tile_async<kDT>(sK, kb, op.sk.n, 0, N, D);
  load_tile_async<kDT>(sV, vb, op.sv.n, 0, N, D);
  cp_async_commit();
  float o[kDT][8][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) o[t][nt][0] = o[t][nt][1] = o[t][nt][2] = o[t][nt][3] = 0.f;
  for (int kt = 0; kt < tiles_n; ++kt) {
    const int cur = (kt & 1) * kOp;
    if (kt + 1 < tiles_n) {
      load_tile_async<kDT>(sK + kOp - cur, kb, op.sk.n, (kt + 1) * kRows, N, D);
      load_tile_async<kDT>(sV + kOp - cur, vb, op.sv.n, (kt + 1) * kRows, N, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    logits<kDT>(s, sQ, sK + cur, kt * kRows, N, scale);
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * l[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wg_fence();
#pragma unroll
    for (int t = 0; t < kDT; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rows_async(o[t], pa[kk], sV + cur + t * kTileElems, kk);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int t = 0; t < kDT; ++t) fence_regs(o[t]);
    fence_regs(pa);
    __syncthreads();
  }
  // sQ is free: the last products that read it have completed. Tile t of
  // it stages columns [64 t, 64 t + 64) of out; those past D are not stored.
  bf16* ob = head_base(op.out, op.so, b, h);
#pragma unroll
  for (int t = 0; t < kDT; ++t)
    store_rows(sQ + t * kTileElems, row0, o[t], 1.f, ob + t * kD, op.so.n, i0, N, D - t * kD);
  if (stats != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + row0 + g + 8 * r;
      if (i < N) {
        float* st = stats + (((size_t)b * H + h) * N + i) * 2;
        st[0] = m[r];
        st[1] = l[r];
      }
    }
  }
}

// One launch of the out kernel over (64-row tiles, heads, batch) on `s`.
template <int kDT>
cudaError_t launch_out(const Operands& op, float* stats, int B, int N, int H, int D, float scale,
                       cudaStream_t s) {
  constexpr size_t bytes = tiles_dynamic_bytes<kOutTiles<kDT>, kDT>();
  if (bytes > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_out_kernel<kDT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  attn_fwd_out_kernel<kDT><<<dim3((N + kRows - 1) / kRows, H, B), kThreads, bytes, s>>>(
      op, stats, N, H, D, scale);
  return cudaGetLastError();
}

}  // namespace
