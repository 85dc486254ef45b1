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

// s = the scaled logits of the block's 64 rows (tile sQ) against the key
// tile sK starting at key j0, -inf at keys >= N.
__device__ __forceinline__ void logits(float (&s)[8][4], const bf16* sQ, const bf16* sK, int j0,
                                       int N, float scale) {
  wg_fence();
  dots_async(s, sQ, sK);
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

__global__ void __launch_bounds__(kThreads)
attn_fwd_out_kernel(Operands op, float* __restrict__ stats, int N, int H, float scale) {
  __shared__ __align__(kTileAlign) bf16 smem[5 * kTileElems];
  bf16* sQ = smem;
  bf16* sK = smem + kTileElems;       // two stages
  bf16* sV = smem + 3 * kTileElems;   // two stages
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int tiles_n = (N + kRows - 1) / kRows;
  const bf16* kb = head_base(op.k, op.sk, b, h);
  const bf16* vb = head_base(op.v, op.sv, b, h);

  load_tile_async(sQ, head_base(op.q, op.sq, b, h), op.sq.n, i0, N);
  load_tile_async(sK, kb, op.sk.n, 0, N);
  cp_async_commit();

  // Sweep 1: row max m and sum of exponentials l (per lane, summed over
  // the quad at the end) of rows g and g + 8.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < tiles_n; ++kt) {
    const int cur = (kt & 1) * kTileElems;
    if (kt + 1 < tiles_n) load_tile_async(sK + kTileElems - cur, kb, op.sk.n, (kt + 1) * kRows, N);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    logits(s, sQ, sK + cur, kt * kRows, N, scale);
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

  // Sweep 2: out = bf16(p) @ v.
  load_tile_async(sK, kb, op.sk.n, 0, N);
  load_tile_async(sV, vb, op.sv.n, 0, N);
  cp_async_commit();
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  for (int kt = 0; kt < tiles_n; ++kt) {
    const int cur = (kt & 1) * kTileElems;
    if (kt + 1 < tiles_n) {
      load_tile_async(sK + kTileElems - cur, kb, op.sk.n, (kt + 1) * kRows, N);
      load_tile_async(sV + kTileElems - cur, vb, op.sv.n, (kt + 1) * kRows, N);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    logits(s, sQ, sK + cur, kt * kRows, N, scale);
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * l[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rows_async(o, pa[kk], sV + cur, kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();
  }
  // sQ is free: the last products that read it have completed.
  store_rows(sQ, row0, o, 1.f, head_base(op.out, op.so, b, h), op.so.n, i0, N);
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

}  // namespace
