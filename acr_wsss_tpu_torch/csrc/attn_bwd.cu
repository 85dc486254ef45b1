// Attention backward over strided q, k and v: the softmax gradient with a
// cotangent `de` of the head-mean probabilities, in two forms, on the
// tensor cores.
//
// Replaces TPU kernels of acr_wsss_tpu/ops/attn_pallas.py:
//   _bwd_kernel_nhd  (K1b through _bwd_qkv_cols, K5b through _bwd_nhd),
//   _bwd_kernel_qkv  (K5c through _bwd_qkv) and
//   _bwd_kernel      (K5a through _bwd): de is a dense (B, N, N) tensor in
//                    fp32 or bf16 (the cotangent of a bf16 export, upcast
//                    here as the TPU kernels upcast it), or none (zero);
//                    q, k, v, g and dq, dk, dv are strided (B, N, H, D)
//                    operands, as in attn_fwd_headmean.cu;
//   _bwd_kernel_pair (K2b, through _bwd_pair): de is formed here from the
//                    int8 sign tile of the pair forward (attn_pair_fwd.cu)
//                    and the per-pair cotangents g_cls (row 0) and g_aff
//                    (rows >= 1), + for the view (even b), - for its
//                    mirror (odd b).
//
// Function, for each batch element b and head h, with p the exact fp32
// softmax(q_h k_h^T * scale) recomputed here and g the cotangent of out:
//   dp = g_h v_h^T + de / H
//   ds = p * (dp - rowsum(dp * p))
//   dq_h = ds k_h * scale,  dk_h = ds^T q_h * scale,  dv_h = p^T g_h
// written as bf16 into dq, dk and dv (for the pair entry: dqkv (B, N,
// 3*H*D) in the column layout of qkv). The arithmetic is fp32, as both TPU
// kernels run it (`mm = float32`, and the pair kernel casts g to fp32);
// rows and keys past N are masked, and N has no limit.
//
// Bound on the card at the training shape (B = 8, H = 12, N = 577, D = 64):
// 5 products of 2*B*H*N^2*D = 20.5 GFLOP (20.7 us at 989 TFLOP/s bf16);
// bytes: qkv 21.27 MB + g 7.09 MB read, dqkv 21.27 MB written, plus the
// sign tile 1.33 MB (pair: 51.0 MB, 15.2 us) or a dense de 10.65 MB
// (60.3 MB, 18.0 us at 3.35 TB/s). The operations set the bound: 20.7 us.
//
// Design: the products run on the tensor cores (wgmma m64n64k16 of one
// warpgroup, fp32 sums; attn_tiles.cuh). q, k, v and g are bf16, so the logits and
// g v^T are exact products summed in fp32. p and ds are fp32: each is fed
// to the tensor cores as two bf16 parts, hi = bf16(x) and lo = bf16(x -
// hi), which carry x to about 2^-17 (one bf16 part alone misses the
// gradient tolerance; tests/test_torch_attn_rounding.py). Two passes, as
// a flash-attention backward, so that no sum crosses blocks and no float
// atomics are needed; the result is the same from run to run.
//   Row pass, one block of 4 warps per (64 query rows, head, b): K and V
//   stream in tiles of 64 keys (cp.async, double-buffered). Sweep 1 keeps
//   the row max, the sum of exponentials and the sum of exp * dp (both
//   rescaled when the max grows), so c = rowsum(dp * p) = that sum / the
//   sum of exponentials. Sweep 2 recomputes p and ds and sums ds k. It
//   writes dq and saves (max, 1 / sum, c) per row: (B, H, N, 3) fp32
//   scratch.
//   Key pass, one block per (64 keys, head, b): walks the query tiles,
//   computes S^T = k q^T and dp^T = v g^T for its keys, forms p and ds
//   from the saved statistics, and sums p^T g and ds^T q in registers. It
//   takes each query tile in two halves of 32 rows, so that one half's
//   products run while the other's p and ds are formed, and is held to
//   168 registers, so that three blocks fit on an SM.
// de streams with the key (row pass) or query (key pass) tiles: each row
// of a 64 x 64 tile of de in 16-byte cp.async chunks into shared memory,
// as it lies (fp32, bf16 or int8, not 16-byte aligned), read from there
// where dp needs it and converted to fp32 de / H. p = exp(s - max) *
// (1 / sum), with the fast exponential (2 ulp, plus 2^-23 |s - max|
// relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace {

using namespace tiles;

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

// The source of de, a template argument of the kernels.
enum DeKind { kDeNone = 0, kDeF32 = 1, kDeBF16 = 2, kDeSign = 3 };

struct DeSource {
  const void* dense;      // (B, N, N) fp32 or bf16 cotangent of the head mean
  const int8_t* sign;     // (B / 2, N, N) int8 sign tile
  const float* g_cls;     // (B / 2,) fp32
  const float* g_aff;     // (B / 2,) fp32
  float inv_h;
};

template <int kDe>
__host__ __device__ constexpr int de_bytes() {
  return kDe == kDeF32 ? 4 : kDe == kDeBF16 ? 2 : 1;
}

// Bytes of one row of a raw de tile: 64 keys and up to 15 bytes before
// the first, which is where its 16-byte chunk starts.
template <int kDe>
__host__ __device__ constexpr int raw_row() {
  return kRows * de_bytes<kDe>() + 16;
}

// Bytes of one stage of a raw de tile in shared memory: its rows, then
// the offset of each row's first key (int).
template <int kDe>
__host__ __device__ constexpr int raw_stage() {
  return kRows * raw_row<kDe>() + kRows * (int)sizeof(int);
}

// Bytes of the two stages of raw de tiles.
template <int kDe>
__host__ __device__ constexpr int raw_stages() {
  return kDe == kDeNone ? 0 : 2 * raw_stage<kDe>();
}

template <int kDe>
__device__ __forceinline__ int* raw_offs(unsigned char* stage) {
  return reinterpret_cast<int*>(stage + kRows * raw_row<kDe>());
}

// First byte of de at (b, i, j0): row i of batch element b (the sign tile
// of pair b / 2).
template <int kDe>
__device__ __forceinline__ const unsigned char* de_row(const DeSource& s, int b, int i, int j0,
                                                      int N) {
  constexpr int es = de_bytes<kDe>();
  const unsigned char* base =
      kDe == kDeSign ? reinterpret_cast<const unsigned char*>(s.sign) + (size_t)(b >> 1) * N * N
                     : static_cast<const unsigned char*>(s.dense) + (size_t)b * N * N * es;
  return base + ((size_t)i * N + j0) * es;
}

// The bytes of de at rows [i0, i0 + 64) and keys [j0, j0 + 64) into a raw
// tile, 16-byte chunks with cp.async, without waiting: each row from the
// aligned chunk that holds its first key (a row of de is not 16-byte
// aligned unless N is a multiple of 16 / bytes). offs[r] gets the offset
// of row r's first key in its chunk.
template <int kDe>
__device__ __forceinline__ void load_de_async(unsigned char* raw, int* offs, const DeSource& s,
                                              int b, int i0, int j0, int N) {
  constexpr int kChunks = raw_row<kDe>() / 16;
  const int end = min(kRows, N - j0) * de_bytes<kDe>();
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, i = i0 + r;
    const unsigned char* first = de_row<kDe>(s, b, min(i, N - 1), j0, N);
    const int off = (int)(reinterpret_cast<uintptr_t>(first) & 15);
    const unsigned char* chunk = first - off + 16 * c;
    const bool in = i < N && chunk < first + end;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(raw + r * raw_row<kDe>() + 16 * c)),
                 "l"(in ? chunk : first - off), "r"(in ? 16 : 0));
    if (c == 0) offs[r] = off;
  }
}

// de / H from its bytes `at` in a raw tile, at query row i of batch
// element b; g_sel holds the pair's g_cls and g_aff for a sign tile.
template <int kDe>
__device__ __forceinline__ float de_value(const unsigned char* at, const DeSource& s,
                                          float2 g_sel, int b, int i) {
  if constexpr (kDe == kDeSign) {
    const float sg = (float)*reinterpret_cast<const int8_t*>(at);
    const float v = __fmul_rn(__fmul_rn(sg, i == 0 ? g_sel.x : g_sel.y), s.inv_h);
    return (b & 1) ? -v : v;
  } else if constexpr (kDe == kDeF32) {
    return __fmul_rn(*reinterpret_cast<const float*>(at), s.inv_h);
  } else {
    return __fmul_rn(__bfloat162float(*reinterpret_cast<const bf16*>(at)), s.inv_h);
  }
}

template <int kDe>
__device__ __forceinline__ float2 pair_cotangents(const DeSource& s, int b) {
  if constexpr (kDe == kDeSign) return make_float2(s.g_cls[b >> 1], s.g_aff[b >> 1]);
  return make_float2(0.f, 0.f);
}

// Row pass. stats (B, H, N, 3): row max, 1 / row sum of exp, c.
template <int kDe>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(Operands op, DeSource de, float* __restrict__ stats, int N, int H,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* sG = sQ + kTileElems;
  bf16* sK = sG + kTileElems;       // two stages
  bf16* sV = sK + 2 * kTileElems;   // two stages
  unsigned char* sRaw = reinterpret_cast<unsigned char*>(sV + 2 * kTileElems);   // two stages
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles_n = (N + kRows - 1) / kRows;
  const bf16* kb = head_base(op.k, op.sk, b, h);
  const bf16* vb = head_base(op.v, op.sv, b, h);
  const float2 g_sel = pair_cotangents<kDe>(de, b);

  load_tile_async(sQ, head_base(op.q, op.sq, b, h), op.sq.n, i0, N);
  load_tile_async(sG, head_base(op.g, op.sg, b, h), op.sg.n, i0, N);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  // The first sweep keeps the statistics, the second sums dq.
  for (int sweep = 0; sweep < 2; ++sweep) {
    load_tile_async(sK, kb, op.sk.n, 0, N);
    load_tile_async(sV, vb, op.sv.n, 0, N);
    if constexpr (kDe != kDeNone) load_de_async<kDe>(sRaw, raw_offs<kDe>(sRaw), de, b, i0, 0, N);
    cp_async_commit();
    for (int kt = 0; kt < tiles_n; ++kt) {
      const int cur = (kt & 1) * kTileElems, j0 = kt * kRows;
      if (kt + 1 < tiles_n) {
        load_tile_async(sK + kTileElems - cur, kb, op.sk.n, j0 + kRows, N);
        load_tile_async(sV + kTileElems - cur, vb, op.sv.n, j0 + kRows, N);
        if constexpr (kDe != kDeNone) {
          unsigned char* nxt = sRaw + (~kt & 1) * raw_stage<kDe>();
          load_de_async<kDe>(nxt, raw_offs<kDe>(nxt), de, b, i0, j0 + kRows, N);
        }
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[8][4], dp[8][4];
      wg_fence();
      dots_async(s, sQ, sK + cur);
      dots_async(dp, sG, sV + cur);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // The de bytes of the lane's rows g and g + 8 at key 2 t.
      const unsigned char* de_at[2] = {nullptr, nullptr};
      if constexpr (kDe != kDeNone) {
        unsigned char* stage = sRaw + (kt & 1) * raw_stage<kDe>();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = row0 + g + 8 * r;
          de_at[r] = stage + rr * raw_row<kDe>() + raw_offs<kDe>(stage)[rr] + 2 * t * de_bytes<kDe>();
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = j0 + 8 * nt + 2 * t + (e & 1) < N;
          s[nt][e] = in ? __fmul_rn(s[nt][e], scale) : -CUDART_INF_F;
          // Keys past N read bytes of the next row or zeros: p = 0 there.
          if constexpr (kDe != kDeNone) {
            const float d = de_value<kDe>(de_at[e >> 1] + (8 * nt + (e & 1)) * de_bytes<kDe>(),
                                          de, g_sel, b, i0 + row0 + g + 8 * (e >> 1));
            dp[nt][e] = __fadd_rn(dp[nt][e], in ? d : 0.f);
          }
        }
      }
      if (sweep == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
          mx = quad_max(mx);
          const float corr = __expf(m[r] - mx);
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float x = __expf(s[nt][e] - mx);
              sum += x;
              dsum += x * dp[nt][e];
            }
          }
          l[r] = l[r] * corr + sum;
          c[r] = c[r] * corr + dsum;
          m[r] = mx;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[nt][e] - m[e >> 1]) * l[e >> 1];
            s[nt][e] = p * (dp[nt][e] - c[e >> 1]);   // ds
          }
        }
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a_split(hi[kk], lo[kk], s[2 * kk], s[2 * kk + 1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_rows_async(dq, hi[kk], sK + cur, kk);
          mma_rows_async(dq, lo[kk], sK + cur, kk);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(dq);
        fence_regs(hi);
        fence_regs(lo);
      }
      __syncthreads();
    }
    if (sweep == 0) {
      // From here on l holds 1 / the sum of exponentials.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = 1.f / quad_sum(l[r]);
        c[r] = quad_sum(c[r]) * l[r];
      }
    }
  }
  // sQ is free: the last products that read it have completed.
  store_rows(sQ, row0, dq, scale, head_base(op.dq, op.sdq, b, h), op.sdq.n, i0, N);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + row0 + g + 8 * r;
      if (i < N) {
        float* st = stats + (((size_t)b * H + h) * N + i) * 3;
        st[0] = m[r];
        st[1] = l[r];
        st[2] = c[r];
      }
    }
  }
}

// Key pass: dk and dv of 64 keys of one head, summed over all query rows.
template <int kDe>
__global__ void __launch_bounds__(kThreads, 3)
attn_bwd_keys_kernel(Operands op, DeSource de, const float* __restrict__ stats, int N, int H,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* sV = sK + kTileElems;
  bf16* sQ = sV + kTileElems;       // two stages
  bf16* sG = sQ + 2 * kTileElems;   // two stages
  unsigned char* sRaw = reinterpret_cast<unsigned char*>(sG + 2 * kTileElems);   // two stages
  float* sStat = reinterpret_cast<float*>(sRaw + raw_stages<kDe>());  // two stages
  const int warp = threadIdx.x >> 5, key0 = warp * 16;
  const int j0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles_n = (N + kRows - 1) / kRows;
  const bf16* qb = head_base(op.q, op.sq, b, h);
  const bf16* gb = head_base(op.g, op.sg, b, h);
  const float* stats_bh = stats + ((size_t)b * H + h) * N * 3;
  const float2 g_sel = pair_cotangents<kDe>(de, b);

  load_tile_async(sK, head_base(op.k, op.sk, b, h), op.sk.n, j0, N);
  load_tile_async(sV, head_base(op.v, op.sv, b, h), op.sv.n, j0, N);
  load_tile_async(sQ, qb, op.sq.n, 0, N);
  load_tile_async(sG, gb, op.sg.n, 0, N);
  load_floats_async<kRows * 3>(sStat, stats_bh, min(kRows, N) * 3);
  if constexpr (kDe != kDeNone) load_de_async<kDe>(sRaw, raw_offs<kDe>(sRaw), de, b, 0, j0, N);
  cp_async_commit();
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int it = 0; it < tiles_n; ++it) {
    const int cur = (it & 1) * kTileElems, i0 = it * kRows;
    const float* st_tile = sStat + (it & 1) * kRows * 3;
    if (it + 1 < tiles_n) {
      const int nxt = ~it & 1;
      load_tile_async(sQ + kTileElems - cur, qb, op.sq.n, i0 + kRows, N);
      load_tile_async(sG + kTileElems - cur, gb, op.sg.n, i0 + kRows, N);
      load_floats_async<kRows * 3>(sStat + nxt * kRows * 3, stats_bh + (size_t)(i0 + kRows) * 3,
                                   min(kRows, N - i0 - kRows) * 3);
      if constexpr (kDe != kDeNone) {
        unsigned char* stage = sRaw + nxt * raw_stage<kDe>();
        load_de_async<kDe>(stage, raw_offs<kDe>(stage), de, b, i0 + kRows, j0, N);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    unsigned char* de_tile = sRaw + (it & 1) * raw_stage<kDe>();
    // S^T and dp^T of the block's 64 keys against the tile's query rows,
    // in two halves of 32: the second half's products run while the first
    // half's p and ds are formed, the first half's dv and dk products while
    // the second's are.
    float s[2][4][4], dp[2][4][4];
    wg_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      dots_async(s[half], sK, sQ + cur, 32 * half);
      dots_async(dp[half], sV, sG + cur, 32 * half);
      wg_commit();
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      wg_wait<1>();
      fence_regs(s[half]);
      fence_regs(dp[half]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // Row r of the tile; rows past N have zero statistics and are
          // masked, keys past N read bytes that are never written back.
          const int r = 32 * half + 8 * nt + 2 * t + (e & 1);
          const float* st = st_tile + 3 * r;
          float d = dp[half][nt][e];
          if constexpr (kDe != kDeNone)
            d = __fadd_rn(d, de_value<kDe>(de_tile + r * raw_row<kDe>() +
                                               raw_offs<kDe>(de_tile)[r] +
                                               (key0 + g + 8 * (e >> 1)) * de_bytes<kDe>(),
                                           de, g_sel, b, i0 + r));
          const float p =
              i0 + r < N ? __expf(__fmul_rn(s[half][nt][e], scale) - st[0]) * st[1] : 0.f;
          s[half][nt][e] = p;
          dp[half][nt][e] = p * (d - st[2]);
        }
      }
      // p^T and ds^T as A operands (depth = the tile's rows), hi and lo.
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * half + k2;
        to_a_split(p_hi[kk], p_lo[kk], s[half][2 * k2], s[half][2 * k2 + 1]);
        to_a_split(ds_hi[kk], ds_lo[kk], dp[half][2 * k2], dp[half][2 * k2 + 1]);
      }
      wg_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * half + k2;
        mma_rows_async(dv, p_hi[kk], sG + cur, kk);
        mma_rows_async(dv, p_lo[kk], sG + cur, kk);
        mma_rows_async(dk, ds_hi[kk], sQ + cur, kk);
        mma_rows_async(dk, ds_lo[kk], sQ + cur, kk);
      }
      wg_commit();
    }
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncthreads();
  }
  // sK and sV are free: the last products that read them have completed.
  store_rows(sK, key0, dk, scale, head_base(op.dk, op.sdk, b, h), op.sdk.n, j0, N);
  store_rows(sV, key0, dv, 1.f, head_base(op.dv, op.sdv, b, h), op.sdv.n, j0, N);
}

template <int kDe>
constexpr size_t rows_smem() {
  return kTileAlign + 6 * kTileElems * sizeof(bf16) + raw_stages<kDe>();
}

template <int kDe>
constexpr size_t keys_smem() {
  return kTileAlign + 6 * kTileElems * sizeof(bf16) + raw_stages<kDe>() +
         2 * kRows * 3 * sizeof(float);
}

template <int kDe>
int launch_kind(const Operands& op, const DeSource& de, float* stats, int B, int N, int H,
                float scale, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_kernel<kDe>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)rows_smem<kDe>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_keys_kernel<kDe>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)keys_smem<kDe>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  attn_bwd_rows_kernel<kDe><<<grid, kThreads, rows_smem<kDe>(), s>>>(op, de, stats, N, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_keys_kernel<kDe><<<grid, kThreads, keys_smem<kDe>(), s>>>(op, de, stats, N, H, scale);
  return (int)cudaGetLastError();
}

int launch(const Operands& op, int kind, const DeSource& de, void* stats, int B, int N, int H,
           int D, float scale, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case kDeNone: return launch_kind<kDeNone>(op, de, st, B, N, H, scale, s);
    case kDeF32: return launch_kind<kDeF32>(op, de, st, B, N, H, scale, s);
    case kDeBF16: return launch_kind<kDeBF16>(op, de, st, B, N, H, scale, s);
    default: return launch_kind<kDeSign>(op, de, st, B, N, H, scale, s);
  }
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// K1b, K5a-c. q, k, v, g: bf16 (B, N, H, D) operands; dq, dk, dv: bf16
// (B, N, H, D) outputs; `strides` holds 21 element strides, (batch, token,
// head) of q, k, v, g, dq, dk and dv in that order; D has unit stride and
// every row of D values starts 16-byte aligned. de: contiguous (B, N, N)
// of `de_dtype` (1 fp32, 2 bf16), or null with de_dtype 0 for zero.
// stats: (B, H, N, 3) fp32 scratch. Returns cudaGetLastError().
int attn_bwd_dense(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const long long* strides, const void* de, int de_dtype,
                   void* stats, int B, int N, int H, int D, float scale, void* stream) {
  if (de_dtype < 0 || de_dtype > 2 || (de == nullptr) != (de_dtype == 0))
    return (int)cudaErrorInvalidValue;
  const Operands op{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    strides_at(strides), strides_at(strides + 3), strides_at(strides + 6),
                    strides_at(strides + 9), strides_at(strides + 12),
                    strides_at(strides + 15), strides_at(strides + 18)};
  const DeSource src{de, nullptr, nullptr, nullptr, 1.0f / (float)H};
  return launch(op, de_dtype, src, stats, B, N, H, D, scale, stream);
}

// K2b. qkv (B, N, 3*H*D) bf16, g (B, N, H*D) bf16, dqkv (B, N, 3*H*D) bf16
// out, all contiguous and 16-byte aligned; de formed from sign (B / 2, N,
// N) int8 and g_cls, g_aff (B / 2,) fp32; B even, pairs interleaved.
int attn_bwd_pair(const void* qkv, const void* g, const void* sign, const void* g_cls,
                  const void* g_aff, void* dqkv, void* stats, int B, int N, int H, int D,
                  float scale, void* stream) {
  if (B % 2 || sign == nullptr || g_cls == nullptr || g_aff == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long HD = (long long)H * D;
  const Strides cols{N * 3 * HD, 3 * HD, D}, rows{N * HD, HD, D};
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const Operands op{in, in + HD, in + 2 * HD, static_cast<const bf16*>(g),
                    out, out + HD, out + 2 * HD, cols, cols, cols, rows, cols, cols, cols};
  const DeSource src{nullptr, static_cast<const int8_t*>(sign),
                     static_cast<const float*>(g_cls), static_cast<const float*>(g_aff),
                     1.0f / (float)H};
  return launch(op, kDeSign, src, stats, B, N, H, D, scale, stream);
}

const char* attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
