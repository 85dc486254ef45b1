// Attention forward over strided q, k and v, with the head mean of the
// softmax probabilities as a second output (fp32, bf16, or none), on the
// tensor cores.
//
// Replaces the TPU kernels of acr_wsss_tpu/ops/attn_pallas.py:
//   _fwd_kernel_nhd          (K1f through _fwd_qkv_cols; K5b through _fwd_nhd)
//   _fwd_kernel_nhd_noexport (K1n through _fwd_qkv_cols_noexport: null probs)
//   _fwd_kernel_qkv          (K5c through _fwd_qkv)
//   _fwd_kernel              (K5a through _fwd: (B, H, N, D) operands)
// Each layout is one set of element strides (batch, token, head) for q, k,
// v and out, with a unit stride on D:
//   qkv column views and the joint (B, N, 3, H*D) view (K1, K5c): q = qkv,
//     k = qkv + H*D, v = qkv + 2*H*D, token stride 3*H*D, head stride D;
//   split (B, N, H*D) tensors (K5b): token stride H*D, head stride D;
//   (B, H, N, D) tensors (K5a): token stride D, head stride N*D.
//
// Function, for each batch element b and head h:
//   out[b, :, h] = bf16( bf16(softmax(q_h k_h^T * scale)) v_h )
//   probs[b]     = mean_h softmax(q_h k_h^T * scale)
// Products of bf16 values are summed in fp32; the softmax is exact (the
// row max is subtracted, p = exp(s - max) * (1 / sum), with the fast
// exponential: 2 ulp, plus 2^-23 |s - max| relative) and runs in fp32. The
// head mean is summed in fp32 over the heads in order and rounded once
// when it is written: to bf16 for a bf16 export, as the TPU kernels cast
// their fp32 accumulator once. Rows and keys past N are masked: there is
// no padding of N and no limit on it.
//
// Bound on the card: at the inference shape (B=2, H=12, N=577, D=64) the
// function does 4*B*H*N^2*D = 2.05 GFLOP (2.1 us at 989 TFLOP/s bf16) and
// must move 9.7 MB (qkv read 5.3 MB, out written 1.8 MB, probs written
// 2.7 MB: 2.9 us at 3.35 TB/s), so memory sets the bound; at the training
// shape (B=8) 8.18 GFLOP and 39.0 MB (33.7 MB with a bf16 export).
//
// Design: the products run on the tensor cores (wgmma m64n64k16 of one
// warpgroup, bf16 operands, fp32 sums; attn_tiles.cuh), in two kernels.
//   Out kernel (attn_fwd_out.cuh, shared with the pair forward,
//   attn_pair_fwd.cu), one block of 4 warps per (64 query rows, head, b): K and V
//   stream through shared memory in tiles of 64 keys, double-buffered with
//   cp.async. Sweep 1 over the key tiles keeps the row max and the sum of
//   exponentials (rescaled when the max grows); sweep 2 recomputes S,
//   forms p = exp(s - max) * (1 / sum), rounds it to bf16 in registers,
//   and sums p @ v. With an export it saves (max, 1 / sum) per row and
//   head: (B, H, N, 2) fp32 scratch.
//   Probs kernel, one block per (64 query rows, 64 keys, b): loops over
//   the heads in order, recomputes its S tile, forms p from the saved
//   statistics, and sums p in registers; it writes each probs element
//   once. No atomics, no N-wide tile: the result is the same from run to
//   run, and the heads of one image spread over many blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attn_fwd_out.cuh"

namespace {

using namespace tiles;

// Probability export codes of the C interface.
constexpr int kProbsNone = 0, kProbsF32 = 1, kProbsBF16 = 2;
constexpr int kStage = kRows + 8;  // fp32 row of the staged probs tile

__global__ void __launch_bounds__(kThreads)
attn_fwd_probs_kernel(Operands op, const float* __restrict__ stats, void* __restrict__ probs,
                      int probs_dtype, int N, int H, float scale) {
  // Two stages of (Q, K) tiles; after the head loop, the fp32 probs tile.
  __shared__ __align__(kTileAlign) bf16 smem[4 * kTileElems];
  __shared__ float sSt[2][kRows * 2];   // two stages of the rows' (max, 1 / sum)
  bf16* sQ = smem;
  bf16* sK = smem + 2 * kTileElems;
  const int i0 = blockIdx.x * kRows, j0 = blockIdx.y * kRows, b = blockIdx.z;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2;

  const int rows = min(kRows, N - i0);
  load_tile_async(sQ, head_base(op.q, op.sq, b, 0), op.sq.n, i0, N);
  load_tile_async(sK, head_base(op.k, op.sk, b, 0), op.sk.n, j0, N);
  load_floats_async<kRows * 2>(sSt[0], stats + ((size_t)b * H * N + i0) * 2, rows * 2);
  cp_async_commit();
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int h = 0; h < H; ++h) {
    const int cur = (h & 1) * kTileElems, nxt = kTileElems - cur;
    if (h + 1 < H) {
      load_tile_async(sQ + nxt, head_base(op.q, op.sq, b, h + 1), op.sq.n, i0, N);
      load_tile_async(sK + nxt, head_base(op.k, op.sk, b, h + 1), op.sk.n, j0, N);
      load_floats_async<kRows * 2>(sSt[~h & 1], stats + (((size_t)b * H + h + 1) * N + i0) * 2,
                                   rows * 2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // Statistics of rows g and g + 8 (zero past N: p = 0 there).
    float st[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st[r][0] = sSt[h & 1][(row0 + g + 8 * r) * 2];
      st[r][1] = sSt[h & 1][(row0 + g + 8 * r) * 2 + 1];
    }
    float s[8][4];
    logits(s, sQ + cur, sK + cur, j0, N, scale);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += __expf(s[nt][e] - st[e >> 1][0]) * st[e >> 1][1];
    __syncthreads();
  }

  // The warp's 16 rows of the mean through shared memory, then written a
  // row at a time, consecutive lanes on consecutive keys.
  float* stage = reinterpret_cast<float*>(smem) + row0 * kStage;
  const float num_heads = (float)H;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(stage + g * kStage + 8 * nt + 2 * t) =
        make_float2(acc[nt][0] / num_heads, acc[nt][1] / num_heads);
    *reinterpret_cast<float2*>(stage + (g + 8) * kStage + 8 * nt + 2 * t) =
        make_float2(acc[nt][2] / num_heads, acc[nt][3] / num_heads);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int i = i0 + row0 + r;
    if (i >= N) break;
    const size_t dst = ((size_t)b * N + i) * N;
#pragma unroll
    for (int c = lane; c < kRows; c += 32) {
      const int j = j0 + c;
      if (j >= N) break;
      const float mean = stage[r * kStage + c];
      if (probs_dtype == kProbsBF16) {
        static_cast<bf16*>(probs)[dst + j] = __float2bfloat16(mean);
      } else {
        static_cast<float*>(probs)[dst + j] = mean;
      }
    }
  }
}

}  // namespace

extern "C" {

// q, k, v: bf16 (B, N, H, D) operands, out: bf16 (B, N, H, D), given by
// their base pointers and `strides`: 12 element strides, (batch, token,
// head) of q, k, v and out in that order; D has unit stride. Every row of
// D values starts 16-byte aligned. probs: contiguous (B, N, N) of
// `probs_dtype` (1 fp32, 2 bf16), with stats a (B, H, N, 2) fp32 scratch;
// or both null with probs_dtype 0 for no export. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int attn_fwd_headmean(const void* q, const void* k, const void* v, void* out,
                      const long long* strides, void* probs, int probs_dtype, void* stats,
                      int B, int N, int H, int D, float scale, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (probs_dtype != kProbsNone && probs_dtype != kProbsF32 && probs_dtype != kProbsBF16) ||
      (probs == nullptr) != (probs_dtype == kProbsNone) ||
      (stats == nullptr) != (probs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Operands op{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  const int tiles_n = (N + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  attn_fwd_out_kernel<<<dim3(tiles_n, H, B), kThreads, 0, s>>>(op, st, N, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || probs == nullptr) return (int)e;
  attn_fwd_probs_kernel<<<dim3(tiles_n, tiles_n, B), kThreads, 0, s>>>(op, st, probs,
                                                                       probs_dtype, N, H, scale);
  return (int)cudaGetLastError();
}

const char* attn_fwd_headmean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
