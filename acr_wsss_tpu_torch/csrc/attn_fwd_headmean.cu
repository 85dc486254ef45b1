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
// shape (B=8) 8.18 GFLOP and 39.0 MB (33.7 MB with a bf16 export). The
// classifiers' forwards without export (K1n, B=8): vit_small_patch16_224
// (N=197, H=8, D=96) 9.68 MB, 2.89 us by bytes (0.95 GFLOP, 0.96 us);
// vit_huge_patch14_224_in21k (N=257, H=16, D=80) 21.05 MB, 6.28 us (2.71
// GFLOP, 2.74 us).
//
// Head dim: any multiple of 16 up to 128. Both kernels hold an operand as
// kDT tiles of 64 columns (1 for D <= 64, 2 above), the columns past D
// zero-filled: they add nothing to q k^T, and the columns of p v past D
// are not stored. The price is the zeros' products (1.6x at D = 80, 1.33x
// at 48 and 96, 2x at 32); the bytes moved are D's own.
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

// Tiles of the probs kernel: two stages of (Q, K), each kDT tiles.
template <int kDT>
constexpr int kProbsTiles = 4 * kDT;

template <int kDT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_probs_kernel(Operands op, const float* __restrict__ stats, void* __restrict__ probs,
                      int probs_dtype, int N, int H, int D, float scale) {
  // Two stages of (Q, K) tiles; after the head loop, the fp32 probs tile.
  constexpr int kOp = kDT * kTileElems;
  bf16* smem = tiles_smem<kProbsTiles<kDT>, kDT>();
  __shared__ float sSt[2][kRows * 2];   // two stages of the rows' (max, 1 / sum)
  bf16* sQ = smem;
  bf16* sK = smem + 2 * kOp;
  const int i0 = blockIdx.x * kRows, j0 = blockIdx.y * kRows, b = blockIdx.z;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2;

  const int rows = min(kRows, N - i0);
  load_tile_async<kDT>(sQ, head_base(op.q, op.sq, b, 0), op.sq.n, i0, N, D);
  load_tile_async<kDT>(sK, head_base(op.k, op.sk, b, 0), op.sk.n, j0, N, D);
  load_floats_async<kRows * 2>(sSt[0], stats + ((size_t)b * H * N + i0) * 2, rows * 2);
  cp_async_commit();
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int h = 0; h < H; ++h) {
    const int cur = (h & 1) * kOp, nxt = kOp - cur;
    if (h + 1 < H) {
      load_tile_async<kDT>(sQ + nxt, head_base(op.q, op.sq, b, h + 1), op.sq.n, i0, N, D);
      load_tile_async<kDT>(sK + nxt, head_base(op.k, op.sk, b, h + 1), op.sk.n, j0, N, D);
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
    logits<kDT>(s, sQ + cur, sK + cur, j0, N, scale);
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

// The out kernel, then with an export the probs kernel, at kDT tiles of
// head dim.
template <int kDT>
int launch(const Operands& op, float* stats, void* probs, int probs_dtype, int B, int N, int H,
           int D, float scale, cudaStream_t s) {
  cudaError_t e = launch_out<kDT>(op, stats, B, N, H, D, scale, s);
  if (e != cudaSuccess || probs == nullptr) return (int)e;
  constexpr size_t bytes = tiles_dynamic_bytes<kProbsTiles<kDT>, kDT>();
  if (bytes > 0) {
    e = cudaFuncSetAttribute(attn_fwd_probs_kernel<kDT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_n = (N + kRows - 1) / kRows;
  attn_fwd_probs_kernel<kDT><<<dim3(tiles_n, tiles_n, B), kThreads, bytes, s>>>(
      op, stats, probs, probs_dtype, N, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: bf16 (B, N, H, D) operands, out: bf16 (B, N, H, D), given by
// their base pointers and `strides`: 12 element strides, (batch, token,
// head) of q, k, v and out in that order; D has unit stride and is a
// multiple of 16 up to 128. Every row of D values starts 16-byte aligned.
// probs: contiguous (B, N, N) of `probs_dtype` (1 fp32, 2 bf16), with
// stats a (B, H, N, 2) fp32 scratch; or both null with probs_dtype 0 for
// no export. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int attn_fwd_headmean(const void* q, const void* k, const void* v, void* out,
                      const long long* strides, void* probs, int probs_dtype, void* stats,
                      int B, int N, int H, int D, float scale, void* stream) {
  if (D % 16 || D < 16 || D > 2 * kD || B <= 0 || N <= 0 || H <= 0 || B > 65535 ||
      H > 65535 ||
      (probs_dtype != kProbsNone && probs_dtype != kProbsF32 && probs_dtype != kProbsBF16) ||
      (probs == nullptr) != (probs_dtype == kProbsNone) ||
      (stats == nullptr) != (probs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Operands op{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (D <= kD) return launch<1>(op, st, probs, probs_dtype, B, N, H, D, scale, s);
  return launch<2>(op, st, probs, probs_dtype, B, N, H, D, scale, s);
}

const char* attn_fwd_headmean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
