// Attention forward over interleaved (view, mirror) pairs, with the ACR
// consistency L1 sums computed where the head-mean probabilities are born,
// on the tensor cores.
//
// Replaces the TPU kernel acr_wsss_tpu/ops/attn_pallas.py::_fwd_kernel_pair
// (reached through _fwd_pair and fused_attention_pair_consistency).
//
// Function. The batch interleaves the two views of each pair:
// rows [2i, 2i+1] are (view, mirror) of pair i. For each batch element b
// and head h, as the K1 forward (attn_fwd_headmean.cu):
//   out[b, :, h*D:(h+1)*D] = bf16( bf16(softmax(q_h k_h^T * scale)) v_h )
// and for each pair, with delta = mean_h p(2i) - mean_h p(2i+1) (fp32):
//   cls_sums[i] = sum_{j in [1, N)} |delta[0, j]|
//   aff_sums[i] = sum_{r, j in [1, N)} |delta[r, j]|
//   sign[i, r, j] = sign(delta[r, j]) (int8, sign(0) = 0) on row 0 and on
//                   rows >= 1, for columns j >= 1; 0 in column 0.
// The softmax is exact (row max subtracted), in fp32; rows and keys past N
// are masked, with no padding of N and no limit on it.
//
// Bound on the card at the training shape (B = 8, i.e. 4 pairs, H = 12,
// N = 577, D = 64): 4*B*H*N^2*D = 8.18 GFLOP (8.3 us at 989 TFLOP/s bf16);
// bytes qkv 21.27 MB read + out 7.09 MB + sign 1.33 MB written = 29.7 MB
// (8.9 us at 3.35 TB/s): memory sets the bound. The design below does
// twice the products (16.4 GFLOP: the logits three times, p @ v once) and
// 3*B*H*N^2 = 95.9M exponentials, 23 us on the SFUs (16 per clock and SM
// at 1.98 GHz); it moves 0.44 MB of row statistics more.
//
// Design: three kernels on one stream, no float atomics, so two launches
// give the same bits.
//   Out pass: the K1 forward's out kernel (attn_fwd_out.cuh) over all B
//   rows, which saves each row's (max, 1 / sum of exponentials) per head
//   to a (B, H, N, 2) fp32 scratch.
//   Pair kernel: one warpgroup block per (64 query rows, 64 keys, pair)
//   loops over the heads of the view and then of the mirror, in order.
//   Each step loads the Q and K tiles and the rows' statistics,
//   double-buffered with cp.async, recomputes S with wgmma and adds p =
//   exp(s - max) * (1 / sum) to one fp32 register accumulator per view.
//   Then delta = acc_view / H - acc_mirror / H (the order of the JAX
//   kernel's acc1 and acc2, and of the plain version); the block writes
//   its masked 64 x 64 int8 sign tile once, staged through shared memory
//   so that rows go out coalesced, and its two partial |delta| sums,
//   reduced over its threads in a fixed order. The head means are never
//   written, and nothing N-wide lives in shared memory.
//   Sums kernel: one block per pair adds the pair's partials in tile order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_fwd_out.cuh"

namespace {

using namespace tiles;

constexpr int kSignPitch = kRows + 4;   // bytes of a staged sign-tile row

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over the block, in a fixed order; the result
// is valid in thread 0. `red` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  }
  __syncthreads();
  return s;
}

// Four blocks per SM, so that the 400 blocks of the training shape run in
// one wave on 132 SMs: at most 128 registers.
__global__ void __launch_bounds__(kThreads, 4)
attn_pair_kernel(Operands op, const float* __restrict__ stats, int8_t* __restrict__ sign,
                 float* __restrict__ partials, int N, int H, float scale) {
  // Two stages of (Q, K) tiles; after the head loops, the int8 sign tile.
  __shared__ __align__(kTileAlign) bf16 smem[4 * kTileElems];
  __shared__ float sSt[2][kRows * 2];   // two stages of the rows' (max, 1 / sum)
  __shared__ float sRed[kThreads / 32];
  bf16* sQ = smem;
  bf16* sK = smem + 2 * kTileElems;
  const int i0 = blockIdx.x * kRows, j0 = blockIdx.y * kRows, pair = blockIdx.z;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows = min(kRows, N - i0);
  const int steps = 2 * H;

  // Step s reads head s % H of view s / H into stage s % 2.
  auto load = [&](int s) {
    const int b = 2 * pair + s / H, h = s % H, stage = (s & 1) * kTileElems;
    load_tile_async(sQ + stage, head_base(op.q, op.sq, b, h), op.sq.n, i0, N);
    load_tile_async(sK + stage, head_base(op.k, op.sk, b, h), op.sk.n, j0, N);
    load_floats_async<kRows * 2>(sSt[s & 1], stats + (((size_t)b * H + h) * N + i0) * 2,
                                 rows * 2);
  };
  // acc += p of step s, as attn_fwd_probs_kernel forms it (zero past N).
  auto add_step = [&](float (&acc)[8][4], int s) {
    if (s + 1 < steps) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int stage = (s & 1) * kTileElems;
    float st[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st[r][0] = sSt[s & 1][(row0 + g + 8 * r) * 2];
      st[r][1] = sSt[s & 1][(row0 + g + 8 * r) * 2 + 1];
    }
    float sv[8][4];
    logits(sv, sQ + stage, sK + stage, j0, N, scale);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] += __expf(sv[nt][e] - st[e >> 1][0]) * st[e >> 1][1];
    __syncthreads();
  };

  load(0);
  cp_async_commit();
  float acc_view[8][4], acc_mirror[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_view[nt][e] = acc_mirror[nt][e] = 0.f;
  for (int h = 0; h < H; ++h) add_step(acc_view, h);
  for (int h = 0; h < H; ++h) add_step(acc_mirror, H + h);

  // delta, its masked sums and its sign; the tiles are free after the last
  // step's barrier.
  int8_t* sSign = reinterpret_cast<int8_t*>(smem);
  const float num_heads = (float)H;
  float cls = 0.f, aff = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
      const int i = i0 + r, j = j0 + c;
      const float delta = acc_view[nt][e] / num_heads - acc_mirror[nt][e] / num_heads;
      const bool in = i < N && j >= 1 && j < N;
      if (in) {
        if (i == 0) cls += fabsf(delta);
        else aff += fabsf(delta);
      }
      sSign[r * kSignPitch + c] = in ? (int8_t)((delta > 0.f) - (delta < 0.f)) : (int8_t)0;
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * kRows; idx += kThreads) {
    const int r = idx / kRows, c = idx % kRows, i = i0 + r, j = j0 + c;
    if (i < N && j < N) sign[((size_t)pair * N + i) * N + j] = sSign[r * kSignPitch + c];
  }
  cls = block_sum(cls, sRed);
  aff = block_sum(aff, sRed);
  if (threadIdx.x == 0) {
    float* part =
        partials + (((size_t)pair * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y) * 2;
    part[0] = cls;
    part[1] = aff;
  }
}

// One block per pair: add the pair's tile partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
attn_pair_sums_kernel(const float* __restrict__ partials, int tiles,
                      float* __restrict__ cls_sums, float* __restrict__ aff_sums) {
  __shared__ float red[kThreads / 32];
  const float* part = partials + (size_t)blockIdx.x * tiles * 2;
  float cls = 0.f, aff = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    cls += part[2 * t];
    aff += part[2 * t + 1];
  }
  cls = block_sum(cls, red);
  aff = block_sum(aff, red);
  if (threadIdx.x == 0) {
    cls_sums[blockIdx.x] = cls;
    aff_sums[blockIdx.x] = aff;
  }
}

int tiles_n(int N) { return (N + kRows - 1) / kRows; }

}  // namespace

extern "C" {

// Tiles of 64 x 64 per pair: the partials buffer holds pairs * tiles * 2
// floats.
int attn_pair_fwd_tiles(int N) { return tiles_n(N) * tiles_n(N); }

// Blocks of the pair kernel that one SM holds at once (0 on an error).
int attn_pair_fwd_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_pair_kernel, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// qkv (B, N, 3*H*D) bf16 with B = 2 * pairs interleaved; out (B, N, H*D)
// bf16; sign (pairs, N, N) int8; stats (B, H, N, 2) and partials (pairs,
// tiles, 2) fp32 scratch; cls_sums, aff_sums (pairs,) fp32. All
// contiguous, 16-byte aligned. Launches the three kernels on `stream`;
// returns cudaGetLastError() (0 on success).
int attn_pair_fwd(const void* qkv, void* out, void* sign, void* stats, void* partials,
                  void* cls_sums, void* aff_sums, int B, int N, int H, int D, float scale,
                  void* stream) {
  if (D != kD || B <= 0 || B % 2 || N <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      tiles_n(N) > 65535)
    return (int)cudaErrorInvalidValue;
  const int pairs = B / 2;
  const long long HD = (long long)H * kD;
  const bf16* q = static_cast<const bf16*>(qkv);
  const Strides cols{N * 3 * HD, 3 * HD, kD};
  const Operands op{q, q + HD, q + 2 * HD, static_cast<bf16*>(out),
                    cols, cols, cols, {N * HD, HD, kD}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(partials);
  attn_fwd_out_kernel<<<dim3(tiles_n(N), H, B), kThreads, 0, s>>>(op, st, N, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_pair_kernel<<<dim3(tiles_n(N), tiles_n(N), pairs), kThreads, 0, s>>>(
      op, st, static_cast<int8_t*>(sign), part, N, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_pair_sums_kernel<<<pairs, kThreads, 0, s>>>(part, attn_pair_fwd_tiles(N),
                                                   static_cast<float*>(cls_sums),
                                                   static_cast<float*>(aff_sums));
  return (int)cudaGetLastError();
}

const char* attn_pair_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
