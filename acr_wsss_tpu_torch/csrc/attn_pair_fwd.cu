// Attention forward over interleaved (view, mirror) pairs, with the ACR
// consistency L1 sums computed where the head-mean probabilities are born.
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
// are masked, with no padding of N.
//
// Bound on the card at the training shape (B = 8, i.e. 4 pairs, H = 12,
// N = 577, D = 64): 4*B*H*N^2*D = 8.18 GFLOP (8.3 us at 989 TFLOP/s bf16);
// bytes qkv 21.27 MB read + out 7.09 MB + sign 1.33 MB written = 29.7 MB
// (8.9 us at 3.35 TB/s): memory sets the bound.
//
// Design (simple and correct first; the K1 forward's design extended to a
// pair). A block owns BM query rows of one pair and loops over both views
// and all heads. Only the difference of the two head means is needed, so
// one fp32 BM x N accumulator of (p_view - p_mirror) / H lives in shared
// memory instead of two. Each view's output rows are written as the K1
// forward writes them; the sign tile is written once per row. The per-pair
// sums cross blocks: each block writes its two partial sums (a fixed-order
// reduction over its threads), and a second kernel in this source adds a
// pair's partials in a fixed order. No float atomics: the sums are the same
// from run to run. Products run on the CUDA cores (no tensor cores, no TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 8;        // query rows per block (one warp per row)
constexpr int kD = 64;        // head dim
constexpr int kThreads = 256;
constexpr int kKT = 64;       // keys per V tile

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

__global__ void __launch_bounds__(kThreads)
attn_pair_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out,
                     int8_t* __restrict__ sign, float* __restrict__ partials,
                     int N, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int HD = H * kD;
  const size_t row_stride = 3 * (size_t)HD;
  const int pair = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inv_h = 1.0f / (float)H;

  float* sQ = smem;                                   // kBM x kD
  float* sS = sQ + kBM * kD;                          // kBM x N logits / probs
  float* sAcc = sS + kBM * N;                         // kBM x N (p_view - p_mirror) / H
  float* sRed = sAcc + kBM * N;                       // kThreads / 32
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sRed + kThreads / 32);  // kKT x kD

  for (int idx = tid; idx < kBM * N; idx += kThreads) sAcc[idx] = 0.f;

  for (int view = 0; view < 2; ++view) {
    const int b = 2 * pair + view;
    const float sgn = view == 0 ? inv_h : -inv_h;
    const __nv_bfloat16* base = qkv + (size_t)b * N * row_stride;

    for (int h = 0; h < H; ++h) {
      const int qcol = h * kD;
      const int kcol = HD + h * kD;
      const int vcol = 2 * HD + h * kD;

      for (int idx = tid; idx < kBM * kD; idx += kThreads) {
        const int r = idx / kD, d = idx % kD, i = i0 + r;
        sQ[idx] = i < N ? __bfloat162float(base[(size_t)i * row_stride + qcol + d]) : 0.f;
      }
      __syncthreads();

      // Logits: thread t owns keys t, t + kThreads, ...
      for (int j = tid; j < N; j += kThreads) {
        const uint4* kp = reinterpret_cast<const uint4*>(base + (size_t)j * row_stride + kcol);
        float kf[kD];
#pragma unroll
        for (int c = 0; c < kD / 8; ++c) {
          const uint4 u = kp[c];
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(p2[t]);
            kf[c * 8 + 2 * t] = f.x;
            kf[c * 8 + 2 * t + 1] = f.y;
          }
        }
#pragma unroll
        for (int r = 0; r < kBM; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(sQ + r * kD);
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < kD / 4; ++c) {
            const float4 qv = q4[c];
            acc = fmaf(qv.x, kf[4 * c], acc);
            acc = fmaf(qv.y, kf[4 * c + 1], acc);
            acc = fmaf(qv.z, kf[4 * c + 2], acc);
            acc = fmaf(qv.w, kf[4 * c + 3], acc);
          }
          sS[r * N + j] = acc * scale;
        }
      }
      __syncthreads();

      // Exact softmax, one warp per row; the difference accumulator takes
      // the fp32 probs, the row keeps them rounded to bf16 for p @ v.
      for (int r = warp; r < kBM; r += kThreads / 32) {
        float* srow = sS + r * N;
        if (i0 + r >= N) {
          for (int j = lane; j < N; j += 32) srow[j] = 0.f;
          continue;
        }
        float m = -CUDART_INF_F;
        for (int j = lane; j < N; j += 32) m = fmaxf(m, srow[j]);
        m = warp_max(m);
        float s = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float e = expf(srow[j] - m);
          srow[j] = e;
          s += e;
        }
        s = warp_sum(s);
        for (int j = lane; j < N; j += 32) {
          const float p = srow[j] / s;
          sAcc[r * N + j] += p * sgn;
          srow[j] = __bfloat162float(__float2bfloat16(p));
        }
      }
      __syncthreads();

      // p @ v: thread t owns column d = t % kD of rows rg, rg + 4.
      const int d = tid % kD;
      const int rg = tid / kD;
      constexpr int kRowsPerThread = kBM * kD / kThreads;
      float o[kRowsPerThread];
#pragma unroll
      for (int r2 = 0; r2 < kRowsPerThread; ++r2) o[r2] = 0.f;
      for (int j0 = 0; j0 < N; j0 += kKT) {
        for (int idx = tid; idx < kKT * kD / 8; idx += kThreads) {
          const int jj = idx / (kD / 8), c = idx % (kD / 8), j = j0 + jj;
          uint4 u = make_uint4(0u, 0u, 0u, 0u);
          if (j < N) u = *reinterpret_cast<const uint4*>(base + (size_t)j * row_stride + vcol + c * 8);
          reinterpret_cast<uint4*>(sV)[idx] = u;
        }
        __syncthreads();
        const int jn = min(kKT, N - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float vv = __bfloat162float(sV[jj * kD + d]);
#pragma unroll
          for (int r2 = 0; r2 < kRowsPerThread; ++r2) {
            o[r2] = fmaf(sS[(rg + (kThreads / kD) * r2) * N + j0 + jj], vv, o[r2]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r2 = 0; r2 < kRowsPerThread; ++r2) {
        const int i = i0 + rg + (kThreads / kD) * r2;
        if (i < N) out[((size_t)b * N + i) * HD + h * kD + d] = __float2bfloat16(o[r2]);
      }
    }
  }

  // Sign tile and this block's partial sums (row 0 -> cls, rows >= 1 -> aff).
  float cls = 0.f, aff = 0.f;
  for (int idx = tid; idx < kBM * N; idx += kThreads) {
    const int r = idx / N, j = idx % N, i = i0 + r;
    if (i >= N) continue;
    const float delta = sAcc[idx];
    int8_t sg = 0;
    if (j >= 1) {
      sg = (int8_t)((delta > 0.f) - (delta < 0.f));
      if (i == 0) cls += fabsf(delta);
      else aff += fabsf(delta);
    }
    sign[((size_t)pair * N + i) * N + j] = sg;
  }
  cls = block_sum(cls, sRed);
  aff = block_sum(aff, sRed);
  if (tid == 0) {
    float* part = partials + ((size_t)pair * gridDim.x + blockIdx.x) * 2;
    part[0] = cls;
    part[1] = aff;
  }
}

// One block per pair: add the row-tile partials in a fixed order.
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

size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)kBM * kD + 2 * (size_t)kBM * N + kThreads / 32) +
         sizeof(__nv_bfloat16) * kKT * kD;
}

}  // namespace

extern "C" {

// Largest N one launch takes (the shared-memory budget of one block).
int attn_pair_fwd_max_tokens() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const size_t per_token = smem_bytes(1) - smem_bytes(0);
  return (int)(((size_t)limit - smem_bytes(0)) / per_token);
}

// Row tiles per pair: the partials buffer holds pairs * tiles * 2 floats.
int attn_pair_fwd_tiles(int N) { return (N + kBM - 1) / kBM; }

// qkv (B, N, 3*H*D) bf16 with B = 2 * pairs interleaved; out (B, N, H*D)
// bf16; sign (pairs, N, N) int8; partials (pairs, tiles, 2) fp32 scratch;
// cls_sums, aff_sums (pairs,) fp32. All contiguous, 16-byte aligned.
// Launches both kernels on `stream`; returns cudaGetLastError().
int attn_pair_fwd(const void* qkv, void* out, void* sign, void* partials,
                  void* cls_sums, void* aff_sums, int B, int N, int H, int D,
                  float scale, void* stream) {
  if (D != kD || B <= 0 || B % 2 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int pairs = B / 2;
  const size_t smem = smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_pair_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = attn_pair_fwd_tiles(N);
  attn_pair_fwd_kernel<<<dim3(tiles, pairs), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(sign), static_cast<float*>(partials), N, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_pair_sums_kernel<<<pairs, kThreads, 0, s>>>(
      static_cast<const float*>(partials), tiles, static_cast<float*>(cls_sums),
      static_cast<float*>(aff_sums));
  return (int)cudaGetLastError();
}

const char* attn_pair_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
