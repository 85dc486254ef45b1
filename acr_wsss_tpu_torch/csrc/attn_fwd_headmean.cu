// Attention forward over the joint qkv projection, with the fp32 head-mean
// of the softmax probabilities as a second output.
//
// Replaces the TPU kernels acr_wsss_tpu/ops/attn_pallas.py::_fwd_kernel_nhd
// (export "mean", reached through _fwd_qkv_cols) and
// ::_fwd_kernel_nhd_noexport (export "none", a null probs pointer here).
//
// Function, for each batch element b and head h:
//   out[b, :, h*D:(h+1)*D] = bf16( bf16(softmax(q_h k_h^T * scale)) v_h )
//   probs[b]               = mean_h softmax(q_h k_h^T * scale)      (fp32)
// q, k and v are column ranges of qkv (B, N, 3*H*D) bf16: q in [0, HD),
// k in [HD, 2HD), v in [2HD, 3HD), head h at offset h*D. Products of bf16
// values are accumulated in fp32; the softmax is exact (it subtracts the
// row max) and runs in fp32. Rows and keys past N are masked here: there
// is no padding of N.
//
// Bound on the card: at the inference shape (B=2, H=12, N=577, D=64) the
// function does 4*B*H*N^2*D = 2.05 GFLOP (2.1 us at 989 TFLOP/s bf16) and
// must move 9.7 MB (qkv read 5.3 MB, out written 1.8 MB, probs written
// 2.7 MB: 2.9 us at 3.35 TB/s), so memory sets the bound.
//
// Design (simple and correct first): a block owns BM query rows of one
// batch element and loops over the heads, so the head mean accumulates in
// shared memory without atomics and each probs row is written once. Per
// head the BM x N logit tile lives in shared memory in fp32; each thread
// keeps one key row in registers and dots it with the BM query rows; one
// warp per row does the softmax; V streams through shared memory in tiles
// of KT keys. Products run on the CUDA cores: no tensor cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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

__global__ void __launch_bounds__(kThreads)
attn_fwd_headmean_kernel(const __nv_bfloat16* __restrict__ qkv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ probs, int N, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int HD = H * kD;
  const size_t row_stride = 3 * (size_t)HD;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool export_mean = probs != nullptr;

  float* sQ = smem;                                   // kBM x kD
  float* sS = sQ + kBM * kD;                          // kBM x N logits / probs
  float* sAcc = sS + kBM * N;                         // kBM x N head sum
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(
      sAcc + (export_mean ? kBM * N : 0));            // kKT x kD

  const __nv_bfloat16* base = qkv + (size_t)b * N * row_stride;

  if (export_mean) {
    for (int idx = tid; idx < kBM * N; idx += kThreads) sAcc[idx] = 0.f;
  }

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

    // Exact softmax, one warp per row. The row keeps bf16-rounded probs
    // for p @ v; the head sum takes the fp32 probs.
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
        if (export_mean) sAcc[r * N + j] += p;
        srow[j] = __bfloat162float(__float2bfloat16(p));
      }
    }
    __syncthreads();

    // p @ v: thread t owns column d = t % kD of rows rg, rg + 4, ...
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

  if (export_mean) {
    const float num_heads = (float)H;
    for (int idx = tid; idx < kBM * N; idx += kThreads) {
      const int r = idx / N, j = idx % N, i = i0 + r;
      if (i < N) probs[((size_t)b * N + i) * N + j] = sAcc[idx] / num_heads;
    }
  }
}

size_t smem_bytes(int N, bool export_mean) {
  return sizeof(float) * ((size_t)kBM * kD + (export_mean ? 2 : 1) * (size_t)kBM * N) +
         sizeof(__nv_bfloat16) * kKT * kD;
}

}  // namespace

extern "C" {

// Largest N one launch takes (the shared-memory budget of one block).
int attn_fwd_headmean_max_tokens(int export_mean) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const size_t per_token = smem_bytes(1, export_mean != 0) - smem_bytes(0, export_mean != 0);
  return (int)(((size_t)limit - smem_bytes(0, export_mean != 0)) / per_token);
}

// qkv (B, N, 3*H*D) bf16, out (B, N, H*D) bf16, probs (B, N, N) fp32 or
// null for no export. All contiguous, 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int attn_fwd_headmean(const void* qkv, void* out, void* probs, int B, int N,
                      int H, int D, float scale, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const bool export_mean = probs != nullptr;
  const size_t smem = smem_bytes(N, export_mean);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_headmean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + kBM - 1) / kBM, B);
  attn_fwd_headmean_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(probs), N, H, scale);
  return (int)cudaGetLastError();
}

const char* attn_fwd_headmean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
