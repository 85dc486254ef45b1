// Attention forward over strided q, k and v, with the head mean of the
// softmax probabilities as a second output (fp32, bf16, or none).
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
// Products of bf16 values are accumulated in fp32; the softmax is exact (it
// subtracts the row max) and runs in fp32. The head mean is summed in fp32
// in shared memory and rounded once when it is written: to bf16 for a bf16
// export, as the TPU kernels cast their fp32 accumulator once. Rows and keys
// past N are masked here: there is no padding of N.
//
// Bound on the card: at the inference shape (B=2, H=12, N=577, D=64) the
// function does 4*B*H*N^2*D = 2.05 GFLOP (2.1 us at 989 TFLOP/s bf16) and
// must move 9.7 MB (qkv read 5.3 MB, out written 1.8 MB, probs written
// 2.7 MB: 2.9 us at 3.35 TB/s), so memory sets the bound; at the training
// shape (B=8) 8.18 GFLOP and 39.0 MB (33.7 MB with a bf16 export).
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

// Probability export codes of the C interface.
constexpr int kProbsNone = 0, kProbsF32 = 1, kProbsBF16 = 2;

// Element strides of one (B, N, H, D) operand; D has unit stride.
struct Strides {
  long long b, n, h;
};

struct Operands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  Strides sq, sk, sv, so;
};

// Operand `p` at batch element b, head h: its row n starts at the result
// + n * s.n.
template <typename T>
__device__ __forceinline__ T* head_base(T* p, const Strides& s, int b, int h) {
  return p + (b * s.b + h * s.h);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
attn_fwd_headmean_kernel(Operands op, void* __restrict__ probs, int probs_dtype, int N,
                         int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool export_mean = probs_dtype != kProbsNone;

  float* sQ = smem;                                   // kBM x kD
  float* sS = sQ + kBM * kD;                          // kBM x N logits / probs
  float* sAcc = sS + kBM * N;                         // kBM x N head sum
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(
      sAcc + (export_mean ? kBM * N : 0));            // kKT x kD

  if (export_mean) {
    for (int idx = tid; idx < kBM * N; idx += kThreads) sAcc[idx] = 0.f;
  }

  for (int h = 0; h < H; ++h) {
    const __nv_bfloat16* qb = head_base(op.q, op.sq, b, h);
    const __nv_bfloat16* kb = head_base(op.k, op.sk, b, h);
    const __nv_bfloat16* vb = head_base(op.v, op.sv, b, h);
    for (int idx = tid; idx < kBM * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD, i = i0 + r;
      sQ[idx] = i < N ? __bfloat162float(qb[i * op.sq.n + d]) : 0.f;
    }
    __syncthreads();

    // Logits: thread t owns keys t, t + kThreads, ...
    for (int j = tid; j < N; j += kThreads) {
      const uint4* kp = reinterpret_cast<const uint4*>(kb + j * op.sk.n);
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
        if (j < N) u = *reinterpret_cast<const uint4*>(vb + j * op.sv.n + c * 8);
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
      if (i < N) head_base(op.out, op.so, b, h)[i * op.so.n + d] = __float2bfloat16(o[r2]);
    }
  }

  if (export_mean) {
    const float num_heads = (float)H;
    for (int idx = tid; idx < kBM * N; idx += kThreads) {
      const int r = idx / N, j = idx % N, i = i0 + r;
      if (i >= N) continue;
      const size_t dst = ((size_t)b * N + i) * N + j;
      const float mean = sAcc[idx] / num_heads;
      if (probs_dtype == kProbsBF16) {
        static_cast<__nv_bfloat16*>(probs)[dst] = __float2bfloat16(mean);
      } else {
        static_cast<float*>(probs)[dst] = mean;
      }
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

// q, k, v: bf16 (B, N, H, D) operands, out: bf16 (B, N, H, D), given by
// their base pointers and `strides`: 12 element strides, (batch, token,
// head) of q, k, v and out in that order; D has unit stride. Every row of
// D values of k and v starts 16-byte aligned. probs: contiguous (B, N, N)
// of `probs_dtype` (1 fp32, 2 bf16), or null with probs_dtype 0 for no
// export. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int attn_fwd_headmean(const void* q, const void* k, const void* v, void* out,
                      const long long* strides, void* probs, int probs_dtype, int B, int N,
                      int H, int D, float scale, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || H <= 0 ||
      (probs_dtype != kProbsNone && probs_dtype != kProbsF32 && probs_dtype != kProbsBF16) ||
      (probs == nullptr) != (probs_dtype == kProbsNone))
    return (int)cudaErrorInvalidValue;
  const bool export_mean = probs_dtype != kProbsNone;
  const size_t smem = smem_bytes(N, export_mean);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_headmean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Operands op{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                    {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  const dim3 grid((N + kBM - 1) / kBM, B);
  attn_fwd_headmean_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      op, probs, probs_dtype, N, H, scale);
  return (int)cudaGetLastError();
}

const char* attn_fwd_headmean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
