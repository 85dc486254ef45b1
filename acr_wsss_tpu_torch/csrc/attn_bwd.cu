// Attention backward over strided q, k and v: the softmax gradient with a
// cotangent `de` of the head-mean probabilities, in two forms.
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
// 3*H*D) in the column layout of qkv).
// All arithmetic is fp32 (as both TPU kernels run it: `mm = float32`, and
// the pair kernel casts g to fp32); rows and keys past N are masked.
//
// Bound on the card at the training shape (B = 8, H = 12, N = 577, D = 64):
// 5 products of 2*B*H*N^2*D = 20.5 GFLOP (20.7 us at 989 TFLOP/s bf16);
// bytes: qkv 21.27 MB + g 7.09 MB read, dqkv 21.27 MB written, plus the
// sign tile 1.33 MB (pair: 51.0 MB, 15.2 us) or a dense de 10.65 MB
// (60.3 MB, 18.0 us at 3.35 TB/s). The operations set the bound: 20.7 us.
//
// Design (simple, correct and deterministic first): two passes, as a
// flash-attention backward, so that no sum crosses blocks.
//   Row pass, one block per (8 query rows, head, b): logits, the exact
//   softmax, dp, c = rowsum(dp * p) and ds for its rows in shared memory;
//   it writes dq for its rows and saves the row max, row sum and c.
//   Key pass, one block per (32 keys, head, b): walks all query rows in
//   tiles of 32, recomputes p and ds for its keys from the saved row
//   statistics (bit for bit the row pass's values: same operations in the
//   same order), and sums dk and dv in registers over the rows.
// dk = ds^T q and dv = p^T g sum over all query rows; the key pass owns
// those sums, so there are no atomics and the result is the same from run
// to run. Products run on the CUDA cores (no tensor cores, no TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kThreads = 256;
constexpr int kBM = 8;        // row pass: query rows per block (one warp per row)
constexpr int kKT = 64;       // row pass: keys per K tile of ds @ k
constexpr int kBN = 32;       // key pass: keys per block
constexpr int kBR = 32;       // key pass: query rows per tile
constexpr int kPad = kD + 1;  // key pass: padded row of K and V in shared memory

// Element strides of one (B, N, H, D) operand; D has unit stride.
struct Strides {
  long long b, n, h;
};

struct Operands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

// Operand `p` at batch element b, head h: its row n starts at the result
// + n * s.n.
template <typename T>
__device__ __forceinline__ T* head_base(T* p, const Strides& s, int b, int h) {
  return p + (b * s.b + h * s.h);
}

struct DeSource {
  const float* dense;     // (B, N, N) fp32 cotangent of the head mean, or null
  const __nv_bfloat16* dense_bf16;  // the same in bf16, or null
  const int8_t* sign;     // (B / 2, N, N) int8 sign tile, or null
  const float* g_cls;     // (B / 2,) fp32
  const float* g_aff;     // (B / 2,) fp32
  float inv_h;
};

// de / H at (b, i, j), i and j < N.
__device__ __forceinline__ float de_at(const DeSource& s, int b, int i, int j, int N) {
  if (s.sign != nullptr) {
    const int pair = b >> 1;
    const float sg = (float)s.sign[((size_t)pair * N + i) * N + j];
    const float gsel = i == 0 ? s.g_cls[pair] : s.g_aff[pair];
    const float v = __fmul_rn(__fmul_rn(sg, gsel), s.inv_h);
    return (b & 1) ? -v : v;
  }
  if (s.dense != nullptr) return __fmul_rn(s.dense[((size_t)b * N + i) * N + j], s.inv_h);
  if (s.dense_bf16 != nullptr)
    return __fmul_rn(__bfloat162float(s.dense_bf16[((size_t)b * N + i) * N + j]), s.inv_h);
  return 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load_row64(const __nv_bfloat16* src, float* dst) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) {
    const uint4 u = p[c];
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(p2[t]);
      dst[c * 8 + 2 * t] = f.x;
      dst[c * 8 + 2 * t + 1] = f.y;
    }
  }
}

// Row pass. stats (B, H, N, 3): row max, row sum of exp, c.
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(Operands op, DeSource de, float* __restrict__ stats, int N, int H,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* sQ = smem;                       // kBM x kD
  float* sG = sQ + kBM * kD;              // kBM x kD
  float* sP = sG + kBM * kD;              // kBM x N: logits, then p
  float* sX = sP + kBM * N;               // kBM x N: dp, then ds
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(sX + kBM * N);  // kKT x kD

  const __nv_bfloat16* qb = head_base(op.q, op.sq, b, h);
  const __nv_bfloat16* kb = head_base(op.k, op.sk, b, h);
  const __nv_bfloat16* vb = head_base(op.v, op.sv, b, h);
  const __nv_bfloat16* gb = head_base(op.g, op.sg, b, h);
  for (int idx = tid; idx < kBM * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, i = i0 + r;
    sQ[idx] = i < N ? __bfloat162float(qb[i * op.sq.n + d]) : 0.f;
    sG[idx] = i < N ? __bfloat162float(gb[i * op.sg.n + d]) : 0.f;
  }
  __syncthreads();

  // Logits, then dp: thread t owns keys t, t + kThreads, ...
  for (int j = tid; j < N; j += kThreads) {
    float kf[kD];
    load_row64(kb + j * op.sk.n, kf);
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
      sP[r * N + j] = __fmul_rn(acc, scale);
    }
    load_row64(vb + j * op.sv.n, kf);
#pragma unroll
    for (int r = 0; r < kBM; ++r) {
      const int i = i0 + r;
      const float4* g4 = reinterpret_cast<const float4*>(sG + r * kD);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kD / 4; ++c) {
        const float4 gv = g4[c];
        acc = fmaf(gv.x, kf[4 * c], acc);
        acc = fmaf(gv.y, kf[4 * c + 1], acc);
        acc = fmaf(gv.z, kf[4 * c + 2], acc);
        acc = fmaf(gv.w, kf[4 * c + 3], acc);
      }
      sX[r * N + j] = i < N ? __fadd_rn(acc, de_at(de, b, i, j, N)) : 0.f;
    }
  }
  __syncthreads();

  // Exact softmax, c and ds, one warp per row.
  for (int r = warp; r < kBM; r += kThreads / 32) {
    float* prow = sP + r * N;
    float* xrow = sX + r * N;
    const int i = i0 + r;
    if (i >= N) {
      for (int j = lane; j < N; j += 32) prow[j] = xrow[j] = 0.f;
      continue;
    }
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float c = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = prow[j] / l;
      prow[j] = p;
      c += xrow[j] * p;
    }
    c = warp_sum(c);
    for (int j = lane; j < N; j += 32) xrow[j] = prow[j] * (xrow[j] - c);
    if (lane == 0) {
      float* st = stats + (((size_t)b * H + h) * N + i) * 3;
      st[0] = m;
      st[1] = l;
      st[2] = c;
    }
  }
  __syncthreads();

  // dq = ds @ k * scale: thread t owns column d = t % kD of rows rg, rg + 4.
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
      if (j < N) u = *reinterpret_cast<const uint4*>(kb + j * op.sk.n + c * 8);
      reinterpret_cast<uint4*>(sK)[idx] = u;
    }
    __syncthreads();
    const int jn = min(kKT, N - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float kv = __bfloat162float(sK[jj * kD + d]);
#pragma unroll
      for (int r2 = 0; r2 < kRowsPerThread; ++r2) {
        o[r2] = fmaf(sX[(rg + (kThreads / kD) * r2) * N + j0 + jj], kv, o[r2]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r2 = 0; r2 < kRowsPerThread; ++r2) {
    const int i = i0 + rg + (kThreads / kD) * r2;
    if (i < N) head_base(op.dq, op.sdq, b, h)[i * op.sdq.n + d] = __float2bfloat16(o[r2] * scale);
  }
}

// Key pass: dk and dv of kBN keys of one head, summed over all query rows.
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_kernel(Operands op, DeSource de, const float* __restrict__ stats, int N,
                     int H, float scale) {
  __shared__ __align__(16) float sK[kBN * kPad];
  __shared__ __align__(16) float sV[kBN * kPad];
  __shared__ __align__(16) float sQ[kBR * kD];
  __shared__ __align__(16) float sG[kBR * kD];
  __shared__ float sP[kBR * kBN];
  __shared__ float sDS[kBR * kBN];
  __shared__ float sStat[kBR * 3];

  const int j0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qb = head_base(op.q, op.sq, b, h);
  const __nv_bfloat16* kb = head_base(op.k, op.sk, b, h);
  const __nv_bfloat16* vb = head_base(op.v, op.sv, b, h);
  const __nv_bfloat16* gb = head_base(op.g, op.sg, b, h);

  for (int idx = tid; idx < kBN * kD; idx += kThreads) {
    const int jj = idx / kD, d = idx % kD, j = j0 + jj;
    sK[jj * kPad + d] = j < N ? __bfloat162float(kb[j * op.sk.n + d]) : 0.f;
    sV[jj * kPad + d] = j < N ? __bfloat162float(vb[j * op.sv.n + d]) : 0.f;
  }

  // Thread t owns column d = t % kD of keys jg, jg + 4, ..., jg + 28.
  const int d = tid % kD;
  const int jg = tid / kD;
  constexpr int kStep = kThreads / kD;
  constexpr int kKeysPerThread = kBN / kStep;
  float dk[kKeysPerThread], dv[kKeysPerThread];
#pragma unroll
  for (int k = 0; k < kKeysPerThread; ++k) dk[k] = dv[k] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kBR) {
    __syncthreads();
    for (int idx = tid; idx < kBR * kD; idx += kThreads) {
      const int r = idx / kD, dd = idx % kD, i = i0 + r;
      sQ[idx] = i < N ? __bfloat162float(qb[i * op.sq.n + dd]) : 0.f;
      sG[idx] = i < N ? __bfloat162float(gb[i * op.sg.n + dd]) : 0.f;
    }
    for (int idx = tid; idx < kBR * 3; idx += kThreads) {
      const int i = i0 + idx / 3;
      sStat[idx] = i < N ? stats[(((size_t)b * H + h) * N + i) * 3 + idx % 3] : 0.f;
    }
    __syncthreads();

    // p and ds for (row, key) pairs; a warp takes one row and 32 keys.
    for (int idx = tid; idx < kBR * kBN; idx += kThreads) {
      const int r = idx / kBN, jj = idx % kBN, i = i0 + r, j = j0 + jj;
      float p = 0.f, ds = 0.f;
      if (i < N && j < N) {
        const float* qr = sQ + r * kD;
        const float* gr = sG + r * kD;
        const float* kr = sK + jj * kPad;
        const float* vr = sV + jj * kPad;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int dd = 0; dd < kD; ++dd) s = fmaf(qr[dd], kr[dd], s);
#pragma unroll
        for (int dd = 0; dd < kD; ++dd) dp = fmaf(gr[dd], vr[dd], dp);
        // Explicit roundings: no contraction into an fma, so that p and
        // ds equal the row pass's to the bit.
        dp = __fadd_rn(dp, de_at(de, b, i, j, N));
        p = expf(__fmul_rn(s, scale) - sStat[3 * r]) / sStat[3 * r + 1];
        ds = p * (dp - sStat[3 * r + 2]);
      }
      sP[idx] = p;
      sDS[idx] = ds;
    }
    __syncthreads();

    const int rn = min(kBR, N - i0);
    for (int r = 0; r < rn; ++r) {
      const float qv = sQ[r * kD + d];
      const float gv = sG[r * kD + d];
#pragma unroll
      for (int k = 0; k < kKeysPerThread; ++k) {
        const int jj = jg + kStep * k;
        dk[k] = fmaf(sDS[r * kBN + jj], qv, dk[k]);
        dv[k] = fmaf(sP[r * kBN + jj], gv, dv[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kKeysPerThread; ++k) {
    const int j = j0 + jg + kStep * k;
    if (j < N) {
      head_base(op.dk, op.sdk, b, h)[j * op.sdk.n + d] = __float2bfloat16(dk[k] * scale);
      head_base(op.dv, op.sdv, b, h)[j * op.sdv.n + d] = __float2bfloat16(dv[k]);
    }
  }
}

size_t rows_smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)kBM * kD + 2 * (size_t)kBM * N) +
         sizeof(__nv_bfloat16) * kKT * kD;
}

int launch(const Operands& op, const DeSource& de, void* stats, int B, int N, int H, int D,
           float scale, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  attn_bwd_rows_kernel<<<dim3((N + kBM - 1) / kBM, H, B), kThreads, smem, s>>>(
      op, de, st, N, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_keys_kernel<<<dim3((N + kBN - 1) / kBN, H, B), kThreads, 0, s>>>(
      op, de, st, N, H, scale);
  return (int)cudaGetLastError();
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// Largest N one launch takes (the row pass's shared-memory budget).
int attn_bwd_max_tokens() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const size_t per_token = rows_smem_bytes(1) - rows_smem_bytes(0);
  return (int)(((size_t)limit - rows_smem_bytes(0)) / per_token);
}

// K1b, K5a-c. q, k, v, g: bf16 (B, N, H, D) operands; dq, dk, dv: bf16
// (B, N, H, D) outputs; `strides` holds 21 element strides, (batch, token,
// head) of q, k, v, g, dq, dk and dv in that order; D has unit stride and
// every row of D values of k and v starts 16-byte aligned. de: contiguous
// (B, N, N) of `de_dtype` (1 fp32, 2 bf16), or null with de_dtype 0 for
// zero. stats: (B, H, N, 3) fp32 scratch. Returns cudaGetLastError().
int attn_bwd_dense(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const long long* strides, const void* de, int de_dtype,
                   void* stats, int B, int N, int H, int D, float scale, void* stream) {
  if (de_dtype < 0 || de_dtype > 2 || (de == nullptr) != (de_dtype == 0))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const Operands op{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    strides_at(strides), strides_at(strides + 3), strides_at(strides + 6),
                    strides_at(strides + 9), strides_at(strides + 12),
                    strides_at(strides + 15), strides_at(strides + 18)};
  const DeSource src{de_dtype == 1 ? static_cast<const float*>(de) : nullptr,
                     de_dtype == 2 ? static_cast<const bf16*>(de) : nullptr,
                     nullptr, nullptr, nullptr, 1.0f / (float)H};
  return launch(op, src, stats, B, N, H, D, scale, stream);
}

// K2b. qkv (B, N, 3*H*D) bf16, g (B, N, H*D) bf16, dqkv (B, N, 3*H*D) bf16
// out, all contiguous and 16-byte aligned; de formed from sign (B / 2, N,
// N) int8 and g_cls, g_aff (B / 2,) fp32; B even, pairs interleaved.
int attn_bwd_pair(const void* qkv, const void* g, const void* sign, const void* g_cls,
                  const void* g_aff, void* dqkv, void* stats, int B, int N, int H, int D,
                  float scale, void* stream) {
  if (B % 2 || sign == nullptr || g_cls == nullptr || g_aff == nullptr)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const long long HD = (long long)H * D;
  const Strides cols{N * 3 * HD, 3 * HD, D}, rows{N * HD, HD, D};
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const Operands op{in, in + HD, in + 2 * HD, static_cast<const bf16*>(g),
                    out, out + HD, out + 2 * HD, cols, cols, cols, rows, cols, cols, cols};
  const DeSource src{nullptr, nullptr, static_cast<const int8_t*>(sign),
                     static_cast<const float*>(g_cls), static_cast<const float*>(g_aff),
                     1.0f / (float)H};
  return launch(op, src, stats, B, N, H, D, scale, stream);
}

const char* attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
