// PAMR's two stencils: the neighbour affinity (K3) and one Jacobi step of
// the mask under it (K4).
//
// Replaces the TPU kernels acr_wsss_tpu/ops/pamr_pallas.py::
// _affinity_kernel (K3, reached through the pallas_call at :206) and
// ::_update_kernel (K4, the pallas_call at :222, run num_iter times).
//
// Function. shift(x, dy, dx)[i, j] = x[clamp(i - dy), clamp(j - dx)] on
// each (H, W) plane: edges replicate, for any offset. For dilations
// d_1..d_n the P = 8n neighbours are (oy, ox) * d_i, dilation-major, with
// (oy, ox) row-major over the 3x3 window minus its centre.
//   K3, x (B, K, H, W) -> aff (B, P, H, W), per pixel:
//     per channel k: mean and Bessel-corrected variance, in two passes,
//       over the 9n window taps (the centre once per dilation);
//       denom = 1e-8 + 0.1 * std; logit_p += -|x_p - x| / denom
//     aff_p = softmax_p(logit_p / K)
//   K4, m (B, C, H, W), aff -> out (B, C, H, W):
//     out[c] = sum_p shift_p(m[c]) * aff_p, summed in p order.
// All fp32 with IEEE division, square root and expf: no fast-math
// intrinsics, and the sums are written with explicit _rn operations in the
// order of the plain versions in ops/pamr.py, so no fused multiply-add
// changes a rounding. Where std = 0 every |difference| is 0 too, and the
// logits are 0, not NaN.
//
// Bound on the card (fp32, 3.35 TB/s), at the inference shape B=2 views,
// K=3, C=20, H=W=384, P=48: K3 reads x (3.54 MB) and writes aff
// (56.62 MB), 17.96 us; K4 reads m (23.59 MB) and aff (56.62 MB) and
// writes m (23.59 MB), 30.99 us per step. The operations (about 0.42 and
// 0.57 GFLOP) take less on the fp32 CUDA cores. Memory sets both bounds.
// K4 has a second floor in the L1 cache: its gathers ask for
// B*C*H*W*P*4 bytes = 1.13 GB per step at B=2, 33.9 us at 128 bytes per
// clock and SM (132 SMs at 1.98 GHz, 33.4 TB/s).
//
// Design. The TPU kernels' 128-lane padding, row halo and channel padding
// are Mosaic constraints; clamped indices replace them. Neighbour reads go
// through the read-only cache; neighbouring threads read neighbouring
// addresses for every p.
//   K3: one thread per output pixel, a block of 256 consecutive pixels of
//   one image, so every store of aff is coalesced along x. The kernel is
//   templated on the number of dilations, so that the P logits sit in
//   registers; it reads each of its 9n taps once per channel and keeps
//   them in registers for both passes and the logits (254 registers: one
//   block per SM).
//   K4: one thread per output pixel, a block of 128 consecutive pixels of
//   one image. The block stages its pixels' P affinities in shared memory
//   once, with coalesced loads (24 KB at P = 48), so each affinity is read
//   once per pixel, not once per channel (the design point of
//   _update_kernel too). Then each thread walks the C channels, computing
//   each neighbour's clamped offset where it uses it (a few integer
//   operations per gather) instead of holding P offsets and P affinities
//   for the whole kernel. The registers go to gathers in flight instead:
//   128 per thread, no spill, four blocks per SM, where the earlier
//   design held 190 and ran one block per SM (278 us at B=2 on an H100,
//   now 136 us). The block's threads are on the same channel at the same
//   time, so L1 holds the neighbour rows of one channel plane per block;
//   spreading a pixel's channels over 4 threads of 5 channels each (64
//   registers) put 10 planes in flight per block and took 198 us.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDil = 8;
constexpr int kThreads = 256;

struct Dilations {
  int d[kMaxDil];
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Row and column of the three taps along one axis for dilation d: the
// offsets -d, 0, +d read at position - offset.
__device__ __forceinline__ void taps3(int pos, int d, int last, int out[3]) {
  out[0] = clampi(pos + d, last);
  out[1] = pos;
  out[2] = clampi(pos - d, last);
}

template <int NDIL>
__global__ void __launch_bounds__(kThreads)
pamr_affinity_kernel(const float* __restrict__ x, float* __restrict__ aff, int K, int H,
                     int W, Dilations dil) {
  constexpr int P = 8 * NDIL;
  constexpr int T = 9 * NDIL;
  const int HW = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= HW) return;
  const int b = blockIdx.y;
  const int y = pix / W, xc = pix - y * W;

  float logit[P];
#pragma unroll
  for (int p = 0; p < P; ++p) logit[p] = 0.f;

  for (int k = 0; k < K; ++k) {
    const float* xk = x + ((size_t)b * K + k) * HW;
    float tap[T];
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
      int r[3], c[3];
      taps3(y, dil.d[i], H - 1, r);
      taps3(xc, dil.d[i], W - 1, c);
#pragma unroll
      for (int t = 0; t < 9; ++t) tap[9 * i + t] = __ldg(xk + r[t / 3] * W + c[t % 3]);
    }
    float s1 = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) s1 = __fadd_rn(s1, tap[j]);
    const float mean = __fdiv_rn(s1, (float)T);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float v = __fsub_rn(tap[j], mean);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
    const float sd = __fsqrt_rn(__fdiv_rn(s2, (float)(T - 1)));
    const float denom = __fadd_rn(1e-8f, __fmul_rn(0.1f, sd));
    const float center = tap[4];
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float t = tap[9 * i + (o < 4 ? o : o + 1)];
        logit[8 * i + o] =
            __fadd_rn(logit[8 * i + o], __fdiv_rn(-fabsf(__fsub_rn(t, center)), denom));
      }
    }
  }

  float mx = -FLT_MAX;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    logit[p] = __fdiv_rn(logit[p], (float)K);
    mx = fmaxf(mx, logit[p]);
  }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    logit[p] = expf(__fsub_rn(logit[p], mx));
    sum = __fadd_rn(sum, logit[p]);
  }
  float* ab = aff + (size_t)b * P * HW + pix;
#pragma unroll
  for (int p = 0; p < P; ++p) ab[(size_t)p * HW] = __fdiv_rn(logit[p], sum);
}

// K4's block: 128 consecutive pixels of one image, one thread each; four
// blocks per SM leave a thread 128 registers for its gathers in flight.
constexpr int kUpdatePixels = 128;

template <int NDIL>
__global__ void __launch_bounds__(kUpdatePixels, 4)
pamr_update_kernel(const float* __restrict__ m, const float* __restrict__ aff,
                   float* __restrict__ out, int C, int H, int W, Dilations dil) {
  constexpr int P = 8 * NDIL;
  __shared__ float sA[P * kUpdatePixels];   // aff_p of the block's pixels, p-major
  const int HW = H * W;
  const int pix0 = blockIdx.x * kUpdatePixels, b = blockIdx.y, x = threadIdx.x;
  const int npix = min(kUpdatePixels, HW - pix0);
  const float* ab = aff + (size_t)b * P * HW + pix0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    sA[p * kUpdatePixels + x] = x < npix ? __ldg(ab + (size_t)p * HW + x) : 0.f;
  __syncthreads();
  if (x >= npix) return;

  // The block's threads walk the channels together, so the SM's L1 holds
  // the neighbour rows of one channel plane per block at a time.
  const int pix = pix0 + x, y = pix / W, xc = pix - y * W;
  const float* mc = m + (size_t)b * C * HW;
  float* oc = out + (size_t)b * C * HW + pix;
  for (int c = 0; c < C; ++c, mc += HW, oc += HW) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
      int r[3], cols[3];
      taps3(y, dil.d[i], H - 1, r);
      taps3(xc, dil.d[i], W - 1, cols);
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int t = o < 4 ? o : o + 1;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(mc + r[t / 3] * W + cols[t % 3]),
                                       sA[(8 * i + o) * kUpdatePixels + x]));
      }
    }
    *oc = acc;
  }
}

bool valid_shape(int B, int C, int H, int W, const int* dilations, int n_dil) {
  return B > 0 && B <= 65535 && C > 0 && H > 0 && W > 0 && (long long)H * W <= INT_MAX &&
         dilations != nullptr && n_dil >= 1 && n_dil <= kMaxDil;
}

Dilations pack(const int* dilations, int n_dil) {
  Dilations dil{};
  for (int i = 0; i < n_dil; ++i) dil.d[i] = dilations[i];
  return dil;
}

#define PAMR_DISPATCH(N_DIL, KERNEL, GRID, THREADS, STREAM, ...)                 \
  switch (N_DIL) {                                                               \
    case 1: KERNEL<1><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 2: KERNEL<2><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 3: KERNEL<3><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 4: KERNEL<4><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 5: KERNEL<5><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 6: KERNEL<6><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 7: KERNEL<7><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    case 8: KERNEL<8><<<GRID, THREADS, 0, STREAM>>>(__VA_ARGS__); break;         \
    default: return (int)cudaErrorInvalidValue;                                  \
  }

template <int NDIL>
int update_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pamr_update_kernel<NDIL>,
                                                    kUpdatePixels, 0) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace

extern "C" {

// x (B, K, H, W) fp32 -> aff (B, 8*n_dil, H, W) fp32, both contiguous;
// dilations: n_dil (1..8) host ints. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int pamr_affinity(const void* x, void* aff, int B, int K, int H, int W, const int* dilations,
                  int n_dil, void* stream) {
  if (!valid_shape(B, K, H, W, dilations, n_dil)) return (int)cudaErrorInvalidValue;
  const Dilations dil = pack(dilations, n_dil);
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PAMR_DISPATCH(n_dil, pamr_affinity_kernel, grid, kThreads, s, static_cast<const float*>(x),
                static_cast<float*>(aff), K, H, W, dil)
  return (int)cudaGetLastError();
}

// One Jacobi step: m (B, C, H, W), aff (B, 8*n_dil, H, W) -> out
// (B, C, H, W), all fp32 and contiguous; out must not overlap m.
int pamr_update(const void* m, const void* aff, void* out, int B, int C, int H, int W,
                const int* dilations, int n_dil, void* stream) {
  if (!valid_shape(B, C, H, W, dilations, n_dil) || m == out) return (int)cudaErrorInvalidValue;
  const Dilations dil = pack(dilations, n_dil);
  const dim3 grid((H * W + kUpdatePixels - 1) / kUpdatePixels, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PAMR_DISPATCH(n_dil, pamr_update_kernel, grid, kUpdatePixels, s, static_cast<const float*>(m),
                static_cast<const float*>(aff), static_cast<float*>(out), C, H, W, dil)
  return (int)cudaGetLastError();
}

// Blocks of the update kernel for n_dil dilations that one SM holds at
// once (0 on an error or an n_dil outside 1..8).
int pamr_update_blocks_per_sm(int n_dil) {
  switch (n_dil) {
    case 1: return update_blocks_per_sm<1>();
    case 2: return update_blocks_per_sm<2>();
    case 3: return update_blocks_per_sm<3>();
    case 4: return update_blocks_per_sm<4>();
    case 5: return update_blocks_per_sm<5>();
    case 6: return update_blocks_per_sm<6>();
    case 7: return update_blocks_per_sm<7>();
    case 8: return update_blocks_per_sm<8>();
    default: return 0;
  }
}

const char* pamr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
