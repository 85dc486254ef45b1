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
// All fp32 with IEEE division (K3's tile route: a multiply by a correctly
// rounded reciprocal), square root and expf: no fast-math intrinsics, and
// the sums are written with explicit _rn operations in the
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
// are Mosaic constraints; clamped indices replace them.
//   K3, tile route: a block of 32 x 8 threads owns a tile of 8 rows by 32
//   columns of output pixels, one pixel per thread, so each warp's store
//   of one aff plane is one full 128-byte row along x. The block stages
//   the guidance one channel at a time as a halo tile in shared memory:
//   the output tile plus R = max |d| on every side, each source index
//   clamped at staging time, which replicates the edges, so the inner
//   loops read their taps from shared memory with no clamp and no global
//   gather. Channel k+1 is staged with 4-byte cp.async while channel k
//   computes (two buffers, 2 (8 + 2R)(32 + 2R) floats: 35.8 KB at R = 24,
//   whatever K is). A thread keeps its P logits and its channel's mean
//   and reciprocal denominator in registers; the source reads each tap
//   from shared memory in each of the three passes (sum, variance,
//   logits), and the compiler keeps a channel's distinct taps in the
//   registers that the clamped indices and gather addresses of the gather
//   route took: one shared load per tap and channel, 128 registers under
//   the launch bound, no spill up to 7 dilations (8 spill 184 bytes), two
//   blocks (16 warps) per SM, where the gather route holds 254 and runs
//   one block. Each |difference| / denom is a multiply by the channel's
//   correctly rounded reciprocal 1 / denom, the mean over the K channels
//   a multiply by 1 / K and the softmax's division a multiply by 1 / sum,
//   as the TPU kernel multiplies by its reciprocal: per pixel and channel
//   two divisions, one reciprocal and one square root, where the gather
//   route divides 50 times per channel and 96 more per pixel
//   (tests/test_torch_pamr_tiles.py emulates this order on the CPU and
//   holds it to the gate of chip_smoke.py). TMA would not do: its
//   out-of-bounds fill is zero, not the replicated edge. The route takes
//   |d| <= kMaxHalo = 24, the recipe's largest dilation.
//   K3, gather route, for a larger dilation: the first design, one thread
//   per output pixel in blocks of 256 consecutive pixels of one image.
//   Templated on the number of dilations, so that the P logits sit in
//   registers, it gathers each of its 9n clamped taps once per channel
//   through the read-only cache and keeps them in registers for both
//   passes and the logits, with IEEE divisions throughout (254
//   registers: one block per SM). pamr_affinity chooses the route from
//   the dilations before it launches; both count as K3.
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

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdlib>
#include <type_traits>

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

// K3's tile route: a block of kTileCols x kTileRows threads, one output
// pixel each; halo tiles of at most kMaxHalo on every side, so a lane
// stages at most three columns of a halo row.
constexpr int kTileRows = 8;
constexpr int kTileCols = 32;
constexpr int kMaxHalo = 24;
static_assert(kTileCols == 32 && kTileCols + 2 * kMaxHalo <= 3 * 32,
              "stage_halo: one warp per halo row, three columns per lane");

__host__ __device__ constexpr int halo_floats(int R) {
  return (kTileRows + 2 * R) * (kTileCols + 2 * R);
}

// Both halo buffers, in bytes: 35.8 KB at kMaxHalo, under the 48 KB that a
// launch may ask for without an opt-in.
constexpr size_t tile_smem_bytes(int R) { return 2 * sizeof(float) * halo_floats(R); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most kPending committed groups of this thread's copies are
// in flight; a __syncthreads() must follow before other threads' copies
// are read.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The halo tile of one (H, W) plane: rows y0 - R .. y0 + kTileRows + R - 1
// and columns x0 - R .. x0 + kTileCols + R - 1, each clamped into the
// image, into the buffer at shared address dst with row pitch
// kTileCols + 2R; warp ty takes rows ty, ty + kTileRows, ..., lane j of a
// row columns j, j + 32, j + 64, whose clamped source columns are cols[].
// Issues 4-byte cp.async without committing.
__device__ __forceinline__ void stage_halo(unsigned dst, const float* plane, int H, int W,
                                           int y0, int R, const int cols[3]) {
  const int pitch = kTileCols + 2 * R, rows = kTileRows + 2 * R;
  dst += 4 * (threadIdx.y * pitch + threadIdx.x);
  for (int r = threadIdx.y; r < rows; r += kTileRows, dst += 4 * kTileRows * pitch) {
    const float* src = plane + (size_t)clampi(y0 - R + r, H - 1) * W;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (threadIdx.x + 32 * j < pitch)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 128 * j),
                     "l"(src + cols[j])
                     : "memory");
  }
}

// R = max |d_i| <= kMaxHalo; the grid is (tiles along x * tiles along y, B).
template <int NDIL>
__global__ void __launch_bounds__(kTileRows * kTileCols, 2)
pamr_affinity_tile_kernel(const float* __restrict__ x, float* __restrict__ aff, int K, int H,
                          int W, Dilations dil, int R) {
  constexpr int P = 8 * NDIL;
  constexpr int T = 9 * NDIL;
  extern __shared__ float halo[];
  const int pitch = kTileCols + 2 * R, plane = halo_floats(R);
  const int tiles_x = (W + kTileCols - 1) / kTileCols;
  const int y0 = blockIdx.x / tiles_x * kTileRows;
  const int x0 = blockIdx.x % tiles_x * kTileCols;
  const int b = blockIdx.y, HW = H * W;
  const float* xb = x + (size_t)b * K * HW;

  int cols[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) cols[j] = clampi(x0 - R + threadIdx.x + 32 * j, W - 1);
  const unsigned halo_s = smem_addr(halo);
  stage_halo(halo_s, xb, H, W, y0, R, cols);
  cp_async_commit();

  float logit[P];
#pragma unroll
  for (int p = 0; p < P; ++p) logit[p] = 0.f;
  // This thread's pixel in the halo tile; tap (oy, ox) * d of the window
  // reads the pixel at offset -(oy * d, ox * d), as shift() does.
  const int centre = (threadIdx.y + R) * pitch + threadIdx.x + R;

  for (int k = 0; k < K; ++k) {
    if (k + 1 < K) {
      stage_halo(halo_s + 4 * ((k + 1) & 1) * plane, xb + (size_t)(k + 1) * HW, H, W, y0, R,
                 cols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s = halo + (k & 1) * plane + centre;

    float s1 = 0.f;
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
      const int d = dil.d[i], dr = d * pitch;
#pragma unroll
      for (int t = 0; t < 9; ++t) s1 = __fadd_rn(s1, s[(1 - t / 3) * dr + (1 - t % 3) * d]);
    }
    const float mean = __fdiv_rn(s1, (float)T);
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
      const int d = dil.d[i], dr = d * pitch;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = __fsub_rn(s[(1 - t / 3) * dr + (1 - t % 3) * d], mean);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
      }
    }
    const float sd = __fsqrt_rn(__fdiv_rn(s2, (float)(T - 1)));
    const float inv = __frcp_rn(__fadd_rn(1e-8f, __fmul_rn(0.1f, sd)));
    const float c = s[0];
#pragma unroll
    for (int i = 0; i < NDIL; ++i) {
      const int d = dil.d[i], dr = d * pitch;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int t = o < 4 ? o : o + 1;
        const float v = s[(1 - t / 3) * dr + (1 - t % 3) * d];
        logit[8 * i + o] = __fadd_rn(logit[8 * i + o], __fmul_rn(-fabsf(__fsub_rn(v, c)), inv));
      }
    }
    // Every thread is done with this buffer before channel k + 2 is staged
    // into it.
    __syncthreads();
  }

  const int y = y0 + threadIdx.y, xc = x0 + threadIdx.x;
  if (y >= H || xc >= W) return;
  const float inv_k = __frcp_rn((float)K);
  float mx = -FLT_MAX;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    logit[p] = __fmul_rn(logit[p], inv_k);
    mx = fmaxf(mx, logit[p]);
  }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    logit[p] = expf(__fsub_rn(logit[p], mx));
    sum = __fadd_rn(sum, logit[p]);
  }
  const float inv_sum = __frcp_rn(sum);
  float* ab = aff + (size_t)b * P * HW + (size_t)y * W + xc;
#pragma unroll
  for (int p = 0; p < P; ++p) ab[(size_t)p * HW] = __fmul_rn(logit[p], inv_sum);
}

// K3's gather route, for dilations beyond kMaxHalo.
template <int NDIL>
__global__ void __launch_bounds__(kThreads)
pamr_affinity_gather_kernel(const float* __restrict__ x, float* __restrict__ aff, int K, int H,
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

// f(std::integral_constant<int, n_dil>()) for n_dil in 1..8, else `otherwise`.
template <class F>
int with_ndil(int n_dil, int otherwise, F&& f) {
  switch (n_dil) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return otherwise;
  }
}

long long max_abs_dilation(const int* dilations, int n_dil) {
  long long r = 0;
  for (int i = 0; i < n_dil; ++i) r = std::max(r, std::llabs((long long)dilations[i]));
  return r;
}

}  // namespace

extern "C" {

// x (B, K, H, W) fp32 -> aff (B, 8*n_dil, H, W) fp32, both contiguous;
// dilations: n_dil (1..8) host ints. Launches the tile route when every
// |dilation| <= pamr_affinity_max_halo(), else the gather route, on
// `stream`, and returns the first CUDA error (0 on success).
int pamr_affinity(const void* x, void* aff, int B, int K, int H, int W, const int* dilations,
                  int n_dil, void* stream) {
  if (!valid_shape(B, K, H, W, dilations, n_dil)) return (int)cudaErrorInvalidValue;
  const Dilations dil = pack(dilations, n_dil);
  const long long halo = max_abs_dilation(dilations, n_dil);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* ap = static_cast<float*>(aff);
  return with_ndil(n_dil, (int)cudaErrorInvalidValue, [&](auto n) {
    constexpr int N = decltype(n)::value;
    if (halo <= kMaxHalo) {
      const int R = (int)halo;
      const int tiles = ((W + kTileCols - 1) / kTileCols) * ((H + kTileRows - 1) / kTileRows);
      pamr_affinity_tile_kernel<N><<<dim3(tiles, B), dim3(kTileCols, kTileRows),
                                     tile_smem_bytes(R), s>>>(xp, ap, K, H, W, dil, R);
    } else {
      pamr_affinity_gather_kernel<N><<<dim3((H * W + kThreads - 1) / kThreads, B), kThreads,
                                       0, s>>>(xp, ap, K, H, W, dil);
    }
    return (int)cudaGetLastError();
  });
}

// The largest |dilation| that pamr_affinity's tile route takes.
int pamr_affinity_max_halo() { return kMaxHalo; }

// Blocks of the tile route's kernel for n_dil dilations that one SM holds
// at once, at the largest halo (0 on an error or an n_dil outside 1..8).
int pamr_affinity_blocks_per_sm(int n_dil) {
  return with_ndil(n_dil, 0, [](auto n) {
    constexpr int N = decltype(n)::value;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pamr_affinity_tile_kernel<N>,
                                                      kTileRows * kTileCols,
                                                      tile_smem_bytes(kMaxHalo)) != cudaSuccess)
      return 0;
    return blocks;
  });
}

// One Jacobi step: m (B, C, H, W), aff (B, 8*n_dil, H, W) -> out
// (B, C, H, W), all fp32 and contiguous; out must not overlap m.
int pamr_update(const void* m, const void* aff, void* out, int B, int C, int H, int W,
                const int* dilations, int n_dil, void* stream) {
  if (!valid_shape(B, C, H, W, dilations, n_dil) || m == out) return (int)cudaErrorInvalidValue;
  const Dilations dil = pack(dilations, n_dil);
  const dim3 grid((H * W + kUpdatePixels - 1) / kUpdatePixels, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_ndil(n_dil, (int)cudaErrorInvalidValue, [&](auto n) {
    pamr_update_kernel<decltype(n)::value><<<grid, kUpdatePixels, 0, s>>>(
        static_cast<const float*>(m), static_cast<const float*>(aff), static_cast<float*>(out),
        C, H, W, dil);
    return (int)cudaGetLastError();
  });
}

// Blocks of the update kernel for n_dil dilations that one SM holds at
// once (0 on an error or an n_dil outside 1..8).
int pamr_update_blocks_per_sm(int n_dil) {
  return with_ndil(n_dil, 0, [](auto n) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, pamr_update_kernel<decltype(n)::value>, kUpdatePixels, 0) != cudaSuccess)
      return 0;
    return blocks;
  });
}

const char* pamr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
