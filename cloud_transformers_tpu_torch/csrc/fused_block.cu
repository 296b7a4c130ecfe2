// The fused MHCT block: splat-max -> grouped 'same' 3^dim conv + bias ->
// slice, for one grid row r = b * H + h per thread block.
//
// Replaces cloud_transformers_tpu/ops/pallas_fused_block.py:
// pallas_fused_block, which runs the three Pallas kernel bodies in turn on a
// grid held in VMEM, one grid row per program.  Here one thread block owns
// one row, so the phases meet at __syncthreads() and nothing crosses
// blocks; R = B * H = 128 rows are about one wave on 132 SMs.
//
// * The head's 9 * DZ * F * F weights are staged in dynamic shared memory
//   (108 KiB for 8^3 x 32, above the 48 KiB default: the entry point opts
//   in).  The splatted grid gk, and then the convolved grid gk2, stay in
//   shared memory where they fit beside the weights (16^2 x 16: both; 8^3 x
//   32: gk only).  The larger grids (128^2 x 4, 64^2 x 16, 16^3 x 16:
//   256 KiB; 32^3 x 4: 512 KiB) exceed the 227 KB a block can have, and
//   live in device memory: gk in its output, gk2 in its output or scratch.
//   __syncthreads() makes every thread's writes and atomics visible to the
//   whole block, in device memory as in shared memory.
// * Phase 1, the splat: a thread per (point, feature) of the row; each
//   positive contribution w * v goes in with atomicMax on its int32 bits
//   into a zero-filled grid, as in splat_max: bit-equal to it.
// * Phase 2, the conv: a thread per output (cell, fo), the taps in the
//   order of grid_conv_kernel, bias last.
// * Phase 3, the slice: a thread per (point, feature), the vertices in the
//   order of slice_kernel.  2D mappings carry zero weights in slots 2 and 3,
//   which are skipped.
//
// Bound on the H100: the conv's float32 operations for the F = 16 grids,
// and bytes (the mapping and point features in, the points and gk out, gk2
// out under a gradient) for the others.  One block per row leaves the card
// at one wave: each SM walks its whole row's conv alone, with every MAC's
// input reloaded from shared memory or through L1.  Spreading a row over a
// thread-block cluster (distributed shared memory) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's opt-in limit

template <int DZ>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
                   const float* __restrict__ w_lo,
                   const float* __restrict__ w_hi,
                   const float* __restrict__ values,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ pts,
                   float* __restrict__ gk_out, float* __restrict__ gk2_out,
                   int H, int K, int F, int X, int Y, int Z, int gk_smem,
                   int gk2_smem, int want_gk2) {
  constexpr int kTaps = 9 * DZ;
  constexpr int kVert = DZ == 3 ? 4 : 2;
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int h = r % H;
  const int lane_extent = Y * Z;
  const int64_t cells = (int64_t)X * lane_extent;
  const int64_t row_len = cells * F;
  const int n_w = kTaps * F * F;
  float* w_s = smem;  // [taps][F][F] as (tap, fi, fo)
  float* gk = gk_smem ? smem + n_w : gk_out + r * row_len;
  float* gk2 = gk2_smem ? smem + n_w + row_len : gk2_out + r * row_len;

  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    const int fo = i % F;
    const int fi = (i / F) % F;
    const int tap = i / (F * F);
    w_s[i] = weight[((int64_t)(h * F + fo) * F + fi) * kTaps + tap];
  }
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) gk[i] = 0.0f;
  __syncthreads();

  // phase 1: splat-max into gk
  const int offs[4] = {0, 1, Z, Z + 1};  // 2D: slots 0 and 1 only
  const int64_t p0 = (int64_t)r * K;
  int* gk_i = reinterpret_cast<int*>(gk);
  for (int64_t t = threadIdx.x; t < (int64_t)K * F; t += blockDim.x) {
    const int64_t p = p0 + t / F;
    const int f = (int)(t % F);
    const float v = values[p * F + f];
    const int base = x0[p] * lane_extent + lane0[p];
#pragma unroll
    for (int j = 0; j < kVert; ++j) {
      const float c_lo = w_lo[p * 4 + j] * v;
      if (c_lo > 0.0f)
        atomicMax(gk_i + (int64_t)(base + offs[j]) * F + f,
                  __float_as_int(c_lo));
      const float c_hi = w_hi[p * 4 + j] * v;
      if (c_hi > 0.0f)
        atomicMax(gk_i + (int64_t)(base + lane_extent + offs[j]) * F + f,
                  __float_as_int(c_hi));
    }
  }
  __syncthreads();

  // phase 2: the grouped conv gk -> gk2, and gk out of shared memory
  for (int64_t t = threadIdx.x; t < row_len; t += blockDim.x) {
    const int fo = (int)(t % F);
    const int64_t cell = t / F;
    const int z = (int)(cell % Z);
    const int y = (int)((cell / Z) % Y);
    const int x = (int)(cell / lane_extent);
    float acc = 0.0f;
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
      if (xx < 0 || xx >= X) continue;
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= Y) continue;
        for (int dz = 0; dz < DZ; ++dz) {
          const int zz = z + dz - DZ / 2;
          if (zz < 0 || zz >= Z) continue;
          const float* src = gk + (((int64_t)xx * Y + yy) * Z + zz) * F;
          const float* w = w_s + ((dx * 3 + dy) * DZ + dz) * F * F + fo;
          for (int fi = 0; fi < F; ++fi) acc += src[fi] * w[fi * F];
        }
      }
    }
    gk2[t] = acc + bias[h * F + fo];
    if (gk_smem) gk_out[r * row_len + t] = gk[t];
  }
  __syncthreads();

  // phase 3: slice the points from gk2, and gk2 out of shared memory
  for (int64_t t = threadIdx.x; t < (int64_t)K * F; t += blockDim.x) {
    const int64_t p = p0 + t / F;
    const int f = (int)(t % F);
    const int base = x0[p] * lane_extent + lane0[p];
    const float* g = gk2 + f;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kVert; ++j)
      acc += w_lo[p * 4 + j] * g[(int64_t)(base + offs[j]) * F];
#pragma unroll
    for (int j = 0; j < kVert; ++j)
      acc += w_hi[p * 4 + j] * g[(int64_t)(base + lane_extent + offs[j]) * F];
    pts[p * F + f] = acc;
  }
  if (gk2_smem && want_gk2)
    for (int64_t t = threadIdx.x; t < row_len; t += blockDim.x)
      gk2_out[r * row_len + t] = gk2[t];
}

template <int DZ>
int launch(const int* x0, const int* lane0, const float* w_lo,
           const float* w_hi, const float* values, const float* weight,
           const float* bias, float* pts, float* gk, float* gk2, int R, int H,
           int K, int F, int X, int Y, int Z, int want_gk2, void* stream) {
  const size_t w_bytes = (size_t)9 * DZ * F * F * sizeof(float);
  const size_t g_bytes = (size_t)X * Y * Z * F * sizeof(float);
  if (w_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int gk_smem = w_bytes + g_bytes <= kMaxSmem;
  const int gk2_smem = gk_smem && w_bytes + 2 * g_bytes <= kMaxSmem;
  const size_t smem = w_bytes + (gk_smem + gk2_smem) * g_bytes;
  if (smem > kDefaultSmem) {
    const int err = (int)cudaFuncSetAttribute(
        fused_block_kernel<DZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != 0) return err;
  }
  fused_block_kernel<DZ><<<R, kThreads, smem, (cudaStream_t)stream>>>(
      x0, lane0, w_lo, w_hi, values, weight, bias, pts, gk, gk2, H, K, F, X,
      Y, Z, gk_smem, gk2_smem, want_gk2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).  ``gk2`` is
// always a buffer of [R, G, F] floats: the output with ``want_gk2``, else
// scratch for grids that do not fit in shared memory.  ``dim`` is 2 (Z = 1)
// or 3.
extern "C" int ct_fused_block(const int* x0, const int* lane0,
                              const float* w_lo, const float* w_hi,
                              const float* values, const float* weight,
                              const float* bias, float* pts, float* gk,
                              float* gk2, int R, int H, int K, int F, int X,
                              int Y, int Z, int dim, int want_gk2,
                              void* stream) {
  if (R <= 0 || K < 0 || F <= 0) return 0;
  if (dim == 2)
    return launch<1>(x0, lane0, w_lo, w_hi, values, weight, bias, pts, gk,
                     gk2, R, H, K, F, X, Y, 1, want_gk2, stream);
  return launch<3>(x0, lane0, w_lo, w_hi, values, weight, bias, pts, gk, gk2,
                   R, H, K, F, X, Y, Z, want_gk2, stream);
}
