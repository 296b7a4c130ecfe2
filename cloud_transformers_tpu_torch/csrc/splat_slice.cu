// Splat (scatter-max) and Slice (weighted gather) on flat per-(batch, head)
// grids [R, G, F]: cell g = x * lane_extent + lane, with lane = y (2D) or
// y * Z + z (3D), and F contiguous.
//
// Replaces cloud_transformers_tpu/ops/pallas_splat.py: pallas_splat
// (op='max') and pallas_slice.  The TPU kernels keep one whole grid in VMEM
// per program and loop over the points in order.  On the H100 most of the
// classifier's per-(b, h) grids (128^2 x 4, 64^2 x 16, 16^3 x 16, 32^3 x 4
// f32: 256-512 KiB) exceed the 227 KB of shared memory a block can have, so
// these first kernels work on device memory directly:
//
// * splat_max: one thread per (point, feature).  The grid is zero-filled by
//   the wrapper; each of the point's 2^dim contributions w * v that is > 0
//   goes in with atomicMax on its int32 bit pattern.  Non-negative IEEE
//   floats order like their bit patterns, and a contribution <= 0 (-0.0
//   included) always loses to the zero fill, so the result is exact and the
//   same in every run, whatever order the atomics land in.
// * slice: one thread per (point, feature), no atomics: the weighted sum of
//   the 2^dim vertex values, read with neighbouring threads on neighbouring
//   features.
//
// Bound on the H100: bytes.  Each point reads 40 bytes of mapping and 4F of
// features, and the grid is written (splat) or read (slice) once; the
// arithmetic is a few operations per byte.  The splat's atomics are what
// keeps it from that bound: 2^dim * F of them per point, resolved in L2.
// Shared-memory tiling of the grid by x slabs is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void splat_max_kernel(const int* __restrict__ x0,
                                 const int* __restrict__ lane0,
                                 const float* __restrict__ w_lo,
                                 const float* __restrict__ w_hi,
                                 const float* __restrict__ values,
                                 float* __restrict__ grid,
                                 int64_t n_points_total, int K, int F, int G,
                                 int lane_extent, int off2, int off3,
                                 int n_vert) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points_total * F) return;
  const int64_t p = t / F;  // r * K + k
  const int f = (int)(t - p * F);
  const int64_t r = p / K;
  const float v = values[t];
  const int base = x0[p] * lane_extent + lane0[p];
  const int offs[4] = {0, 1, off2, off3};
  int* g = reinterpret_cast<int*>(grid + r * (int64_t)G * F) + f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_vert) break;
    const float c_lo = w_lo[p * 4 + j] * v;
    if (c_lo > 0.0f)
      atomicMax(g + (int64_t)(base + offs[j]) * F, __float_as_int(c_lo));
    const float c_hi = w_hi[p * 4 + j] * v;
    if (c_hi > 0.0f)
      atomicMax(g + (int64_t)(base + lane_extent + offs[j]) * F,
                __float_as_int(c_hi));
  }
}

__global__ void slice_kernel(const int* __restrict__ x0,
                             const int* __restrict__ lane0,
                             const float* __restrict__ w_lo,
                             const float* __restrict__ w_hi,
                             const float* __restrict__ grid,
                             float* __restrict__ out,
                             int64_t n_points_total, int K, int F, int G,
                             int lane_extent, int off2, int off3,
                             int n_vert) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points_total * F) return;
  const int64_t p = t / F;
  const int f = (int)(t - p * F);
  const int64_t r = p / K;
  const int base = x0[p] * lane_extent + lane0[p];
  const int offs[4] = {0, 1, off2, off3};
  const float* g = grid + r * (int64_t)G * F + f;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_vert) break;
    acc += w_lo[p * 4 + j] * g[(int64_t)(base + offs[j]) * F];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_vert) break;
    acc += w_hi[p * 4 + j] * g[(int64_t)(base + lane_extent + offs[j]) * F];
  }
  out[t] = acc;
}

unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int ct_splat_max(const int* x0, const int* lane0, const float* w_lo,
                            const float* w_hi, const float* values,
                            float* grid, int R, int K, int F, int G,
                            int lane_extent, int off2, int off3, int n_vert,
                            void* stream) {
  const int64_t n = (int64_t)R * K;
  if (n * F > 0)
    splat_max_kernel<<<n_blocks(n * F), kThreads, 0,
                       (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, values, grid, n, K, F, G, lane_extent, off2,
        off3, n_vert);
  return (int)cudaGetLastError();
}

extern "C" int ct_slice(const int* x0, const int* lane0, const float* w_lo,
                        const float* w_hi, const float* grid, float* out,
                        int R, int K, int F, int G, int lane_extent, int off2,
                        int off3, int n_vert, void* stream) {
  const int64_t n = (int64_t)R * K;
  if (n * F > 0)
    slice_kernel<<<n_blocks(n * F), kThreads, 0, (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, grid, out, n, K, F, G, lane_extent, off2,
        off3, n_vert);
  return (int)cudaGetLastError();
}
