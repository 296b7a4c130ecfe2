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
//
// The backward kernels replace pallas_splat_bwd (winner mode) and
// pallas_slice_bwd of the same file.  The TPU kernels walk a row's points in
// order against a grid held in VMEM, and keep the winner as a float index
// merged over rotating banks.  Here:
//
// * splat_max_bwd, two launches.  Pass 1 (one thread per point and feature)
//   recomputes each contribution c = w * v as one float32 multiply and, where
//   c == grid and grid > 0, takes atomicMin of the int32 point index k on a
//   winner map [R, G, F] that the wrapper filled with INT_MAX.  The minimum
//   does not depend on the order, so the routing is the lowest-indexed
//   winner in every run, and INT_MAX is no point index, so a cell that
//   nobody won routes nothing.  Pass 2 has read-only gathers: where
//   winner == k the contribution's cotangent is g, else 0; d_values sums
//   w * dcon over the vertices, d_w sums v * dcon over the features.
// * slice_bwd, one launch: d_grid gets w * g by float atomicAdd into a grid
//   the wrapper zero-filled (the order of these sums differs from run to
//   run), d_w is the dot of the vertex's grid row with g over the features,
//   with no atomics.
//
// In both, the features of a point sit on a group of 1 to 32 neighbouring
// lanes of one warp (the next power of two >= min(F, 32)); a lane loops
// over f with that stride, and the sums over f are shuffles inside the
// group.  The 2D mappings' slots 2 and 3 are never read and get d_w = 0.
//
// Bound on the H100: bytes, as for the forward kernels: the mapping, the
// point features and cotangents, and the grid rows the points touch (the
// winner map is scratch and is not counted).  What keeps them from it is
// the scattered 4-byte traffic: 2^dim * F atomics per point (atomicMin in
// the splat backward's pass 1, atomicAdd in the slice backward), resolved
// in L2, and as many scattered reads in pass 2.

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

// ---- backward kernels ------------------------------------------------------

// Sum over the lanes of one group (width a power of two <= 32).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

__global__ void splat_winner_kernel(const int* __restrict__ x0,
                                    const int* __restrict__ lane0,
                                    const float* __restrict__ w_lo,
                                    const float* __restrict__ w_hi,
                                    const float* __restrict__ values,
                                    const float* __restrict__ grid,
                                    int* __restrict__ winner,
                                    int64_t n_points_total, int K, int F,
                                    int G, int lane_extent, int off2,
                                    int off3, int n_vert) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points_total * F) return;
  const int64_t p = t / F;  // r * K + k
  const int f = (int)(t - p * F);
  const int64_t r = p / K;
  const int k = (int)(p - r * K);
  const float v = values[t];
  const int base = x0[p] * lane_extent + lane0[p];
  const int offs[4] = {0, 1, off2, off3};
  const int64_t row = r * (int64_t)G * F + f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_vert) break;
    // one rounded multiply, never fused: c must be the forward's number
    const float c_lo = __fmul_rn(w_lo[p * 4 + j], v);
    const int64_t i_lo = row + (int64_t)(base + offs[j]) * F;
    if (c_lo > 0.0f && c_lo == grid[i_lo]) atomicMin(winner + i_lo, k);
    const float c_hi = __fmul_rn(w_hi[p * 4 + j], v);
    const int64_t i_hi = row + (int64_t)(base + lane_extent + offs[j]) * F;
    if (c_hi > 0.0f && c_hi == grid[i_hi]) atomicMin(winner + i_hi, k);
  }
}

__global__ void splat_route_kernel(const int* __restrict__ x0,
                                   const int* __restrict__ lane0,
                                   const float* __restrict__ w_lo,
                                   const float* __restrict__ w_hi,
                                   const float* __restrict__ values,
                                   const int* __restrict__ winner,
                                   const float* __restrict__ g,
                                   float* __restrict__ d_w_lo,
                                   float* __restrict__ d_w_hi,
                                   float* __restrict__ d_values,
                                   int64_t n_points_total, int K, int F,
                                   int G, int lane_extent, int off2, int off3,
                                   int n_vert, int group) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p_raw = t / group;
  const int sub = (int)(t - p_raw * group);
  // lanes past the last point keep shuffling with their warp, on point 0
  const bool live = p_raw < n_points_total;
  const int64_t p = live ? p_raw : 0;
  const int64_t r = p / K;
  const int k = (int)(p - r * K);
  const int base = x0[p] * lane_extent + lane0[p];
  const int offs[4] = {0, 1, off2, off3};
  float wl[4], wh[4], dl[4], dh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wl[j] = w_lo[p * 4 + j];
    wh[j] = w_hi[p * 4 + j];
    dl[j] = dh[j] = 0.0f;
  }
  const int64_t row = r * (int64_t)G * F;
  for (int f = sub; f < F; f += group) {
    const float v = values[p * F + f];
    float dv = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= n_vert) break;
      const int64_t i_lo = row + (int64_t)(base + offs[j]) * F + f;
      const float c_lo = winner[i_lo] == k ? g[i_lo] : 0.0f;
      dv += wl[j] * c_lo;
      dl[j] += v * c_lo;
      const int64_t i_hi = i_lo + (int64_t)lane_extent * F;
      const float c_hi = winner[i_hi] == k ? g[i_hi] : 0.0f;
      dv += wh[j] * c_hi;
      dh[j] += v * c_hi;
    }
    if (live) d_values[p * F + f] = dv;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dl[j] = group_sum(dl[j], group);
    dh[j] = group_sum(dh[j], group);
  }
  if (live && sub == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d_w_lo[p * 4 + j] = dl[j];
      d_w_hi[p * 4 + j] = dh[j];
    }
  }
}

__global__ void slice_bwd_kernel(const int* __restrict__ x0,
                                 const int* __restrict__ lane0,
                                 const float* __restrict__ w_lo,
                                 const float* __restrict__ w_hi,
                                 const float* __restrict__ g_pts,
                                 const float* __restrict__ grid,
                                 float* __restrict__ d_grid,
                                 float* __restrict__ d_w_lo,
                                 float* __restrict__ d_w_hi,
                                 int64_t n_points_total, int K, int F, int G,
                                 int lane_extent, int off2, int off3,
                                 int n_vert, int group) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p_raw = t / group;
  const int sub = (int)(t - p_raw * group);
  const bool live = p_raw < n_points_total;
  const int64_t p = live ? p_raw : 0;
  const int64_t r = p / K;
  const int base = x0[p] * lane_extent + lane0[p];
  const int offs[4] = {0, 1, off2, off3};
  float wl[4], wh[4], dl[4], dh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wl[j] = w_lo[p * 4 + j];
    wh[j] = w_hi[p * 4 + j];
    dl[j] = dh[j] = 0.0f;
  }
  const int64_t row = r * (int64_t)G * F;
  for (int f = sub; f < F; f += group) {
    const float gp = g_pts[p * F + f];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= n_vert) break;
      const int64_t i_lo = row + (int64_t)(base + offs[j]) * F + f;
      const int64_t i_hi = i_lo + (int64_t)lane_extent * F;
      dl[j] += grid[i_lo] * gp;
      dh[j] += grid[i_hi] * gp;
      if (live) {
        atomicAdd(d_grid + i_lo, wl[j] * gp);
        atomicAdd(d_grid + i_hi, wh[j] * gp);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dl[j] = group_sum(dl[j], group);
    dh[j] = group_sum(dh[j], group);
  }
  if (live && sub == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d_w_lo[p * 4 + j] = dl[j];
      d_w_hi[p * 4 + j] = dh[j];
    }
  }
}

// Lanes that share one point: the next power of two >= min(F, 32).
int feature_group(int F) {
  int group = 1;
  while (group < F && group < 32) group <<= 1;
  return group;
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

// Two launches: the winner map (int32 [R, G, F], filled with INT_MAX by the
// caller), then the routing.
extern "C" int ct_splat_max_bwd(const int* x0, const int* lane0,
                                const float* w_lo, const float* w_hi,
                                const float* values, const float* grid,
                                const float* g, int* winner, float* d_w_lo,
                                float* d_w_hi, float* d_values, int R, int K,
                                int F, int G, int lane_extent, int off2,
                                int off3, int n_vert, void* stream) {
  const int64_t n = (int64_t)R * K;
  if (n * F > 0) {
    splat_winner_kernel<<<n_blocks(n * F), kThreads, 0,
                          (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, values, grid, winner, n, K, F, G, lane_extent,
        off2, off3, n_vert);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int group = feature_group(F);
    splat_route_kernel<<<n_blocks(n * group), kThreads, 0,
                         (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, values, winner, g, d_w_lo, d_w_hi, d_values,
        n, K, F, G, lane_extent, off2, off3, n_vert, group);
  }
  return (int)cudaGetLastError();
}

// d_grid must arrive zero-filled.
extern "C" int ct_slice_bwd(const int* x0, const int* lane0,
                            const float* w_lo, const float* w_hi,
                            const float* g_pts, const float* grid,
                            float* d_grid, float* d_w_lo, float* d_w_hi,
                            int R, int K, int F, int G, int lane_extent,
                            int off2, int off3, int n_vert, void* stream) {
  const int64_t n = (int64_t)R * K;
  if (n * F > 0) {
    const int group = feature_group(F);
    slice_bwd_kernel<<<n_blocks(n * group), kThreads, 0,
                       (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, g_pts, grid, d_grid, d_w_lo, d_w_hi, n, K, F,
        G, lane_extent, off2, off3, n_vert, group);
  }
  return (int)cudaGetLastError();
}
