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
// * slice: point-major.  A point is served by a group of 1, 2, 4 or 8 lanes
//   (the next power of two >= ceil(F / 4), at most 8), each lane holding a
//   quad of 4 features, and a thread serves 4 points in 2D and 2 in 3D
//   (fewer when the launch would not fill the card), so that a thread has
//   up to 16 row gathers in flight before its first sum.  The mapping is
//   loaded once per point and lane: x0 and lane0 as words, w_lo and w_hi
//   as one float4 each through the read-only path; the lanes of a group
//   read the same addresses, which one request serves (a shuffle would
//   cost more instructions than the broadcast load).
//   Where F % 4 == 0 (every head group of the classifier and of the
//   completion model) grid rows are read and outputs written as float4; a
//   scalar path in the same kernel takes any other F.  Index arithmetic is
//   32-bit: the wrapper and the entry point refuse R*K*F or R*G*F >= 2^31.
//   The launch numbers (group, points a thread, blocks) come from the
//   caller's cached slice_plan, and the entry point refuses a launch whose
//   numbers it does not recompute.  The sum runs over the lo vertices, then
//   the hi ones, each term one fused multiply-add from 0, in every run.
//
// Bound on the H100: bytes.  Each point reads 40 bytes of mapping and 4F of
// features, and the grid is written (splat) or read (slice) once; the
// arithmetic is a few operations per byte.  The splat's atomics are what
// keeps it from that bound: 2^dim * F of them per point, resolved in L2.
// The slice's grid rows are scattered: at F = 4 a row is 16 bytes of a
// 32-byte sector, so up to half of what it moves is not used.
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
// * splat_max_winner (replaces pallas_splat(..., with_winner=True), which
//   keeps a float point index beside the grid in VMEM and updates it with
//   the max): the grid and the winner map in one scatter.  Each positive
//   contribution c of point k goes in with a 64-bit atomicMax of
//   (float_bits(c) << 32) | (INT_MAX - k) on a zero-filled [R, G, F] buffer:
//   positive floats order like their bits, so the high word ends as the
//   maximum (bit-equal to splat_max), and among equal maxima the largest low
//   word, the lowest k, wins, whatever order the atomics land in.  A second
//   pass unpacks the buffer into the grid and the int32 winner map, INT_MAX
//   where nothing landed.  splat_route (replacing pallas_splat_bwd_routed) is
//   then the backward's routing pass alone, launched on its own.
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
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSliceThreads = 256;   // slice block (slice_plan's threads)

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

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x = __fmaf_rn(w, v.x, acc.x);
  acc.y = __fmaf_rn(w, v.y, acc.y);
  acc.z = __fmaf_rn(w, v.z, acc.z);
  acc.w = __fmaf_rn(w, v.w, acc.w);
}

// slice: a group of kGroup lanes per point, each lane a quad of 4
// features (more quads by a stride of kGroup where F > 4 * kGroup), and kP
// points a thread.  Lane `sub` of group `g` in the block takes the points
// block_start + i * (threads / kGroup) + g, i < kP, so that neighbouring
// groups hold neighbouring points (coalesced mapping loads and stores).
// The mapping is loaded once per point and lane: x0 and lane0 as two words,
// w_lo and w_hi as one float4 each through the read-only path; the lanes of
// one group read the same addresses, which one request serves.  kVec: F % 4
// == 0 and every array 16-byte aligned, grid rows read and outputs written
// as float4.  All the mapping and grid loads of the kP points are in
// flight before the first sum.  The sum runs over the lo vertices, then the hi
// ones, each term one rounded fused multiply-add, from 0.
template <int kGroup, int kP, int kNV, bool kVec>
__global__ void __launch_bounds__(kSliceThreads)
slice_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
             const float4* __restrict__ w_lo, const float4* __restrict__ w_hi,
             const float* __restrict__ grid, float* __restrict__ out, int n,
             int K, int F, int G, int lane_extent, int off2, int off3) {
  constexpr int kGroups = kSliceThreads / kGroup;
  const int g = threadIdx.x / kGroup;
  const int sub = threadIdx.x % kGroup;
  const int p0 = blockIdx.x * (kGroups * kP) + g;
  const int quads = (F + 3) >> 2;
  int row[kP], base[kP];
  float wl[kP][4], wh[kP][4];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = min(p0 + i * kGroups, n - 1);   // clamped: no load past n
    const float4 a = __ldg(w_lo + p), c = __ldg(w_hi + p);
    wl[i][0] = a.x; wl[i][1] = a.y; wl[i][2] = a.z; wl[i][3] = a.w;
    wh[i][0] = c.x; wh[i][1] = c.y; wh[i][2] = c.z; wh[i][3] = c.w;
    base[i] = __ldg(x0 + p) * lane_extent + __ldg(lane0 + p);
    row[i] = p / K;
  }
  const int offs[4] = {0, 1, off2, off3};
  for (int q = sub; q < quads; q += kGroup) {
    const int f = q << 2;
    if (kVec) {
      float4 v[kP][2 * kNV];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float* gr = grid + (row[i] * G + base[i]) * F + f;
#pragma unroll
        for (int j = 0; j < kNV; ++j) {
          v[i][j] = __ldg(reinterpret_cast<const float4*>(gr + offs[j] * F));
          v[i][kNV + j] = __ldg(reinterpret_cast<const float4*>(
              gr + (lane_extent + offs[j]) * F));
        }
      }
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const int p = p0 + i * kGroups;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kNV; ++j) fma4(acc, wl[i][j], v[i][j]);
#pragma unroll
        for (int j = 0; j < kNV; ++j) fma4(acc, wh[i][j], v[i][kNV + j]);
        if (p < n) *reinterpret_cast<float4*>(out + p * F + f) = acc;
      }
    } else {
      const int nf = min(4, F - f);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const int p = p0 + i * kGroups;
        const float* gr = grid + (row[i] * G + base[i]) * F + f;
        for (int e = 0; e < nf; ++e) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kNV; ++j)
            acc = __fmaf_rn(wl[i][j], __ldg(gr + offs[j] * F + e), acc);
#pragma unroll
          for (int j = 0; j < kNV; ++j)
            acc = __fmaf_rn(wh[i][j],
                            __ldg(gr + (lane_extent + offs[j]) * F + e), acc);
          if (p < n) out[p * F + f + e] = acc;
        }
      }
    }
  }
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

__global__ void splat_max_winner_kernel(
    const int* __restrict__ x0, const int* __restrict__ lane0,
    const float* __restrict__ w_lo, const float* __restrict__ w_hi,
    const float* __restrict__ values, unsigned long long* __restrict__ packed,
    int64_t n_points_total, int K, int F, int G, int lane_extent, int off2,
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
  unsigned long long* row = packed + r * (int64_t)G * F + f;
  // the lower the point index, the larger the low word
  const unsigned long long tag = (unsigned long long)(INT_MAX - k);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_vert) break;
    // one rounded multiply, as splat_max's
    const float c_lo = __fmul_rn(w_lo[p * 4 + j], v);
    if (c_lo > 0.0f)
      atomicMax(row + (int64_t)(base + offs[j]) * F,
                ((unsigned long long)__float_as_uint(c_lo) << 32) | tag);
    const float c_hi = __fmul_rn(w_hi[p * 4 + j], v);
    if (c_hi > 0.0f)
      atomicMax(row + (int64_t)(base + lane_extent + offs[j]) * F,
                ((unsigned long long)__float_as_uint(c_hi) << 32) | tag);
  }
}

__global__ void splat_unpack_kernel(
    const unsigned long long* __restrict__ packed, float* __restrict__ grid,
    int* __restrict__ winner, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long v = packed[i];
  grid[i] = __uint_as_float((unsigned int)(v >> 32));  // 0 -> +0.0f
  winner[i] = v == 0ull ? INT_MAX : INT_MAX - (int)(v & 0xffffffffull);
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

// Lanes of a slice group: the next power of two >= the feature quads, at
// most 8.
int slice_group(int F) {
  const int quads = (F + 3) / 4;
  int group = 1;
  while (group < quads && group < 8) group <<= 1;
  return group;
}

template <int kGroup, int kP>
int launch_slice(const int* x0, const int* lane0, const float* w_lo,
                 const float* w_hi, const float* grid, float* out, int n,
                 int K, int F, int G, int lane_extent, int off2, int off3,
                 int n_vert, int vec, unsigned int blocks,
                 cudaStream_t stream) {
  const float4* wl = reinterpret_cast<const float4*>(w_lo);
  const float4* wh = reinterpret_cast<const float4*>(w_hi);
#define CT_SLICE(NV, VEC)                                                  \
  slice_kernel<kGroup, kP, NV, VEC><<<blocks, kSliceThreads, 0, stream>>>( \
      x0, lane0, wl, wh, grid, out, n, K, F, G, lane_extent, off2, off3)
  if (n_vert == 2) {
    if (vec) CT_SLICE(2, true); else CT_SLICE(2, false);
  } else {
    if (vec) CT_SLICE(4, true); else CT_SLICE(4, false);
  }
#undef CT_SLICE
  return (int)cudaGetLastError();
}

template <int kGroup>
int launch_slice_g(int P, const int* x0, const int* lane0, const float* w_lo,
                   const float* w_hi, const float* grid, float* out, int n,
                   int K, int F, int G, int lane_extent, int off2, int off3,
                   int n_vert, int vec, unsigned int blocks,
                   cudaStream_t stream) {
  switch (P) {
    case 1: return launch_slice<kGroup, 1>(x0, lane0, w_lo, w_hi, grid, out, n, K, F, G, lane_extent, off2, off3, n_vert, vec, blocks, stream);
    case 2: return launch_slice<kGroup, 2>(x0, lane0, w_lo, w_hi, grid, out, n, K, F, G, lane_extent, off2, off3, n_vert, vec, blocks, stream);
    case 4: return launch_slice<kGroup, 4>(x0, lane0, w_lo, w_hi, grid, out, n, K, F, G, lane_extent, off2, off3, n_vert, vec, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
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

// The slice on the caller's plan (slice_plan): `group` lanes a point,
// `points` (1, 2 or 4) points a thread, `threads` a block, `blocks` blocks,
// `vec` for float4 rows.  The entry point recomputes each of them and
// launches nothing when one disagrees, when an index would reach 2^31, or
// when `vec` is asked of arrays that are not 16-byte aligned.
// The slice's integers come as one host array p (the wrapper caches one per
// shape and hands over its address: ctypes converts every argument on every
// call, and thirteen ints cost more host time than the kernel at small
// shapes): R, K, F, G, lane_extent, off2, off3, n_vert, then the plan's
// group, points a thread, threads, blocks and float4 flag.
extern "C" int ct_slice(const int* x0, const int* lane0, const float* w_lo,
                        const float* w_hi, const float* grid, float* out,
                        const int* p, void* stream) {
  const int R = p[0], K = p[1], F = p[2], G = p[3], lane_extent = p[4],
            off2 = p[5], off3 = p[6], n_vert = p[7], group = p[8],
            points = p[9], threads = p[10], blocks = p[11], vec = p[12];
  const int64_t n = (int64_t)R * K;
  if (n * F <= 0) return 0;
  const int64_t limit = (int64_t)1 << 31;
  if (n * F >= limit || (int64_t)R * G * F >= limit)
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)points * (kSliceThreads / group);
  // the weights are read as float4 on either path, the rows with vec
  const bool rows_aligned = ((uintptr_t)grid | (uintptr_t)out) % 16 == 0;
  if (group != slice_group(F) || threads != kSliceThreads ||
      (points != 1 && points != 2 && points != 4) ||
      blocks != (n + per_block - 1) / per_block ||
      vec != (F % 4 == 0 && rows_aligned) || (n_vert != 2 && n_vert != 4) ||
      ((uintptr_t)w_lo | (uintptr_t)w_hi) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int nb = (unsigned int)blocks;
  switch (group) {
#define CT_SLICE_G(GR)                                                        \
  case GR:                                                                    \
    return launch_slice_g<GR>(points, x0, lane0, w_lo, w_hi, grid, out,       \
                              (int)n, K, F, G, lane_extent, off2, off3,       \
                              n_vert, vec, nb, s)
    CT_SLICE_G(1);
    CT_SLICE_G(2);
    CT_SLICE_G(4);
    CT_SLICE_G(8);
#undef CT_SLICE_G
  }
  return (int)cudaErrorInvalidValue;
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

// The grid and the winner map in two launches: the packed scatter into
// ``packed`` (int64 [R, G, F], zero-filled by the caller), then the unpack.
extern "C" int ct_splat_max_winner(const int* x0, const int* lane0,
                                   const float* w_lo, const float* w_hi,
                                   const float* values,
                                   unsigned long long* packed, float* grid,
                                   int* winner, int R, int K, int F, int G,
                                   int lane_extent, int off2, int off3,
                                   int n_vert, void* stream) {
  const int64_t n = (int64_t)R * K;
  const int64_t cells = (int64_t)R * G * F;
  if (n * F > 0)
    splat_max_winner_kernel<<<n_blocks(n * F), kThreads, 0,
                              (cudaStream_t)stream>>>(
        x0, lane0, w_lo, w_hi, values, packed, n, K, F, G, lane_extent, off2,
        off3, n_vert);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (cells > 0)
    splat_unpack_kernel<<<n_blocks(cells), kThreads, 0,
                          (cudaStream_t)stream>>>(packed, grid, winner, cells);
  return (int)cudaGetLastError();
}

// The routing pass alone, from a winner map made by ct_splat_max_winner.
extern "C" int ct_splat_route(const int* x0, const int* lane0,
                              const float* w_lo, const float* w_hi,
                              const float* values, const int* winner,
                              const float* g, float* d_w_lo, float* d_w_hi,
                              float* d_values, int R, int K, int F, int G,
                              int lane_extent, int off2, int off3, int n_vert,
                              void* stream) {
  const int64_t n = (int64_t)R * K;
  if (n * F > 0) {
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
