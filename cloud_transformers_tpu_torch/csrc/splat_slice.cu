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
// * splat_max_bwd, two launches on one plan (splat_bwd_plan), both
//   point-major as the slice: a point on a group of 1-8 lanes holding
//   quads of 4 features, the mapping loaded once per point, the grid,
//   winner and cotangent rows read as float4/int4 where F % 4 == 0 (a
//   scalar path in the same kernels takes any other F), 32-bit indices.
//   Pass 1 recomputes each contribution c = w * v as one float32 multiply
//   and, where c == grid and grid > 0, takes atomicMin of the int32 point
//   index k on a winner map [R, G, F] that the wrapper filled with
//   INT_MAX.  The minimum does not depend on the order, so the routing is
//   the lowest-indexed winner in every run, and INT_MAX is no point index,
//   so a cell that nobody won routes nothing.  Pass 2 has read-only
//   gathers: where winner == k the contribution's cotangent is g, else 0
//   (a cotangent row is read only where one of its quad's features names
//   the point); d_values sums w * dcon over the vertices, d_w sums
//   v * dcon over the lane's features and then over the group by
//   shuffles, in a fixed order.
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
// In the slice backward, the features of a point sit on a group of 1 to 32
// neighbouring lanes of one warp (the next power of two >= min(F, 32)); a
// lane loops over f with that stride, and the sums over f are shuffles
// inside the group.  In every backward the 2D mappings' slots 2 and 3 are
// never read and get d_w = 0.
//
// Bound on the H100: bytes, as for the forward kernels: the mapping, the
// point features and cotangents, and the grid rows the points touch (the
// winner map is scratch and is not counted).  What keeps them from it is
// the atomics, resolved in L2: the slice backward's 2^dim * F atomicAdd
// per point, and the splat backward's atomicMin, one for each (cell,
// feature) a point wins (about every cell a sparse grid's points touch),
// beside the fill of the whole winner map; its routing pass, read-only,
// reads 16-byte rows of the winner map from L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kSliceThreads = 256;   // slice block (slice_plan's threads)
constexpr int kBwdThreads = 256;     // splat backward block (splat_bwd_plan)

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

// Point p's 2 * kNV vertex rows (row-absolute cell indices: the lo row's
// vertices, then the hi row's), their weights and the point's index k in
// its row, loaded once: x0 and lane0 as words, w_lo and w_hi as one float4
// each through the read-only path.
template <int kNV>
__device__ __forceinline__ void vertex_rows(
    const int* __restrict__ x0, const int* __restrict__ lane0,
    const float4* __restrict__ w_lo, const float4* __restrict__ w_hi, int p,
    int K, int G, int lane_extent, int off2, int off3, int* cell, float* w,
    int& k) {
  const int row = p / K;
  k = p - row * K;
  const int base = row * G + __ldg(x0 + p) * lane_extent + __ldg(lane0 + p);
  const float4 a = __ldg(w_lo + p), c = __ldg(w_hi + p);
  const int offs[4] = {0, 1, off2, off3};
  const float wl[4] = {a.x, a.y, a.z, a.w}, wh[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    cell[j] = base + offs[j];
    w[j] = wl[j];
    cell[kNV + j] = base + lane_extent + offs[j];
    w[kNV + j] = wh[j];
  }
}

// The splat backward's two passes.  Indices are 32-bit (the entry points
// refuse R*K*F or R*G*F >= 2^31).
//
// Winner pass, feature-major, where the grid is sparse (fewer than 16
// contributions a cell on average, splat_bwd_plan's choice): a point on
// kGroup lanes (the next power of two >= min(F, 32)) that hold one
// feature each, so that the group's
// grid reads and atomics on a vertex row are one run of consecutive words
// (an atomic instruction of a warp then touches 32 / kGroup rows, not 32
// scattered words, and L2 resolves its atomics a sector at a time).  Every
// vertex row of the point is in flight before the first compare; where a
// contribution c = w * v (one rounded multiply, as the forward's) is > 0
// and equals the grid, atomicMin of the point index k on the winner map,
// which the wrapper filled with INT_MAX.
template <int kGroup, int kNV>
__global__ void __launch_bounds__(kBwdThreads, 3)
splat_winner_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
                    const float4* __restrict__ w_lo,
                    const float4* __restrict__ w_hi,
                    const float* __restrict__ values,
                    const float* __restrict__ grid, int* __restrict__ winner,
                    int n, int K, int F, int G, int lane_extent, int off2,
                    int off3) {
  const int p = blockIdx.x * (kBwdThreads / kGroup) + threadIdx.x / kGroup;
  if (p >= n) return;   // no shuffles: a lane past the last point may leave
  int cell[2 * kNV], k;
  float w[2 * kNV];
  vertex_rows<kNV>(x0, lane0, w_lo, w_hi, p, K, G, lane_extent, off2, off3,
                   cell, w, k);
  for (int f = threadIdx.x % kGroup; f < F; f += kGroup) {
    const float v = __ldg(values + p * F + f);
    float g[2 * kNV];
#pragma unroll
    for (int j = 0; j < 2 * kNV; ++j) g[j] = __ldg(grid + cell[j] * F + f);
#pragma unroll
    for (int j = 0; j < 2 * kNV; ++j) {
      const float c = __fmul_rn(w[j], v);
      if (c > 0.0f && c == g[j]) atomicMin(winner + cell[j] * F + f, k);
    }
  }
}

// Winner pass, quad-major: a point on kGroup lanes of feature quads as in
// the routing pass, each vertex row of the grid read as one float4 where
// kVec.  Where the grid is dense (many contributions a cell, few of them
// winners) its fewer, wider loads beat the feature-major pass's.
template <int kGroup, int kNV, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 3)
splat_winner_quads_kernel(const int* __restrict__ x0,
                          const int* __restrict__ lane0,
                          const float4* __restrict__ w_lo,
                          const float4* __restrict__ w_hi,
                          const float* __restrict__ values,
                          const float* __restrict__ grid,
                          int* __restrict__ winner, int n, int K, int F,
                          int G, int lane_extent, int off2, int off3) {
  const int p = blockIdx.x * (kBwdThreads / kGroup) + threadIdx.x / kGroup;
  if (p >= n) return;   // no shuffles: a lane past the last point may leave
  const int sub = threadIdx.x % kGroup;
  const int quads = (F + 3) >> 2;
  int cell[2 * kNV], k;
  float w[2 * kNV];
  vertex_rows<kNV>(x0, lane0, w_lo, w_hi, p, K, G, lane_extent, off2, off3,
                   cell, w, k);
  for (int q = sub; q < quads; q += kGroup) {
    const int f = q << 2;
    if (kVec) {
      const float4 v4 =
          __ldg(reinterpret_cast<const float4*>(values + p * F + f));
      float4 gr[2 * kNV];
#pragma unroll
      for (int j = 0; j < 2 * kNV; ++j)
        gr[j] = __ldg(reinterpret_cast<const float4*>(grid + cell[j] * F + f));
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 2 * kNV; ++j) {
        const float g[4] = {gr[j].x, gr[j].y, gr[j].z, gr[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = __fmul_rn(w[j], v[e]);
          if (c > 0.0f && c == g[e])
            atomicMin(winner + cell[j] * F + f + e, k);
        }
      }
    } else {
      for (int e = 0; e < min(4, F - f); ++e) {
        const float v = __ldg(values + p * F + f + e);
#pragma unroll
        for (int j = 0; j < 2 * kNV; ++j) {
          const int at = cell[j] * F + f + e;
          const float c = __fmul_rn(w[j], v);
          if (c > 0.0f && c == __ldg(grid + at)) atomicMin(winner + at, k);
        }
      }
    }
  }
}

// Routing pass, point-major as slice_kernel: a point on kGroup lanes, each
// lane a quad of 4 features (quads q = sub, sub + kGroup, ...), one point a
// lane group, the mapping loaded once per point and lane.  kVec: F % 4 ==
// 0 and the rows 16-byte aligned, so that each vertex row of the winner
// map and of the cotangent is one 16-byte load and a quad of the point's
// values one more; a scalar path in the same kernel takes any other F.
// Read-only: where winner == k the contribution's cotangent is g, else 0; d_values sums w * dcon over the vertices (lo rows, then hi
// rows), d_w sums v * dcon over the lane's features and then over the
// group's lanes by shuffles, in the same order in every run.  The point's
// winner rows are loaded first, and a cotangent row only where one of its
// four features names the point.
template <int kGroup, int kNV, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 3)
splat_route_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
                   const float4* __restrict__ w_lo,
                   const float4* __restrict__ w_hi,
                   const float* __restrict__ values,
                   const int* __restrict__ winner,
                   const float* __restrict__ g, float4* __restrict__ d_w_lo,
                   float4* __restrict__ d_w_hi, float* __restrict__ d_values,
                   int n, int K, int F, int G, int lane_extent, int off2,
                   int off3) {
  const int p_raw = blockIdx.x * (kBwdThreads / kGroup) + threadIdx.x / kGroup;
  // lanes past the last point keep shuffling with their group, on point
  // n - 1, and write nothing
  const bool live = p_raw < n;
  const int p = live ? p_raw : n - 1;
  const int sub = threadIdx.x % kGroup;
  const int quads = (F + 3) >> 2;
  int cell[2 * kNV], k;
  float w[2 * kNV], dw[2 * kNV];
  vertex_rows<kNV>(x0, lane0, w_lo, w_hi, p, K, G, lane_extent, off2, off3,
                   cell, w, k);
#pragma unroll
  for (int j = 0; j < 2 * kNV; ++j) dw[j] = 0.0f;
  for (int q = sub; q < quads; q += kGroup) {
    const int f = q << 2;
    if (kVec) {
      const float4 v4 =
          __ldg(reinterpret_cast<const float4*>(values + p * F + f));
      int4 win[2 * kNV];
#pragma unroll
      for (int j = 0; j < 2 * kNV; ++j)
        win[j] = __ldg(reinterpret_cast<const int4*>(winner + cell[j] * F + f));
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      float dv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2 * kNV; ++j) {
        const bool m[4] = {win[j].x == k, win[j].y == k, win[j].z == k,
                           win[j].w == k};
        float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (m[0] || m[1] || m[2] || m[3])
          gv = __ldg(reinterpret_cast<const float4*>(g + cell[j] * F + f));
        const float c[4] = {m[0] ? gv.x : 0.0f, m[1] ? gv.y : 0.0f,
                            m[2] ? gv.z : 0.0f, m[3] ? gv.w : 0.0f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[e] = __fmaf_rn(w[j], c[e], dv[e]);
          dw[j] = __fmaf_rn(v[e], c[e], dw[j]);
        }
      }
      if (live)
        *reinterpret_cast<float4*>(d_values + p * F + f) =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
    } else {
      for (int e = 0; e < min(4, F - f); ++e) {
        const float v = __ldg(values + p * F + f + e);
        float dv = 0.0f;
#pragma unroll
        for (int j = 0; j < 2 * kNV; ++j) {
          const int at = cell[j] * F + f + e;
          const float c = __ldg(winner + at) == k ? __ldg(g + at) : 0.0f;
          dv = __fmaf_rn(w[j], c, dv);
          dw[j] = __fmaf_rn(v, c, dw[j]);
        }
        if (live) d_values[p * F + f + e] = dv;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * kNV; ++j) dw[j] = group_sum(dw[j], kGroup);
  if (live && sub == 0) {
    // the vertex slots in the mapping's order; 2D slots 2 and 3 get 0
    if constexpr (kNV == 4) {
      d_w_lo[p] = make_float4(dw[0], dw[1], dw[2], dw[3]);
      d_w_hi[p] = make_float4(dw[4], dw[5], dw[6], dw[7]);
    } else {
      d_w_lo[p] = make_float4(dw[0], dw[1], 0.0f, 0.0f);
      d_w_hi[p] = make_float4(dw[2], dw[3], 0.0f, 0.0f);
    }
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

namespace {

// The splat backward's plan (splat_bwd_plan) recomputed from its integers
// p: R, K, F, G, lane_extent, off2, off3, n_vert, then the routing pass's
// group, points a thread (1), threads, blocks and float4 flag, as ct_slice
// takes them, then the winner pass's group, blocks and its layout (1:
// feature-major, 0: quad-major as the routing pass).  False where one
// disagrees, where an index would reach 2^31, or where float4 access is
// asked of rows (or always of the weights) that are not 16-byte aligned.
bool bwd_plan_ok(const int* p, bool rows_aligned, bool weights_aligned) {
  const int R = p[0], K = p[1], F = p[2], G = p[3], n_vert = p[7],
            group = p[8], points = p[9], threads = p[10], blocks = p[11],
            vec = p[12], w_group = p[13], w_blocks = p[14],
            w_features = p[15];
  const int64_t n = (int64_t)R * K;
  const int64_t limit = (int64_t)1 << 31;
  if (n * F >= limit || (int64_t)R * G * F >= limit) return false;
  const int64_t per_block = kBwdThreads / group;
  // feature-major below 16 contributions a cell on average
  const bool sparse = (int64_t)K * 2 * n_vert < (int64_t)16 * G;
  const int w_expect = sparse ? feature_group(F) : group;
  const int64_t w_per_block = kBwdThreads / w_expect;
  return group == slice_group(F) && threads == kBwdThreads && points == 1 &&
         blocks == (n + per_block - 1) / per_block &&
         w_features == (int)sparse && w_group == w_expect &&
         w_blocks == (n + w_per_block - 1) / w_per_block &&
         vec == (F % 4 == 0 && rows_aligned) &&
         (n_vert == 2 || n_vert == 4) && weights_aligned;
}

struct BwdArgs {
  const int* x0;
  const int* lane0;
  const float4* w_lo;
  const float4* w_hi;
  const float* values;
  const float* grid;     // the winner pass
  int* winner;           // written by the winner pass, read by the routing
  const float* g;        // the routing pass
  float4* d_w_lo;
  float4* d_w_hi;
  float* d_values;
  int n, K, F, G, lane_extent, off2, off3;
};

// The winner pass on the plan's layout, group and blocks.
int launch_winner(const int* p, const BwdArgs& a, cudaStream_t stream) {
  if (!p[15]) {   // quad-major
    const int group = p[8], n_vert = p[7], vec = p[12];
    const dim3 grid((unsigned)p[14]);
#define CT_WQ(GR, NV, VEC)                                                 \
  splat_winner_quads_kernel<GR, NV, VEC><<<grid, kBwdThreads, 0, stream>>>( \
      a.x0, a.lane0, a.w_lo, a.w_hi, a.values, a.grid, a.winner, a.n, a.K, \
      a.F, a.G, a.lane_extent, a.off2, a.off3)
#define CT_WQ_V(GR, NV) \
  if (vec) CT_WQ(GR, NV, true); else CT_WQ(GR, NV, false)
#define CT_WQ_N(GR)                            \
  if (n_vert == 2) { CT_WQ_V(GR, 2); }         \
  else { CT_WQ_V(GR, 4); }                     \
  break
    switch (group) {
      case 1: CT_WQ_N(1);
      case 2: CT_WQ_N(2);
      case 4: CT_WQ_N(4);
      case 8: CT_WQ_N(8);
      default: return (int)cudaErrorInvalidValue;
    }
#undef CT_WQ_N
#undef CT_WQ_V
#undef CT_WQ
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)p[14]);
#define CT_WIN(GR, NV)                                                      \
  splat_winner_kernel<GR, NV><<<grid, kBwdThreads, 0, stream>>>(            \
      a.x0, a.lane0, a.w_lo, a.w_hi, a.values, a.grid, a.winner, a.n, a.K, \
      a.F, a.G, a.lane_extent, a.off2, a.off3)
#define CT_WIN_N(GR)            \
  if (p[7] == 2) CT_WIN(GR, 2); \
  else CT_WIN(GR, 4);           \
  break
  switch (p[13]) {
    case 1: CT_WIN_N(1);
    case 2: CT_WIN_N(2);
    case 4: CT_WIN_N(4);
    case 8: CT_WIN_N(8);
    case 16: CT_WIN_N(16);
    case 32: CT_WIN_N(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CT_WIN_N
#undef CT_WIN
  return (int)cudaGetLastError();
}

// The routing pass on the plan's quad group and blocks.
template <template <int, int, bool> class Pass>
int launch_bwd(const int* p, const BwdArgs& a, cudaStream_t stream) {
  const int group = p[8], n_vert = p[7], vec = p[12];
  const dim3 grid((unsigned)p[11]);
#define CT_BWD(GR, NV, VEC) Pass<GR, NV, VEC>::launch(grid, stream, a)
#define CT_BWD_V(GR, NV) (vec ? CT_BWD(GR, NV, true) : CT_BWD(GR, NV, false))
#define CT_BWD_N(GR) (n_vert == 2 ? CT_BWD_V(GR, 2) : CT_BWD_V(GR, 4))
  switch (group) {
    case 1: CT_BWD_N(1); break;
    case 2: CT_BWD_N(2); break;
    case 4: CT_BWD_N(4); break;
    case 8: CT_BWD_N(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CT_BWD_N
#undef CT_BWD_V
#undef CT_BWD
  return (int)cudaGetLastError();
}

template <int kGroup, int kNV, bool kVec>
struct RoutePass {
  static void launch(dim3 grid, cudaStream_t s, const BwdArgs& a) {
    splat_route_kernel<kGroup, kNV, kVec><<<grid, kBwdThreads, 0, s>>>(
        a.x0, a.lane0, a.w_lo, a.w_hi, a.values, a.winner, a.g, a.d_w_lo,
        a.d_w_hi, a.d_values, a.n, a.K, a.F, a.G, a.lane_extent, a.off2,
        a.off3);
  }
};

BwdArgs bwd_args(const int* p, const int* x0, const int* lane0,
                 const float* w_lo, const float* w_hi, const float* values,
                 const float* grid, int* winner, const float* g,
                 float* d_w_lo, float* d_w_hi, float* d_values) {
  return BwdArgs{x0, lane0, reinterpret_cast<const float4*>(w_lo),
                 reinterpret_cast<const float4*>(w_hi), values, grid, winner,
                 g, reinterpret_cast<float4*>(d_w_lo),
                 reinterpret_cast<float4*>(d_w_hi), d_values, p[0] * p[1],
                 p[1], p[2], p[3], p[4], p[5], p[6]};
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= (uintptr_t)q;
  return bits % 16 == 0;
}

}  // namespace

// Two launches on one plan: the winner map (int32 [R, G, F], filled with
// INT_MAX by the caller), then the routing.  ``p`` as bwd_plan_ok reads it;
// a launch whose numbers disagree with the plan launches nothing.
extern "C" int ct_splat_max_bwd(const int* x0, const int* lane0,
                                const float* w_lo, const float* w_hi,
                                const float* values, const float* grid,
                                const float* g, int* winner, float* d_w_lo,
                                float* d_w_hi, float* d_values, const int* p,
                                void* stream) {
  if ((int64_t)p[0] * p[1] * p[2] <= 0) return 0;
  if (!bwd_plan_ok(p, aligned16({values, grid, g, winner, d_values}),
                   aligned16({w_lo, w_hi, d_w_lo, d_w_hi})))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = bwd_args(p, x0, lane0, w_lo, w_hi, values, grid, winner,
                             g, d_w_lo, d_w_hi, d_values);
  const int err = launch_winner(p, a, (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_bwd<RoutePass>(p, a, (cudaStream_t)stream);
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

// The routing pass alone, from a winner map made by ct_splat_max_winner,
// on the splat backward's plan.
extern "C" int ct_splat_route(const int* x0, const int* lane0,
                              const float* w_lo, const float* w_hi,
                              const float* values, const int* winner,
                              const float* g, float* d_w_lo, float* d_w_hi,
                              float* d_values, const int* p, void* stream) {
  if ((int64_t)p[0] * p[1] * p[2] <= 0) return 0;
  if (!bwd_plan_ok(p, aligned16({values, g, winner, d_values}),
                   aligned16({w_lo, w_hi, d_w_lo, d_w_hi})))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = bwd_args(p, x0, lane0, w_lo, w_hi, values, nullptr,
                             const_cast<int*>(winner), g, d_w_lo, d_w_hi,
                             d_values);
  return launch_bwd<RoutePass>(p, a, (cudaStream_t)stream);
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
