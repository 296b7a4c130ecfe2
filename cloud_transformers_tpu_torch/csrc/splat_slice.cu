// Splat (scatter-max) and Slice (weighted gather) on flat per-(batch, head)
// grids [R, G, F]: cell g = x * lane_extent + lane, with lane = y (2D) or
// y * Z + z (3D), and F contiguous.
//
// Replaces cloud_transformers_tpu/ops/pallas_splat.py: pallas_splat
// (op='max', with and without with_winner) and pallas_slice.  The TPU
// kernels keep one whole grid in VMEM per program and loop over the points
// in order.  On the H100 most of the classifier's per-(b, h) grids (128^2 x
// 4, 64^2 x 16, 16^3 x 16, 32^3 x 4 f32: 256-512 KiB) exceed the 227 KB of
// shared memory a block can have:
//
// * splat_max keeps the TPU kernel's idea, the grid on chip, a slab at a
//   time: one launch on the caller's cached plan (splat_plan), one block
//   for each (row, slab, chunk).  A slab is an even share, at most 40 KiB,
//   of the row's G * F words; a chunk is a share of the row's points, as
//   many chunks as it takes to give the card 396 blocks.  A block zeroes
//   its slab in shared memory, scans its chunk's points 2048 at a time
//   (x0 and lane0 only), lists those whose vertex cells reach into the
//   slab, and deposits the listed points' contributions c = w * v (one
//   rounded multiply) by shared-memory atomicMax on their int32 bit
//   patterns: a point on a group of 1-8 lanes of feature quads, as the
//   slice, its values read as float4 where F % 4 == 0, two points a group
//   with their loads in flight before the first deposit.  Non-negative
//   IEEE floats order like their bit patterns and a contribution <= 0
//   (-0.0 included) never beats the zero fill, so the maximum is exact and
//   the same in every run, whatever order the list and the atomics take.
//   A row of one chunk writes each slab out whole (float4 stores: the
//   grid needs no fill and no word is read back); a row of several
//   chunks raises a zero-filled grid by global atomicMax of each slab's
//   positive words.  Measured on the H100 at the models' shapes: a read
//   of the word before each atomic (in shared memory, or a relaxed global
//   read in the multi-chunk write-out) cost more than the atomics it
//   saved, lanes of one feature each lost to quads, and more or fewer
//   chunks lost to 396 blocks (PERF.md); the kernel has no such
//   pre-check.
// * splat_max_winner (pallas_splat(..., with_winner=True)): the grid and
//   the winner map from one entry point, through splat_max's kernel, which
//   also fills the map with INT_MAX.  Where each block is its row's only
//   chunk and lists its points at one go (the four large grids of the
//   classifier), the slab in shared memory holds the final maximum once
//   the deposits are in, and the same block records the winners: it
//   visits its listed contributions again and takes atomicMin of the
//   point index where c > 0 equals the slab word.  Elsewhere the splat
//   backward's winner pass (below) follows on the finished grid.  The map
//   is the lowest point index whose contribution equals the cell's
//   positive max, in every run.  No 64-bit packed buffer and no unpack
//   pass.  The kernels carry a tag type (use::splat_max_winner) so that a
//   profile tells these launches from splat_max's and splat_max_bwd's.
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
// arithmetic is a few operations per byte.  What keeps the splat from that
// bound is latency: each block's scans and deposits wait on loads in
// turn, and its shared-memory atomics (2^dim * F a point) serialise where
// lanes meet on one bank; a row's x0 and lane0 are read once a slab.
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
// * slice_bwd, two launches on one plan (slice_bwd_plan).  d_w
//   point-major, as the slice (slice_bwd_dw_kernel): the dot of the
//   vertex's grid row with g over the features, summed in a fixed order;
//   its blocks also bound |w| * |g|.  Then d_grid slab-major, as the
//   splat: a block for each (row, slab of words), which lists the points
//   that reach its slab and adds their contributions into it in 64-bit
//   fixed point, scaled by that bound, by shared-memory integer atomics
//   (slice_bwd_kernel, below): integer sums do not depend on their order,
//   so every word is the same in every run; each is written once, as
//   float4, with no fill and no float atomics.
//
// * splat_route (replacing pallas_splat_bwd_routed) is the routing pass
//   alone, on the winner map that splat_max_winner made.
//
// In every backward the 2D mappings' slots 2 and 3 are never read and get
// d_w = 0.
//
// Bound on the H100: bytes, as for the forward kernels: the mapping, the
// point features and cotangents, and the grid rows the points touch (the
// winner map is scratch and is not counted), and for the slice backward
// the whole d_grid, written once.  What keeps the splat backward from it
// is its atomicMin, one for each (cell, feature) a point wins (about every
// cell a sparse grid's points touch), beside the fill of the whole winner
// map; its routing pass, read-only, reads 16-byte rows of the winner map
// from L2.  The slice backward's d_grid blocks each read their row's x0
// and lane0 (a row is read once a slab, from L2) and the cotangent rows
// of the points that reach their slab, then add 2^dim * F terms a point,
// each a float-to-integer conversion and two shared-memory atomics, which
// serialise where many points share a word (the dense grids); its d_w
// pass gathers 2^dim grid rows a point, as the slice.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kSliceThreads = 256;   // slice block (slice_plan's threads)
constexpr int kBwdThreads = 256;     // splat backward block (splat_bwd_plan)
constexpr int kSplatThreads = 256;   // splat block (splat_plan's threads)
constexpr int kSlabWords = 10236;    // grid words a splat block holds (40 KiB)
constexpr int kScanPoints = 2048;    // points a splat block lists at a time
constexpr int kListP = 2;            // listed points a lane group holds
constexpr int kFillBlocks = 132 * 3; // splat blocks that fill the card
constexpr int kMinChunk = 256;       // points for each splat chunk, at most
constexpr int kSbSlabWords = 4992;   // d_grid words a slice backward block
                                     // sums (64-bit each, in dynamic
                                     // shared memory with its list)
constexpr int kSbFillBlocks = 132 * 3;   // its blocks that fill the card

// The entry point a launch serves, as a template tag of the kernels that
// two of them share: splat_max_winner launches splat_max's kernel and
// splat_max_bwd's winner pass, and a profile tells the three apart by it.
namespace use {
struct splat_max;
struct splat_max_bwd;
struct splat_max_winner;
}  // namespace use

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

// One contribution c of point k to the slab word `at`, where that lies in
// the slab's n_words: see visit_listed.
template <bool kTrack>
__device__ __forceinline__ void take(float* slab, int* won, int at,
                                     int n_words, float c, int k) {
  if ((unsigned)at >= (unsigned)n_words || !(c > 0.0f)) return;
  if (kTrack) {
    if (c == slab[at]) atomicMin(won + at, k);
  } else {
    atomicMax(reinterpret_cast<int*>(slab + at), __float_as_int(c));
  }
}

// The listed points' contributions c = w * v (one rounded multiply) whose
// word lies in the slab: a point on kGroup lanes of feature quads (quads
// q = sub, sub + kGroup, ...; values read as float4 where kVec), kListP
// points a lane group with their loads in flight before the first use.
// Without kTrack each c > 0 goes into the slab by shared-memory atomicMax
// on its bits (a c <= 0, -0.0 included, never beats the zero fill); with
// kTrack, where c > 0 equals the finished slab word, the point index k goes
// into the winner map `won` by atomicMin.
template <int kGroup, int kNV, bool kVec, bool kTrack>
__device__ __forceinline__ void visit_listed(
    const int* __restrict__ x0, const int* __restrict__ lane0,
    const float4* __restrict__ w_lo, const float4* __restrict__ w_hi,
    const float* __restrict__ values, const int* listed_k, int n, int row,
    int K, int F, int lane_extent, int off2, int off3, int wb, int n_words,
    float* slab, int* won) {
  constexpr int kGroups = kSplatThreads / kGroup;
  const int offs[4] = {0, 1, off2, off3};
  const int sub = threadIdx.x % kGroup;
  const int quads = (F + 3) >> 2;
  for (int j0 = threadIdx.x / kGroup; j0 < n; j0 += kGroups * kListP) {
    int pt[kListP], at[kListP];
    float4 wl[kListP], wh[kListP];
#pragma unroll
    for (int q = 0; q < kListP; ++q) {
      const int j = min(j0 + q * kGroups, n - 1);   // clamped: a real entry
      pt[q] = row * K + listed_k[j];
      at[q] = (__ldg(x0 + pt[q]) * lane_extent + __ldg(lane0 + pt[q])) * F
              - wb;
      wl[q] = __ldg(w_lo + pt[q]);
      wh[q] = __ldg(w_hi + pt[q]);
    }
    for (int qd = sub; qd < quads; qd += kGroup) {
      const int f = qd << 2;
      const int nf = kVec ? 4 : min(4, F - f);
      float v[kListP][4];
#pragma unroll
      for (int q = 0; q < kListP; ++q) {
        if (kVec) {
          const float4 t =
              __ldg(reinterpret_cast<const float4*>(values + pt[q] * F + f));
          v[q][0] = t.x; v[q][1] = t.y; v[q][2] = t.z; v[q][3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[q][e] = e < nf ? __ldg(values + pt[q] * F + f + e) : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kListP; ++q) {
        if (j0 + q * kGroups >= n) break;
        const int k = pt[q] - row * K;
        const float lo[4] = {wl[q].x, wl[q].y, wl[q].z, wl[q].w};
        const float hi[4] = {wh[q].x, wh[q].y, wh[q].z, wh[q].w};
#pragma unroll
        for (int j = 0; j < kNV; ++j) {
          const int a = at[q] + offs[j] * F + f;
          const int b = at[q] + (lane_extent + offs[j]) * F + f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e >= nf) break;
            take<kTrack>(slab, won, a + e, n_words, __fmul_rn(lo[j], v[q][e]),
                         k);
            take<kTrack>(slab, won, b + e, n_words, __fmul_rn(hi[j], v[q][e]),
                         k);
          }
        }
      }
    }
  }
}

// The block lists in listed_k the points k0 <= k < k_end of the row that
// starts at point `row` whose vertex cells, from the base cell to
// `reach` cells past it, reach into the slab's words [wb, wb + n_words),
// and returns how many (every thread of the block calls it): the x0 and
// lane0 of kScanPoints / kSplatThreads points a thread in flight, then a
// shared-memory atomicAdd on `listed` a listed point, so the list's order
// varies from run to run.  It starts with a barrier, after which the
// block's last list may be overwritten.
__device__ __forceinline__ int list_slab_points(
    const int* __restrict__ x0, const int* __restrict__ lane0, int row,
    int k0, int k_end, int F, int lane_extent, int reach, int wb,
    int n_words, int* listed_k, int& listed) {
  constexpr int kScan = kScanPoints / kSplatThreads;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  int base[kScan];
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const int p = row + min(k0 + i * kSplatThreads + (int)threadIdx.x,
                            k_end - 1);
    base[i] = __ldg(x0 + p) * lane_extent + __ldg(lane0 + p);
  }
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const int k = k0 + i * kSplatThreads + threadIdx.x;
    if (k < k_end && base[i] * F < wb + n_words &&
        (base[i] + reach) * F > wb)
      listed_k[atomicAdd(&listed, 1)] = k;
  }
  __syncthreads();
  return listed;
}

// splat_max: block b takes chunk b % chunks of the points of row
// b / (chunks * slabs), and slab (b / chunks) % slabs of that row's grid:
// the words [s * slab_words, s * slab_words + n_words) of the row's G * F,
// held in shared memory from a zero fill.  It scans its points
// kScanPoints at a time (the x0 and lane0 of 8 points a thread in
// flight), lists those whose vertex cells reach into the slab, then
// deposits the listed points' contributions (visit_listed): a c > 0 by
// shared-memory atomicMax on its bits (a c <= 0, -0.0 included, never
// beats the zero fill).  The list's order varies from run to run,
// the maximum does not.  Then it writes the slab out: as float4 stores
// where it is the row's only chunk (every word of the grid written once,
// no fill), or by atomicMax of its positive words into the zero-filled
// grid where several chunks share the slab.
// Given a winner map (splat_max_winner), the slab's first chunk fills the
// slab's words of the map with INT_MAX.  Where the block is its row's only
// chunk and lists its points at one go (`track`), the slab holds the final
// maximum, and the block then records the winners itself: it visits the
// listed contributions again and, where c > 0 and c equals the slab word,
// takes atomicMin of the point index on the map, which it alone writes.
// Otherwise the winner pass runs after it on the stream.
template <class Use, int kGroup, int kNV, bool kVec>
__global__ void __launch_bounds__(kSplatThreads)
splat_slab_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
                  const float4* __restrict__ w_lo,
                  const float4* __restrict__ w_hi,
                  const float* __restrict__ values, float* grid, int* winner,
                  int K, int F, int G, int lane_extent, int off2, int off3,
                  int slabs, int slab_words, int chunks, int chunk,
                  bool track) {
  __shared__ __align__(16) float slab[kSlabWords];
  __shared__ int listed_k[kScanPoints];
  __shared__ int listed;
  const int c = blockIdx.x % chunks;
  const int s = (blockIdx.x / chunks) % slabs;
  const int r = blockIdx.x / (chunks * slabs);
  const int row_words = G * F;
  const int wb = s * slab_words;
  const int n_words = min(slab_words, row_words - wb);
  for (int i = threadIdx.x; i < n_words; i += kSplatThreads) slab[i] = 0.0f;
  const int k_end = min(K, (c + 1) * chunk);
  // cells from a point's base cell to past its last vertex
  const int reach = lane_extent + off3 + 1;
  int n = 0;
  for (int k0 = c * chunk; k0 < k_end; k0 += kScanPoints) {
    // after the fill and the last list are done with
    n = list_slab_points(x0, lane0, r * K, k0, k_end, F, lane_extent, reach,
                         wb, n_words, listed_k, listed);
    visit_listed<kGroup, kNV, kVec, false>(
        x0, lane0, w_lo, w_hi, values, listed_k, n, r, K, F, lane_extent,
        off2, off3, wb, n_words, slab, nullptr);
    __syncthreads();   // every deposit in before the next list or the output
  }
  float* out = grid + r * row_words + wb;
  if (winner != nullptr && c == 0) {
    int* won = winner + r * row_words + wb;
    if (row_words % 4 == 0) {
      for (int i = threadIdx.x; i < n_words / 4; i += kSplatThreads)
        reinterpret_cast<int4*>(won)[i] =
            make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
    } else {
      for (int i = threadIdx.x; i < n_words; i += kSplatThreads)
        won[i] = INT_MAX;
    }
    if (track) {
      __syncthreads();   // the fill is seen by the block's atomics
      visit_listed<kGroup, kNV, kVec, true>(
          x0, lane0, w_lo, w_hi, values, listed_k, n, r, K, F, lane_extent,
          off2, off3, wb, n_words, slab, won);
    }
  }
  if (chunks == 1) {
    if (row_words % 4 == 0) {   // n_words and the row start too
      for (int i = threadIdx.x; i < n_words / 4; i += kSplatThreads)
        reinterpret_cast<float4*>(out)[i] =
            reinterpret_cast<const float4*>(slab)[i];
    } else {
      for (int i = threadIdx.x; i < n_words; i += kSplatThreads)
        out[i] = slab[i];
    }
  } else {
    for (int i = threadIdx.x; i < n_words; i += kSplatThreads) {
      const float t = slab[i];
      if (t > 0.0f)
        atomicMax(reinterpret_cast<int*>(out + i), __float_as_int(t));
    }
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
template <class Use, int kGroup, int kNV>
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
template <class Use, int kGroup, int kNV, bool kVec>
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

// ---- slice backward ---------------------------------------------------------
//
// Two launches on one plan (slice_bwd_plan), d_w first.
//
// d_w, point-major as slice_kernel (slice_bwd_dw_kernel; slice_plan's
// group, points a thread and blocks): a point on kGroup lanes of feature
// quads, kP points a thread, the point's cotangent quad and its 2 * kNV
// vertex rows of the grid read as float4 where kVec, all of a thread's
// loads in flight before the first sum.  d_w[v] = sum over f of grid row
// v times g: a lane sums its quads' features by fused multiply-adds from
// 0, then the group's lanes are summed by xor shuffles, in the same order
// in every run; a 2D mapping's slots 2 and 3 get 0.  Each block also
// writes the largest |w| * |g| of its points to `most` (one word a
// block), the bound the d_grid kernel scales its fixed point by.
template <int kGroup, int kP, int kNV, bool kVec>
__global__ void __launch_bounds__(kSliceThreads)
slice_bwd_dw_kernel(const int* __restrict__ x0,
                    const int* __restrict__ lane0,
                    const float4* __restrict__ w_lo,
                    const float4* __restrict__ w_hi,
                    const float* __restrict__ g_pts,
                    const float* __restrict__ grid,
                    float4* __restrict__ d_w_lo, float4* __restrict__ d_w_hi,
                    int* __restrict__ most, int n, int K, int F, int G,
                    int lane_extent, int off2, int off3) {
  __shared__ int block_most;
  constexpr int kGroups = kSliceThreads / kGroup;
  const int g = threadIdx.x / kGroup;
  const int sub = threadIdx.x % kGroup;
  const int p0 = blockIdx.x * (kGroups * kP) + g;
  const int quads = (F + 3) >> 2;
  const int offs[4] = {0, 1, off2, off3};
  if (threadIdx.x == 0) block_most = 0;
  int pt[kP], base[kP];
  float dw[kP][2 * kNV], w_most[kP], g_most[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    // clamped: lanes past n shuffle with their group and write nothing
    pt[i] = min(p0 + i * kGroups, n - 1);
    base[i] = (pt[i] / K) * G + __ldg(x0 + pt[i]) * lane_extent +
              __ldg(lane0 + pt[i]);
    const float4 a = __ldg(w_lo + pt[i]), b = __ldg(w_hi + pt[i]);
    w_most[i] = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                      fmaxf(fabsf(b.x), fabsf(b.y)));
    if (kNV == 4)
      w_most[i] = fmaxf(w_most[i], fmaxf(fmaxf(fabsf(a.z), fabsf(a.w)),
                                         fmaxf(fabsf(b.z), fabsf(b.w))));
    g_most[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * kNV; ++j) dw[i][j] = 0.0f;
  }
  for (int q = sub; q < quads; q += kGroup) {
    const int f = q << 2;
    if (kVec) {
      float4 gp[kP], v[kP][2 * kNV];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        gp[i] = __ldg(reinterpret_cast<const float4*>(g_pts + pt[i] * F + f));
        const float* gr = grid + base[i] * F + f;
#pragma unroll
        for (int j = 0; j < kNV; ++j) {
          v[i][j] = __ldg(reinterpret_cast<const float4*>(gr + offs[j] * F));
          v[i][kNV + j] = __ldg(reinterpret_cast<const float4*>(
              gr + (lane_extent + offs[j]) * F));
        }
      }
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        g_most[i] = fmaxf(g_most[i],
                          fmaxf(fmaxf(fabsf(gp[i].x), fabsf(gp[i].y)),
                                fmaxf(fabsf(gp[i].z), fabsf(gp[i].w))));
#pragma unroll
        for (int j = 0; j < 2 * kNV; ++j) {
          dw[i][j] = __fmaf_rn(v[i][j].x, gp[i].x, dw[i][j]);
          dw[i][j] = __fmaf_rn(v[i][j].y, gp[i].y, dw[i][j]);
          dw[i][j] = __fmaf_rn(v[i][j].z, gp[i].z, dw[i][j]);
          dw[i][j] = __fmaf_rn(v[i][j].w, gp[i].w, dw[i][j]);
        }
      }
    } else {
      const int nf = min(4, F - f);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float* gr = grid + base[i] * F + f;
        for (int e = 0; e < nf; ++e) {
          const float gp = __ldg(g_pts + pt[i] * F + f + e);
          g_most[i] = fmaxf(g_most[i], fabsf(gp));
#pragma unroll
          for (int j = 0; j < kNV; ++j) {
            dw[i][j] = __fmaf_rn(__ldg(gr + offs[j] * F + e), gp, dw[i][j]);
            dw[i][kNV + j] = __fmaf_rn(
                __ldg(gr + (lane_extent + offs[j]) * F + e), gp,
                dw[i][kNV + j]);
          }
        }
      }
    }
  }
  float t_most = 0.0f;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    t_most = fmaxf(t_most, w_most[i] * g_most[i]);
#pragma unroll
    for (int j = 0; j < 2 * kNV; ++j) dw[i][j] = group_sum(dw[i][j], kGroup);
    const int p = p0 + i * kGroups;
    if (p < n && sub == 0) {
      if constexpr (kNV == 4) {
        d_w_lo[p] = make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
        d_w_hi[p] = make_float4(dw[i][4], dw[i][5], dw[i][6], dw[i][7]);
      } else {
        d_w_lo[p] = make_float4(dw[i][0], dw[i][1], 0.0f, 0.0f);
        d_w_hi[p] = make_float4(dw[i][2], dw[i][3], 0.0f, 0.0f);
      }
    }
  }
  // non-negative floats order as their bits
  __syncthreads();   // block_most is 0
  const int bits = __reduce_max_sync(0xffffffffu, __float_as_int(t_most));
  if ((threadIdx.x & 31) == 0) atomicMax(&block_most, bits);
  __syncthreads();
  if (threadIdx.x == 0) most[blockIdx.x] = block_most;
}

// d_grid, slab-major as the splat (slice_bwd_kernel): block b takes row
// b / slabs and the words [s * slab_words, s * slab_words + n_words) of
// its G * F, s = b % slabs, held in shared memory as 64-bit integers from
// 0, a low and a high 32-bit word each.  A row is never cut into chunks of
// points: where a row's slabs would not fill the card the slabs are made
// smaller (slice_bwd_plan).  The row's scale is 2^S, S = 61 - bits(K) -
// e, where 2^e bounds |w| * |g| over the row's points (the largest of the
// d_w blocks' `most` that cover the row, which may take in a neighbouring
// row's points too): no sum of K terms times 2^S reaches 2^61.  The block
// scans its row's points kScanPoints at a time (x0 and lane0 only), lists
// those whose vertex cells reach into the slab, and adds each listed
// point's contributions c = w * g (one rounded multiply, as the plain
// version's) into the slab as the integers rint(c * 2^S): an atomicAdd on
// the low word, whose old value gives the carry, and one on the high word
// (native 32-bit shared-memory atomics); a point on a group of 1-8 lanes
// of feature quads, two points a group with their loads in flight, as the
// splat.  Integer sums do not depend on their order, so each word is the
// same in every run, whatever order the list and the atomics take: the
// sum of the terms rounded to multiples of 2^-S, within K * 2^-(S+1) of
// the exact sum (about K^2 * max * 2^-62), rounded once to float32 as
// the word is written: every word once, as float4 where F % 4 == 0, zeros
// included; no fill, no float atomics, no second pass.  This is not the
// order of the plain version's float sums (ascending point, vertex), so
// d_grid is held within 1e-5 of it, not bit-equal.  A 2D mapping's slots
// 2 and 3 carry weight 0 and are not visited.
template <int kGroup, int kNV, bool kVec>
__global__ void __launch_bounds__(kSplatThreads)
slice_bwd_kernel(const int* __restrict__ x0, const int* __restrict__ lane0,
                 const float4* __restrict__ w_lo,
                 const float4* __restrict__ w_hi,
                 const float* __restrict__ g_pts,
                 const int* __restrict__ most, float* __restrict__ d_grid,
                 int K, int F, int G, int lane_extent, int off2, int off3,
                 int slabs, int slab_words, int dw_per_block) {
  // dynamic: the slab's low and high words, then the list
  extern __shared__ __align__(16) unsigned sb_shared[];
  unsigned* slab_lo = sb_shared;
  int* slab_hi = reinterpret_cast<int*>(sb_shared + slab_words);
  int* listed_k = slab_hi + slab_words;
  __shared__ int listed, row_most;
  constexpr int kGroups = kSplatThreads / kGroup;
  const int s = blockIdx.x % slabs, r = blockIdx.x / slabs;
  const int row_words = G * F;
  const int wb = s * slab_words;
  const int n_words = min(slab_words, row_words - wb);
  const int sub = threadIdx.x % kGroup;
  const int quads = (F + 3) >> 2;
  const int offs[4] = {0, 1, off2, off3};
  for (int i = threadIdx.x; i < n_words; i += kSplatThreads) {
    slab_lo[i] = 0u;
    slab_hi[i] = 0;
  }
  if (threadIdx.x == 0) row_most = 0;
  __syncthreads();
  {   // the row's bound: the d_w blocks that cover its points
    const int b0 = (int)((int64_t)r * K / dw_per_block);
    const int b1 = (int)(((int64_t)r * K + K - 1) / dw_per_block);
    int m = 0;
    for (int b = b0 + threadIdx.x; b <= b1; b += kSplatThreads)
      m = max(m, __ldg(most + b));
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) atomicMax(&row_most, m);
  }
  __syncthreads();   // the fill and the bound are in
  int e_most = 0;
  frexpf(__int_as_float(row_most), &e_most);   // |w| * |g| < 2^e_most
  const int S = max(-126, min(126, 61 - (32 - __clz(K)) - e_most));
  const float scale = ldexpf(1.0f, S), unscale = ldexpf(1.0f, -S);
  // cells from a point's base cell to past its last vertex
  const int reach = lane_extent + off3 + 1;
  for (int k0 = 0; k0 < K; k0 += kScanPoints) {
    // after the last list is done with
    const int n = list_slab_points(x0, lane0, r * K, k0, K, F, lane_extent,
                                   reach, wb, n_words, listed_k, listed);
    for (int j0 = threadIdx.x / kGroup; j0 < n; j0 += kGroups * kListP) {
      int pt[kListP], at[kListP];
      float4 wl[kListP], wh[kListP];
#pragma unroll
      for (int q = 0; q < kListP; ++q) {
        const int j = min(j0 + q * kGroups, n - 1);   // clamped: a real entry
        pt[q] = r * K + listed_k[j];
        at[q] = (__ldg(x0 + pt[q]) * lane_extent + __ldg(lane0 + pt[q])) * F
                - wb;
        wl[q] = __ldg(w_lo + pt[q]);
        wh[q] = __ldg(w_hi + pt[q]);
      }
      for (int qd = sub; qd < quads; qd += kGroup) {
        const int f = qd << 2;
        const int nf = kVec ? 4 : min(4, F - f);
        float v[kListP][4];
#pragma unroll
        for (int q = 0; q < kListP; ++q) {
          if (kVec) {
            const float4 t = __ldg(
                reinterpret_cast<const float4*>(g_pts + pt[q] * F + f));
            v[q][0] = t.x; v[q][1] = t.y; v[q][2] = t.z; v[q][3] = t.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[q][e] = e < nf ? __ldg(g_pts + pt[q] * F + f + e) : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kListP; ++q) {
          if (j0 + q * kGroups >= n) break;
          const float lo[4] = {wl[q].x, wl[q].y, wl[q].z, wl[q].w};
          const float hi[4] = {wh[q].x, wh[q].y, wh[q].z, wh[q].w};
#pragma unroll
          for (int j = 0; j < 2 * kNV; ++j) {
            const float w = j < kNV ? lo[j] : hi[j - kNV];
            const int c = at[q] + (j < kNV ? offs[j]
                                           : lane_extent + offs[j - kNV]) * F
                          + f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (e >= nf) break;
              if ((unsigned)(c + e) >= (unsigned)n_words) continue;
              const long long term = __float2ll_rn(
                  __fmul_rn(__fmul_rn(w, v[q][e]), scale));
              const unsigned low = (unsigned)term;
              const unsigned old = atomicAdd(slab_lo + c + e, low);
              atomicAdd(slab_hi + c + e,
                        (int)(term >> 32) + (old + low < old ? 1 : 0));
            }
          }
        }
      }
    }
  }
  __syncthreads();   // every deposit is in
  float* out = d_grid + r * row_words + wb;
  auto word = [&](int i) {
    const long long v = (long long)(((unsigned long long)(unsigned)slab_hi[i]
                                     << 32) | slab_lo[i]);
    return __fmul_rn(__ll2float_rn(v), unscale);
  };
  if (row_words % 4 == 0) {   // n_words and the row start too
    for (int i = threadIdx.x; i < n_words / 4; i += kSplatThreads)
      reinterpret_cast<float4*>(out)[i] = make_float4(
          word(4 * i), word(4 * i + 1), word(4 * i + 2), word(4 * i + 3));
  } else {
    for (int i = threadIdx.x; i < n_words; i += kSplatThreads)
      out[i] = word(i);
  }
}

// Lanes that share one point: the next power of two >= min(F, 32).
int feature_group(int F) {
  int group = 1;
  while (group < F && group < 32) group <<= 1;
  return group;
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

// The winner pass on the plan's layout, group and blocks, its kernels
// tagged with the entry point they serve.
template <class Use>
int launch_winner(const int* p, const BwdArgs& a, cudaStream_t stream) {
  if (!p[15]) {   // quad-major
    const int group = p[8], n_vert = p[7], vec = p[12];
    const dim3 grid((unsigned)p[14]);
#define CT_WQ(GR, NV, VEC)                                                 \
  splat_winner_quads_kernel<Use, GR, NV, VEC>                               \
      <<<grid, kBwdThreads, 0, stream>>>(                                   \
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
  splat_winner_kernel<Use, GR, NV><<<grid, kBwdThreads, 0, stream>>>(       \
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

// The splat's plan (splat_plan) recomputed from its integers p: R, K, F, G,
// lane_extent, off2, off3, n_vert, then the plan's group, threads, slabs,
// slab words, chunks, points a chunk, blocks and float4 flag.  False where
// one disagrees, where an index would reach 2^31, where the weights (read
// as float4) or the grid (written as float4) are not 16-byte aligned, or
// where float4 values are asked of a row that is not.
bool splat_plan_ok(const int* p, bool values_aligned, bool grid_aligned,
                   bool weights_aligned) {
  const int R = p[0], K = p[1], F = p[2], G = p[3], n_vert = p[7],
            group = p[8], threads = p[9], slabs = p[10], slab_words = p[11],
            chunks = p[12], chunk = p[13], blocks = p[14], vec = p[15];
  const int64_t limit = (int64_t)1 << 31;
  if ((int64_t)R * K * F >= limit || (int64_t)R * G * F >= limit)
    return false;
  const int64_t words = (int64_t)G * F;
  const int64_t even = (words + (words + kSlabWords - 1) / kSlabWords - 1) /
                       ((words + kSlabWords - 1) / kSlabWords);
  const int64_t slab = (even + 3) / 4 * 4;
  const int64_t n_slabs = (words + slab - 1) / slab;
  int64_t n_chunks = (kFillBlocks + R * n_slabs - 1) / (R * n_slabs);
  n_chunks = std::min(n_chunks, ((int64_t)K + kMinChunk - 1) / kMinChunk);
  n_chunks = std::max(n_chunks, (int64_t)1);
  const int64_t per_chunk = (K + n_chunks - 1) / n_chunks;
  n_chunks = (K + per_chunk - 1) / per_chunk;
  return group == slice_group(F) && threads == kSplatThreads &&
         slab_words == slab && slabs == n_slabs && chunk == per_chunk &&
         chunks == n_chunks && blocks == R * n_slabs * n_chunks &&
         vec == (F % 4 == 0 && values_aligned) &&
         (n_vert == 2 || n_vert == 4) && grid_aligned && weights_aligned;
}

// The splat on the plan's group and blocks, its kernels tagged with the
// entry point they serve.
template <class Use>
int launch_splat(const int* p, const int* x0, const int* lane0,
                 const float* w_lo, const float* w_hi, const float* values,
                 float* grid, int* winner, bool track, cudaStream_t stream) {
  const float4* wl = reinterpret_cast<const float4*>(w_lo);
  const float4* wh = reinterpret_cast<const float4*>(w_hi);
  const int K = p[1], F = p[2], G = p[3], lane_extent = p[4], off2 = p[5],
            off3 = p[6], n_vert = p[7], slabs = p[10], slab_words = p[11],
            chunks = p[12], chunk = p[13], vec = p[15];
  const dim3 blocks((unsigned)p[14]);
#define CT_SPL(GR, NV, VEC)                                                 \
  splat_slab_kernel<Use, GR, NV, VEC><<<blocks, kSplatThreads, 0, stream>>>( \
      x0, lane0, wl, wh, values, grid, winner, K, F, G, lane_extent, off2,  \
      off3, slabs, slab_words, chunks, chunk, track)
#define CT_SPL_V(GR, NV) \
  if (vec) CT_SPL(GR, NV, true); else CT_SPL(GR, NV, false)
#define CT_SPL_N(GR)                    \
  if (n_vert == 2) { CT_SPL_V(GR, 2); } \
  else { CT_SPL_V(GR, 4); }             \
  break
  switch (p[8]) {
    case 1: CT_SPL_N(1);
    case 2: CT_SPL_N(2);
    case 4: CT_SPL_N(4);
    case 8: CT_SPL_N(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CT_SPL_N
#undef CT_SPL_V
#undef CT_SPL
  return (int)cudaGetLastError();
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
  const int err = launch_winner<use::splat_max_bwd>(p, a,
                                                   (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_bwd<RoutePass>(p, a, (cudaStream_t)stream);
}


// The splat on the caller's plan (splat_plan), into ``grid``: written
// whole where the plan has one chunk a row, raised by atomics where it has
// several (the caller then zero-fills it).  ``p`` as splat_plan_ok reads it
// (SPLAT_PARAMS); a launch whose numbers disagree with the plan launches
// nothing.
extern "C" int ct_splat_max(const int* x0, const int* lane0, const float* w_lo,
                            const float* w_hi, const float* values,
                            float* grid, const int* p, void* stream) {
  if ((int64_t)p[0] * p[1] * p[2] <= 0) return 0;
  if (!splat_plan_ok(p, aligned16({values}), aligned16({grid}),
                     aligned16({w_lo, w_hi})))
    return (int)cudaErrorInvalidValue;
  return launch_splat<use::splat_max>(p, x0, lane0, w_lo, w_hi, values, grid,
                                      nullptr, false, (cudaStream_t)stream);
}

// The grid and the winner map: the splat on its plan ``p_splat`` into
// ``grid`` (as ct_splat_max), which also fills ``winner`` (int32
// [R, G, F]) with INT_MAX and, where each block is its row's only chunk
// and lists its points at one go, records the winners itself; else the
// splat backward's winner pass follows on its plan ``p_bwd`` (the routing
// half of which is not launched).  Both plans are checked before any
// launch.
extern "C" int ct_splat_max_winner(const int* x0, const int* lane0,
                                   const float* w_lo, const float* w_hi,
                                   const float* values, float* grid,
                                   int* winner, const int* p_splat,
                                   const int* p_bwd, void* stream) {
  if ((int64_t)p_splat[0] * p_splat[1] * p_splat[2] <= 0) return 0;
  const bool weights = aligned16({w_lo, w_hi});
  for (int i = 0; i < 8; ++i)
    if (p_splat[i] != p_bwd[i]) return (int)cudaErrorInvalidValue;
  if (!splat_plan_ok(p_splat, aligned16({values}), aligned16({grid, winner}),
                     weights) ||
      !bwd_plan_ok(p_bwd, aligned16({values, grid, winner}), weights))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool track = p_splat[12] == 1 && p_splat[13] <= kScanPoints;
  const int err = launch_splat<use::splat_max_winner>(
      p_splat, x0, lane0, w_lo, w_hi, values, grid, winner, track, s);
  if (err != 0 || track) return err;
  const BwdArgs a = bwd_args(p_bwd, x0, lane0, w_lo, w_hi, values, grid,
                             winner, nullptr, nullptr, nullptr, nullptr);
  return launch_winner<use::splat_max_winner>(p_bwd, a, s);
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

namespace {

// The slice backward's plan (slice_bwd_plan) recomputed from its integers
// p: R, K, F, G, lane_extent, off2, off3, n_vert, then the lanes a point
// (both launches), the d_grid launch's threads, slab words, slabs a row
// and blocks, the d_w launch's points a thread and blocks, and the float4
// flag.
// False where one disagrees, where an index would reach 2^31, or where
// float4 access is asked of rows (g_pts, grid, d_grid, d_w) or always of
// the weights that are not 16-byte aligned.
bool slice_bwd_plan_ok(const int* p, bool rows_aligned, bool aligned) {
  const int R = p[0], K = p[1], F = p[2], G = p[3], n_vert = p[7],
            group = p[8], threads = p[9], slab_words = p[10], slabs = p[11],
            blocks = p[12], points = p[13], dw_blocks = p[14], vec = p[15];
  const int64_t limit = (int64_t)1 << 31;
  if ((int64_t)R * K * F >= limit || (int64_t)R * G * F >= limit || G <= 0)
    return false;
  // the fewest even slabs that fit, or as many as fill the card (of 4
  // words at least)
  const int64_t words = (int64_t)G * F;
  const int64_t most = (words + 3) / 4;
  int64_t n_slabs = std::max(
      (words + kSbSlabWords - 1) / kSbSlabWords,
      std::min<int64_t>((kSbFillBlocks + R - 1) / R, most));
  const int64_t slab = ((words + n_slabs - 1) / n_slabs + 3) / 4 * 4;
  n_slabs = (words + slab - 1) / slab;
  const int64_t n = (int64_t)R * K;
  const int64_t per_block = (int64_t)points * (kSliceThreads / group);
  return group == slice_group(F) && threads == kSplatThreads &&
         slab_words == slab && slabs == n_slabs && blocks == R * n_slabs &&
         (points == 1 || points == 2 || points == 4) &&
         dw_blocks == (n + per_block - 1) / per_block &&
         vec == (F % 4 == 0 && rows_aligned) &&
         (n_vert == 2 || n_vert == 4) && aligned;
}

template <int kGroup, int kP>
void launch_slice_bwd_dw(const int* p, const int* x0, const int* lane0,
                         const float4* w_lo, const float4* w_hi,
                         const float* g_pts, const float* grid,
                         float* d_w_lo, float* d_w_hi, int* most,
                         cudaStream_t stream) {
  float4* lo = reinterpret_cast<float4*>(d_w_lo);
  float4* hi = reinterpret_cast<float4*>(d_w_hi);
  const dim3 blocks((unsigned)p[14]);
#define CT_SBDW(NV, VEC)                                                     \
  slice_bwd_dw_kernel<kGroup, kP, NV, VEC>                                    \
      <<<blocks, kSliceThreads, 0, stream>>>(                                 \
      x0, lane0, w_lo, w_hi, g_pts, grid, lo, hi, most, p[0] * p[1], p[1],    \
      p[2], p[3], p[4], p[5], p[6])
  if (p[7] == 2) {
    if (p[15]) CT_SBDW(2, true); else CT_SBDW(2, false);
  } else {
    if (p[15]) CT_SBDW(4, true); else CT_SBDW(4, false);
  }
#undef CT_SBDW
}

template <int kGroup>
void launch_slice_bwd(const int* p, const int* x0, const int* lane0,
                      const float* w_lo, const float* w_hi,
                      const float* g_pts, const float* grid, float* d_grid,
                      float* d_w_lo, float* d_w_hi, int* most,
                      cudaStream_t stream) {
  const float4* wl = reinterpret_cast<const float4*>(w_lo);
  const float4* wh = reinterpret_cast<const float4*>(w_hi);
  switch (p[13]) {
    case 1: launch_slice_bwd_dw<kGroup, 1>(p, x0, lane0, wl, wh, g_pts, grid, d_w_lo, d_w_hi, most, stream); break;
    case 2: launch_slice_bwd_dw<kGroup, 2>(p, x0, lane0, wl, wh, g_pts, grid, d_w_lo, d_w_hi, most, stream); break;
    case 4: launch_slice_bwd_dw<kGroup, 4>(p, x0, lane0, wl, wh, g_pts, grid, d_w_lo, d_w_hi, most, stream); break;
  }
  if (cudaPeekAtLastError() != cudaSuccess) return;
  const dim3 blocks((unsigned)p[12]);
  const int per_block = p[13] * (kSliceThreads / kGroup);
  const int smem = p[10] * 8 + kScanPoints * 4;
#define CT_SB(NV, VEC)                                                      \
  do {                                                                      \
    if (smem <= 48 * 1024 ||                                                \
        cudaFuncSetAttribute(slice_bwd_kernel<kGroup, NV, VEC>,             \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             smem) == cudaSuccess)                          \
      slice_bwd_kernel<kGroup, NV, VEC><<<blocks, kSplatThreads, smem,       \
                                          stream>>>(                        \
          x0, lane0, wl, wh, g_pts, most, d_grid, p[1], p[2], p[3], p[4],    \
          p[5], p[6], p[11], p[10], per_block);                             \
  } while (0)
  if (p[7] == 2) {
    if (p[15]) CT_SB(2, true); else CT_SB(2, false);
  } else {
    if (p[15]) CT_SB(4, true); else CT_SB(4, false);
  }
#undef CT_SB
}

}  // namespace

// The slice backward on the caller's plan (slice_bwd_plan), two launches:
// d_w, which also writes its blocks' bounds to ``most`` (int32
// [dw_blocks], scratch), then d_grid (written whole: no fill).  ``p`` as
// slice_bwd_plan_ok reads it (SLICE_BWD_PARAMS); a launch whose numbers
// disagree with the plan launches nothing.
extern "C" int ct_slice_bwd(const int* x0, const int* lane0,
                            const float* w_lo, const float* w_hi,
                            const float* g_pts, const float* grid,
                            float* d_grid, float* d_w_lo, float* d_w_hi,
                            int* most, const int* p, void* stream) {
  if ((int64_t)p[0] * p[1] * p[2] <= 0) return 0;
  if (!slice_bwd_plan_ok(p, aligned16({g_pts, grid, d_grid}),
                         aligned16({w_lo, w_hi, d_w_lo, d_w_hi})))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p[8]) {
    case 1: launch_slice_bwd<1>(p, x0, lane0, w_lo, w_hi, g_pts, grid, d_grid, d_w_lo, d_w_hi, most, s); break;
    case 2: launch_slice_bwd<2>(p, x0, lane0, w_lo, w_hi, g_pts, grid, d_grid, d_w_lo, d_w_hi, most, s); break;
    case 4: launch_slice_bwd<4>(p, x0, lane0, w_lo, w_hi, g_pts, grid, d_grid, d_w_lo, d_w_hi, most, s); break;
    case 8: launch_slice_bwd<8>(p, x0, lane0, w_lo, w_hi, g_pts, grid, d_grid, d_w_lo, d_w_hi, most, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
