// The fused MHCT block: splat-max -> grouped 'same' 3^dim conv + bias ->
// slice, one grid row r = b * H + h (head h) at a time.
//
// Replaces cloud_transformers_tpu/ops/pallas_fused_block.py:
// pallas_fused_block, which runs the three Pallas kernel bodies in turn on a
// grid held in VMEM, one grid row per program.  VMEM holds a whole row; a
// block's 227 KB of shared memory does not (128^2 x 4, 64^2 x 16, 16^3 x
// 16: 256 KiB; 32^3 x 4: 512 KiB, and the convolved grid as much again).
//
// fused_cluster_kernel<DIM, kFP>: a row on a thread-block cluster of C
// CTAs (fused_block_plan in ops/pallas_fused_block.py chooses C, 1 to 16,
// and the entry point recomputes it), the row's grids in distributed
// shared memory.  CTA c owns the x-slab [c * SX, c * SX + SX) of both
// grids:
// * gk as [quad][x plane][y][z][4] floats, channels in quads of four
//   (padded with zeros to FP = 4 * ceil(F / 4)), with one zero cell of
//   padding on every side: planes 0 and SX + 1 are the neighbours' edge
//   planes (the conv's halo), and the run axis (y in 3D, x in 2D) is
//   padded to a multiple of 4 plus 2;
// * gk2 as [x][y][z][FP], unpadded;
// * the head's weights as [tap][fi][fo] (FP x FP, zeros past F).
// Phases, with cluster.sync() where a CTA reads another's slab:
// 1. zero gk's slab and start the weights' copy (cp.async, waited for
//    before the conv);
// 2. splat: every CTA scans the row's x0, a warp 128 points at a time,
//    keeps by ballot those with a vertex row in its slab and hands them
//    out one a lane, so that a lane's loads never wait on another point's.
//    Each positive contribution w * v of a row in the slab goes in with a
//    32-bit atomicMax on its bits in the CTA's own shared memory, and only
//    where it exceeds what the cell holds (loaded for all of the point's
//    rows before the first atomic).  An atomic on another CTA's shared
//    memory costs many times more: routed that way the splat took most of
//    the kernel's time.  Positive floats order like their bits and a
//    contribution <= 0 loses to the zero fill, so gk is bit-equal to
//    splat_max's in every run;
// 3. each CTA writes its slab of gk out (the stats and the backward read
//    it), copies its two halo planes from its neighbours, and convolves
//    its slab: a thread keeps 4 cells along the run axis x FO output
//    channels in registers; per input-channel quad and tap row it loads 6
//    float4 of 4 channels once for the three taps along the run, and per
//    (tap, channel) its FO weights as float4 broadcasts (30 shared loads
//    for 384 FMAs at FO = 8), as the grid conv kernels #3 and #7 do.
//    Threads of a warp run along the fast axis (z in 3D, y in 2D), so that
//    their float4 loads are consecutive.  Bias in the epilogue, into gk2;
// 4. slice, point-major as slice_kernel: a CTA takes the points whose
//    lower plane x0 lies in its slab, found as in the splat, a point on a
//    group of 1-8 lanes holding quads of features, and gathers its 2^dim
//    vertex rows of gk2 as float4 quads (the upper plane's from the next
//    CTA where x0 is its slab's last); the sum over the lo vertices, then
//    the hi ones, from 0.  gk2 is written out only when it is wanted.  A
//    last cluster.sync() keeps every slab alive until the cluster has read
//    it.
// Every sum runs in a fixed order and the only atomics are the integer
// max, so two runs are bit-equal.  2D mappings carry zero weights in slots
// 2 and 3, which are skipped.
//
// fused_block_kernel<DZ> is the device-memory path for rows whose grids
// and weights do not fit even a 16-CTA cluster (of the head groups'
// sizes: 32^3 at F >= 9, 128^2 at F >= 21, 16^3 at F >= 29; no head group
// of the classifier or of the completion model): one 1024-thread block a
// row, the weights in shared memory, the grids in device memory, the
// phases meeting at __syncthreads().
//
// Bound on the H100: the conv's float32 operations for the F = 16 and 32
// grids, bytes (the mapping and point features in, the points and gk out,
// gk2 out under a gradient) for the F = 4 grids.  What holds the cluster
// path from it: the conv runs at about half the FMA rate, with one CTA on
// an SM at 16^3 x 16 and 8^3 x 32 (their slabs and weights take 223 KB),
// so the latency-bound splat and slice of a CTA overlap no other CTA's
// conv; and the splat's shared-memory atomics and loads on scattered
// cells.

#include <cooperative_groups.h>
#include <limits.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---- the cluster path -----------------------------------------------------

constexpr int kClusterThreads = 512;  // a CTA's threads, or half of them
constexpr int kFillCtas = 64;     // CTAs a launch should have at least
constexpr int kMaxCluster = 16;   // above 8: a non-portable cluster size
constexpr int kPortableCluster = 8;
constexpr int kSmPerSm = 233472;  // 228 KB of shared memory an SM holds
constexpr int kCtaReserve = 1024; // of it the system keeps for each CTA
constexpr int kRun = 4;           // conv cells a thread keeps on the run axis
constexpr int kScan = 4;          // points a lane scans at a time

struct ClusterArgs {
  const int* x0;
  const int* lane0;
  const float4* w_lo;
  const float4* w_hi;
  const float* values;
  const float* weight;
  const float* bias;
  float* pts;
  float* gk;
  float* gk2;    // written only with want_gk2
  int H, K, F, X, Y, Z, want_gk2;
  int C, SX, PX, PY, PZ, FP, QS, group;
};

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 4-byte asynchronous copy device memory -> shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// kFP: F = 4, 8, 16 or 32 at compile time (float4 rows, FO = min(F, 8)
// output channels a conv thread), or 0: any F at run time (scalar rows,
// FO = 4).
template <int DIM, int kFP>
__global__ void __launch_bounds__(kClusterThreads)
fused_cluster_kernel(const ClusterArgs a) {
  constexpr int kTaps = DIM == 3 ? 27 : 9;
  constexpr int kNV = DIM == 3 ? 4 : 2;
  constexpr bool VEC = kFP != 0;
  constexpr int FO = kFP == 0 ? 4 : (kFP < 8 ? kFP : 8);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / a.C;
  const int h = r % a.H;
  const int F = kFP ? kFP : a.F, FP = kFP ? kFP : a.FP, FQ = FP >> 2;
  const int Y = a.Y, Z = a.Z;
  const int L = Y * Z;                      // cells of an x plane
  const int G = a.X * L;
  const int xs = rank * a.SX;
  const int sx = min(a.SX, a.X - xs);       // this CTA's planes
  const int plane_len = a.PY * a.PZ;        // padded cells of a plane
  float* w_s = smem;                        // [tap][fi][fo], FP x FP
  float* gk_s = w_s + kTaps * FP * FP;      // [quad][PX][PY][PZ][4]
  float* gk2_s = gk_s + FQ * a.QS;          // [SX][Y][Z][FP]
  int* slots = reinterpret_cast<int*>(gk2_s + a.SX * L * FP);  // kScan a thread
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. zero the padded slab (and the weights' padding), then start the
  // weights' copy (the parameter layout read in order) with cp.async: it
  // runs under the splat, and the conv waits for it
  {
    float4* z4 = reinterpret_cast<float4*>(FP == F ? gk_s : w_s);
    const int n4 = (FP == F ? FQ * a.QS : kTaps * FP * FP + FQ * a.QS) / 4;
    for (int i = tid; i < n4; i += nt) z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const float* w_h = a.weight + (size_t)h * F * F * kTaps;
    for (int i = tid; i < F * F * kTaps; i += nt) {
      const int tap = i % kTaps, fi = (i / kTaps) % F, fo = i / (kTaps * F);
      cp_async4(w_s + (tap * FP + fi) * FP + fo, w_h + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Each warp scans kScan * 32 of the row's points at a time (the x0 loads
  // all in flight), keeps those whose plane x0 lies in [x_lo, x_hi) in its
  // slots, in order, and hands them out to its groups of `group` lanes (1
  // in the splat), one point a group: a lane's loads for its point are in
  // flight with the other groups', and nothing waits on a point it does
  // not hold.  body(point, lane in its group).
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int row0 = r * a.K;
  int* my_slots = slots + warp * 32 * kScan;
  auto each_point = [&](int x_lo, int x_hi, int group, auto&& body) {
    for (int base = warp * 32 * kScan; base < a.K;
         base += n_warps * 32 * kScan) {
      int x[kScan];
#pragma unroll
      for (int s = 0; s < kScan; ++s) {
        const int p = base + s * 32 + lane;
        x[s] = p < a.K ? __ldg(a.x0 + row0 + p) : -2;
      }
      int n = 0;
#pragma unroll
      for (int s = 0; s < kScan; ++s) {
        const bool mine = x[s] >= x_lo && x[s] < x_hi;
        const unsigned mask = __ballot_sync(0xffffffffu, mine);
        if (mine)
          my_slots[n + __popc(mask & ((1u << lane) - 1u))] =
              base + s * 32 + lane;
        n += __popc(mask);
      }
      __syncwarp();
#pragma unroll 2
      for (int i = lane / group; i < n; i += 32 / group)
        body(row0 + my_slots[i], lane % group);
      __syncwarp();
    }
  };
  // the point's lane coordinates (y, z), split from lane0
  auto yz = [&](int gp, int& y, int& z) {
    const int l = __ldg(a.lane0 + gp);
    y = DIM == 3 ? l / Z : l;
    z = DIM == 3 ? l - y * Z : 0;
  };
  auto quad = [&](int gp, int q) {
    if (VEC)
      return __ldg(reinterpret_cast<const float4*>(a.values + gp * F + 4 * q));
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = 4 * q + e < F ? __ldg(a.values + gp * F + 4 * q + e) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  };

  // 2. splat: the points with a vertex row in this slab (x0 or x0 + 1),
  // one a lane, each row that lies here with shared-memory atomics on the
  // int bits
  each_point(xs - 1, xs + sx, 1, [&](int gp, int) {
    const int x = __ldg(a.x0 + gp);
    int y, z;
    yz(gp, y, z);
    const float4 lo = __ldg(a.w_lo + gp), hi = __ldg(a.w_hi + gp);
    const float w[2][4] = {{lo.x, lo.y, lo.z, lo.w}, {hi.x, hi.y, hi.z, hi.w}};
    const int cell0 = (y + 1) * a.PZ + (DIM == 3 ? z + 1 : 0);
    // word offset of vertex j from the point's base cell in a row
    auto voff = [&](int j) {
      return DIM == 3 ? ((j >> 1) * a.PZ + (j & 1)) * 4 : j * 4;
    };
    const int pl_lo = x - xs + 1;   // padded local planes of the rows
    const bool row_in[2] = {pl_lo >= 1, pl_lo + 1 <= sx};
#pragma unroll 2
    for (int q = 0; q < FQ; ++q) {
      const float4 v4 = quad(gp, q);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      int* dst[2];
      // what the cells hold, every row's loaded before any atomic: a
      // contribution no larger cannot change the maximum and skips its
      // atomic
      int4 held[2][kNV];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        dst[side] = reinterpret_cast<int*>(gk_s + q * a.QS) +
                    ((pl_lo + side) * plane_len + cell0) * 4;
#pragma unroll
        for (int j = 0; j < kNV; ++j)
          held[side][j] = row_in[side]
              ? *reinterpret_cast<const int4*>(dst[side] + voff(j))
              : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      }
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < kNV; ++j) {
          const int hv[4] = {held[side][j].x, held[side][j].y,
                             held[side][j].z, held[side][j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float c = w[side][j] * v[e];   // one rounded multiply
            if (c > 0.0f && __float_as_int(c) > hv[e])
              atomicMax(dst[side] + voff(j) + e, __float_as_int(c));
          }
        }
    }
  });
  cluster.sync();

  // 3a. gk out: the slab's cells, quads of the same cell on neighbouring
  // threads
  {
    float* out = a.gk + ((size_t)r * G + (size_t)xs * L) * F;
    for (int i = tid; i < sx * L * FQ; i += nt) {
      const int q = i % FQ, c = i / FQ;
      const int lx = c / L, lane = c - lx * L;
      const int y = DIM == 3 ? lane / Z : lane;
      const int z = lane - y * Z;
      const int pc = ((lx + 1) * a.PY + y + 1) * a.PZ + (DIM == 3 ? z + 1 : 0);
      const float4 v =
          *reinterpret_cast<const float4*>(gk_s + q * a.QS + pc * 4);
      if (VEC) {
        *reinterpret_cast<float4*>(out + c * F + 4 * q) = v;
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && 4 * q + e < F; ++e)
          out[c * F + 4 * q + e] = vv[e];
      }
    }
  }
  // 3b. the halo planes from the neighbours' edges (zeros at the grid's
  // edges, from phase 1)
  {
    const bool lo = xs > 0, hi = xs + sx < a.X;
    const float4* from_lo = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(gk_s, lo ? rank - 1 : rank));
    const float4* from_hi = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(gk_s, hi ? rank + 1 : rank));
    float4* g4 = reinterpret_cast<float4*>(gk_s);
    const int qs4 = a.QS / 4;
    for (int i = tid; i < 2 * FQ * plane_len; i += nt) {
      const int side = i / (FQ * plane_len);
      const int rest = i - side * FQ * plane_len;
      const int q = rest / plane_len, c = rest - q * plane_len;
      if (side == 0 && lo)   // the lower neighbour's last plane, SX
        g4[q * qs4 + c] = from_lo[q * qs4 + a.SX * plane_len + c];
      if (side == 1 && hi)   // the upper neighbour's first plane, 1
        g4[q * qs4 + (sx + 1) * plane_len + c] =
            from_hi[q * qs4 + plane_len + c];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);   // the weights are in
  __syncthreads();

  // 3c. the conv of the slab into gk2_s
  {
    const int FOG = FP / FO;
    const int runs = DIM == 3 ? (Y + kRun - 1) / kRun : (sx + kRun - 1) / kRun;
    const int fast = DIM == 3 ? Z : Y;
    const int n_items = FOG * (DIM == 3 ? sx : 1) * runs * fast;
    for (int t = tid; t < n_items; t += nt) {
      const int f_ax = t % fast;
      const int run = (t / fast) % runs;
      const int lx = DIM == 3 ? (t / (fast * runs)) % sx : 0;
      const int fo0 = (t / (fast * runs * (DIM == 3 ? sx : 1))) * FO;
      float acc[kRun][FO];
#pragma unroll
      for (int j = 0; j < kRun; ++j)
#pragma unroll
        for (int o = 0; o < FO; ++o) acc[j][o] = 0.0f;
      for (int fq = 0; fq < FQ; ++fq) {
        const float4* in4 = reinterpret_cast<const float4*>(gk_s + fq * a.QS);
        const float* w_q = w_s + 4 * fq * FP + fo0;
#pragma unroll 1
        for (int s = 0; s < (DIM == 3 ? 9 : 3); ++s) {
          // 3D: s = (dx, dz), the run along y; 2D: s = dy, the run along x
          const int d0 = DIM == 3 ? s / 3 : 0, d1 = DIM == 3 ? s % 3 : s;
          float4 v[kRun + 2];
#pragma unroll
          for (int j = 0; j < kRun + 2; ++j)
            v[j] = DIM == 3
                ? in4[((lx + d0) * a.PY + run * kRun + j) * a.PZ + f_ax + d1]
                : in4[(run * kRun + j) * a.PY + f_ax + d1];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            // the tap along the run: dy in 3D, dx in 2D
            const int tap = DIM == 3 ? (d0 * 3 + d) * 3 + d1 : d * 3 + d1;
            const float* wp = w_q + tap * FP * FP;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float w[FO];
#pragma unroll
              for (int o = 0; o < FO; o += 4) {
                const float4 w4 =
                    *reinterpret_cast<const float4*>(wp + k * FP + o);
                w[o] = w4.x; w[o + 1] = w4.y; w[o + 2] = w4.z; w[o + 3] = w4.w;
              }
#pragma unroll
              for (int j = 0; j < kRun; ++j) {
                const float in = lane4(v[j + d], k);
#pragma unroll
                for (int o = 0; o < FO; ++o)
                  acc[j][o] = fmaf(in, w[o], acc[j][o]);
              }
            }
          }
        }
      }
      float b[FO];
#pragma unroll
      for (int o = 0; o < FO; ++o)
        b[o] = fo0 + o < F ? __ldg(a.bias + h * F + fo0 + o) : 0.0f;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int along = run * kRun + j;
        if (along >= (DIM == 3 ? Y : sx)) break;
        const int c = DIM == 3 ? (lx * Y + along) * Z + f_ax
                               : along * Y + f_ax;
        float* dst = gk2_s + c * FP + fo0;
#pragma unroll
        for (int o = 0; o < FO; o += 4)
          *reinterpret_cast<float4*>(dst + o) =
              make_float4(acc[j][o] + b[o], acc[j][o + 1] + b[o + 1],
                          acc[j][o + 2] + b[o + 2], acc[j][o + 3] + b[o + 3]);
      }
    }
  }
  cluster.sync();

  // 4a. gk2 out, when it is wanted
  if (a.want_gk2) {
    float* out = a.gk2 + ((size_t)r * G + (size_t)xs * L) * F;
    for (int i = tid; i < sx * L * FQ; i += nt) {
      const int q = i % FQ, c = i / FQ;
      const float4 v = *reinterpret_cast<const float4*>(gk2_s + c * FP + 4 * q);
      if (VEC) {
        *reinterpret_cast<float4*>(out + c * F + 4 * q) = v;
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && 4 * q + e < F; ++e)
          out[c * F + 4 * q + e] = vv[e];
      }
    }
  }
  // 4b. slice the points whose lo plane x0 lies in this slab (the hi
  // plane is here too, or the next CTA's first), point-major as
  // slice_kernel: a point on a group of `group` lanes holding quads of
  // features, two points a group in flight
  each_point(xs, xs + sx, a.group, [&](int gp, int sub) {
    const int x = __ldg(a.x0 + gp);
    int y, z;
    yz(gp, y, z);
    const float4 lo = __ldg(a.w_lo + gp), hi = __ldg(a.w_hi + gp);
    const float wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const float wh[4] = {hi.x, hi.y, hi.z, hi.w};
    const int in_plane = y * Z + z;
    const float* src_lo = gk2_s + ((x - xs) * L + in_plane) * FP;
    const float* src_hi =
        x + 1 < xs + sx
            ? src_lo + L * FP
            : cluster.map_shared_rank(gk2_s, rank + 1) + in_plane * FP;
    const int offs[4] = {0, 1, Z, Z + 1};   // in cells; 2D: slots 0, 1
    for (int q = sub; q < FQ; q += a.group) {
      float4 vlo[kNV], vhi[kNV];
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        vlo[j] = *reinterpret_cast<const float4*>(src_lo + offs[j] * FP +
                                                  4 * q);
        vhi[j] = *reinterpret_cast<const float4*>(src_hi + offs[j] * FP +
                                                  4 * q);
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = __fmaf_rn(wl[j], lane4(vlo[j], e), acc[e]);
#pragma unroll
      for (int j = 0; j < kNV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = __fmaf_rn(wh[j], lane4(vhi[j], e), acc[e]);
      if (VEC) {
        *reinterpret_cast<float4*>(a.pts + gp * F + 4 * q) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        for (int e = 0; e < 4 && 4 * q + e < F; ++e)
          a.pts[gp * F + 4 * q + e] = acc[e];
      }
    }
  });
  cluster.sync();   // no slab goes away while another CTA reads it
}

// The cluster path's shape at cluster size C: slab planes, padded extents
// and shared-memory bytes; false where a CTA would own no plane.
struct ClusterShape {
  int SX, PX, PY, PZ, FP, QS;
  int64_t smem;
};

bool cluster_shape(int X, int Y, int Z, int dim, int F, int C, int threads,
                   ClusterShape& s) {
  const int taps = dim == 3 ? 27 : 9;
  s.FP = (F + 3) / 4 * 4;
  s.SX = (X + C - 1) / C;
  if ((int64_t)(C - 1) * s.SX >= X) return false;
  if (dim == 3) {
    s.PX = s.SX + 2;
    s.PY = (Y + kRun - 1) / kRun * kRun + 2;
    s.PZ = Z + 2;
  } else {
    s.PX = (s.SX + kRun - 1) / kRun * kRun + 2;
    s.PY = Y + 2;
    s.PZ = 1;
  }
  s.QS = s.PX * s.PY * s.PZ * 4;   // words a feature quad
  s.smem = 4 * ((int64_t)taps * s.FP * s.FP + (int64_t)s.FP / 4 * s.QS +
                (int64_t)s.SX * Y * Z * s.FP + kScan * threads);
  return true;
}

// Conv items (a run of kRun cells x FO output channels) of a full slab.
int64_t conv_items(int Y, int Z, int dim, int F, const ClusterShape& s) {
  const int fo = s.FP % 8 == 0 ? 8 : 4;
  const int64_t per_fo = dim == 3
      ? (int64_t)s.SX * ((Y + kRun - 1) / kRun) * Z
      : (int64_t)((s.SX + kRun - 1) / kRun) * Y;
  return (int64_t)(s.FP / fo) * per_fo;
}

// fused_block_plan's choice, recomputed: -> the cluster size (0 where none
// fits: the device-memory path) and the CTA's threads.  Of the cluster
// sizes whose slabs fit and whose launch has kFillCtas CTAs: the smallest
// whose CTA fits twice in an SM's shared memory and still gives each of
// its threads (kClusterThreads, or half as many) a conv item, of at most
// kPortableCluster CTAs (two CTAs a SM overlap one's splat and slice with
// the other's conv; 16 halve the slabs of the classifier's grids, and
// each CTA scans every point of the row), else the
// smallest with kClusterThreads (each CTA zeroes its slab, stages the
// whole weights and scans every point of the row, so fewer CTAs a row
// cost less).  Where no launch has kFillCtas CTAs, the largest that fits.
int choose_cluster(int R, int X, int Y, int Z, int dim, int F, int& threads) {
  int largest = 0, smallest = 0;
  threads = kClusterThreads;
  for (int C = 1; C <= kMaxCluster && C <= X; C *= 2) {
    ClusterShape s;
    if (!cluster_shape(X, Y, Z, dim, F, C, kClusterThreads, s) ||
        s.smem > (int64_t)kMaxSmem)
      continue;
    largest = C;
    if ((int64_t)R * C < kFillCtas) continue;
    if (smallest == 0) smallest = C;
    for (int t = kClusterThreads; C <= kPortableCluster &&
                                  t >= kClusterThreads / 2; t /= 2) {
      cluster_shape(X, Y, Z, dim, F, C, t, s);
      if (2 * (s.smem + kCtaReserve) <= (int64_t)kSmPerSm &&
          conv_items(Y, Z, dim, F, s) >= t) {
        threads = t;
        return C;
      }
    }
  }
  return smallest ? smallest : largest;
}

template <int DIM, int kFP>
int launch_cluster_t(const ClusterArgs& a, int R, int threads, int smem,
                     cudaStream_t stream) {
  auto kernel = fused_cluster_kernel<DIM, kFP>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0 && a.C > 8)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * a.C));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  return err != 0 ? err : (int)cudaGetLastError();
}

int launch_cluster(const ClusterArgs& a, int R, int dim, int threads,
                   int smem, cudaStream_t stream) {
#define CT_FUSED(KF)                                                    \
  return dim == 3 ? launch_cluster_t<3, KF>(a, R, threads, smem, stream) \
                  : launch_cluster_t<2, KF>(a, R, threads, smem, stream)
  switch (a.F) {
    case 4: CT_FUSED(4);
    case 8: CT_FUSED(8);
    case 16: CT_FUSED(16);
    case 32: CT_FUSED(32);
    default: CT_FUSED(0);
  }
#undef CT_FUSED
}

template <int DZ>
int launch_global(const int* x0, const int* lane0, const float* w_lo,
                  const float* w_hi, const float* values, const float* weight,
                  const float* bias, float* pts, float* gk, float* gk2, int R,
                  int H, int K, int F, int X, int Y, int Z, int want_gk2,
                  void* stream) {
  const size_t w_bytes = (size_t)9 * DZ * F * F * sizeof(float);
  const size_t g_bytes = (size_t)X * Y * Z * F * sizeof(float);
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

// Shared memory of the device-memory path: the weights, and gk (then gk2)
// where they fit beside them.
int64_t global_smem(int X, int Y, int Z, int dim, int F) {
  const int64_t w = (int64_t)(dim == 3 ? 27 : 9) * F * F * 4;
  const int64_t g = (int64_t)X * Y * Z * F * 4;
  const int64_t limit = (int64_t)kMaxSmem;
  return w + (w + g <= limit) * g + (w + 2 * g <= limit) * g;
}

// Lanes that hold one point's feature quads in the slice: the next power
// of two >= the quads, at most 8 (as slice_plan's).
int quad_group(int F) {
  const int quads = (F + 3) / 4;
  int group = 1;
  while (group < quads && group < 8) group <<= 1;
  return group;
}

}  // namespace

// Plain C entry point for ctypes: launches on the given stream, does not
// synchronise, and returns the launch's error (0 = launched).  The
// integers come as one host array p (FUSED_PARAMS in
// ops/pallas_fused_block.py): R, H, K, F, X, Y, Z, dim, want_gk2, then
// fused_block_plan's cluster (0: the device-memory path), slab planes,
// threads, shared memory bytes, blocks and the slice's lanes a point.
// The entry point recomputes the plan and launches nothing where one of
// them disagrees, where an index would reach 2^31, where F > 32, or where
// float4 access (F % 4 == 0; the vertex weights always) is asked of an
// array that is not 16-byte aligned.  ``gk2`` is [R, G, F]: the output
// with want_gk2; on the device-memory path also scratch, and then always
// needed.  ``dim`` is 2 (Z = 1) or 3.
extern "C" int ct_fused_block(const int* x0, const int* lane0,
                              const float* w_lo, const float* w_hi,
                              const float* values, const float* weight,
                              const float* bias, float* pts, float* gk,
                              float* gk2, const int* p, void* stream) {
  const int R = p[0], H = p[1], K = p[2], F = p[3], X = p[4], Y = p[5],
            Z = p[6], dim = p[7], want_gk2 = p[8], C = p[9], SX = p[10],
            threads = p[11], smem = p[12], blocks = p[13], group = p[14];
  const int bad = (int)cudaErrorInvalidValue;
  if (R <= 0 || K < 0 || F <= 0) return 0;
  const int64_t limit = (int64_t)1 << 31;
  if ((dim != 2 && dim != 3) || (dim == 2 && Z != 1) || F > 32 || H <= 0 ||
      R % H != 0 || X < 2 || Y < 2 || Z < 1 ||
      (int64_t)R * K * F >= limit || (int64_t)R * X * Y * Z * F >= limit ||
      (want_gk2 != 0 && want_gk2 != 1))
    return bad;
  const bool vec = F % 4 == 0;
  const uintptr_t rows = (uintptr_t)values | (uintptr_t)pts | (uintptr_t)gk |
                         (uintptr_t)(want_gk2 ? gk2 : nullptr);
  if (((uintptr_t)w_lo | (uintptr_t)w_hi) % 16 != 0 ||
      (vec && rows % 16 != 0))
    return bad;
  int expect_threads;
  if (C != choose_cluster(R, X, Y, Z, dim, F, expect_threads)) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 0) {
    if (SX != X || threads != kThreads || blocks != R || group != 1 ||
        smem != global_smem(X, Y, Z, dim, F) || gk2 == nullptr)
      return bad;
    if (dim == 2)
      return launch_global<1>(x0, lane0, w_lo, w_hi, values, weight, bias,
                              pts, gk, gk2, R, H, K, F, X, Y, 1, want_gk2, s);
    return launch_global<3>(x0, lane0, w_lo, w_hi, values, weight, bias, pts,
                            gk, gk2, R, H, K, F, X, Y, Z, want_gk2, s);
  }
  ClusterShape sh;
  cluster_shape(X, Y, Z, dim, F, C, expect_threads, sh);
  if (SX != sh.SX || threads != expect_threads || smem != sh.smem ||
      blocks != R * C || group != quad_group(F))
    return bad;
  const ClusterArgs a{x0, lane0, reinterpret_cast<const float4*>(w_lo),
                      reinterpret_cast<const float4*>(w_hi), values, weight,
                      bias, pts, gk, gk2, H, K, F, X, Y, Z, want_gk2, C,
                      sh.SX, sh.PX, sh.PY, sh.PZ, sh.FP,
                      sh.QS, group};
  return launch_cluster(a, R, dim, threads, smem, s);
}
