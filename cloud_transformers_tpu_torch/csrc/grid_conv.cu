// Grouped 'same' 3x3x3 (3D) and 3x3 (2D) convolutions + bias on flat grids
// [R, X, Y(, Z), F] (F contiguous), where row r belongs to head r % H and
// every head has its own F x F tap kernels, and their weight gradients.
// Float32 on the CUDA cores throughout: TF32 would miss the port's 1e-5
// parity with the plain versions.  Both pairs share one design: a tile of
// the grid with its one-cell halo in shared memory (zeros where the halo
// leaves the grid), register tiles that make each shared-memory load feed
// many FMAs, and for the weight gradient blocks over (batch member, tile)
// units with a fixed-order second pass.  F is a template parameter for
// F = 4, 8, 16 and 32 (loops unrolled, 16-byte loads); F = 0 is the variant
// that takes any F from 1 to 32 at run time, with the channels padded to a
// multiple of 4 in shared memory.  Tile sizes, threads, shared memory and
// blocks come from the caller (conv3d_tiling and conv2d_tiling in
// ops/pallas_grid_conv.py); the entry points recompute threads and shared
// memory and refuse a launch whose numbers disagree.
//
// --- 3D: grid_conv3d_fwd_kernel<F>, grid_conv3d_dw_kernel<F> + sum --------
//
// Replace cloud_transformers_tpu/ops/pallas_grid_conv.py: pallas_grid_conv,
// which builds an im2col of three x slabs in VMEM and does one MXU matmul per
// x row, and pallas_grid_conv_dw, which multiplies that im2col with the
// cotangent and carries the sum over a head's batch members from one grid
// step to the next.  Those layouts are not copied.
//
// Bound on this card at R = 128: bytes at 32^3 x 4 (the two grids, 134 MB,
// 40 us at 3.35 TB/s; its 3.4 GFLOP take 51 us, so operations edge it),
// float32 operations at 16^3 x 16 (6.4 GFLOP over the taps inside the grid,
// 95 us at 67 TFLOP/s) and at 8^3 x 32 (2.8 GFLOP, 42 us).  What held the
// first kernels back (one thread per output, 27 F^2 weights staged by every
// block of 256 threads, one L1 load per FMA) was loads: about 0.9 GB of
// weight staging per call.
//
// Forward: a small kernel first packs the head's weights by chunks of four
// input channels, [h][chunk][tap][4][F padded to 4] (zeros past F).  Then one
// block per (row r, TX x TY x TZ tile of output cells; TX = 4) walks the
// input channels four at a time.  For each chunk it stages the chunk's
// weights (108 * FP floats) and the halo tile [TX + 2][TY + 2][ZS] of float4
// with cp.async, double-buffered: the next chunk is in flight while this one
// is used, and the weights and halo of any F fit (8^3 x 32: 39 KB a block,
// not the 110.6 KB of weights alone).  Weights staged per call: 7, 28 and
// 57 MB at 32^3 x 4, 16^3 x 16 and 8^3 x 32 (about 0.9 GB before).  The
// staging loops divide by the tile's extents with FastDiv (a multiply-high;
// a divide instruction sequence cost more than the copies it addressed).
// Threads form F / FO groups of output
// channels, a warp inside one group; thread (x run, y, z) of a group keeps 4
// cells along x times FO output channels in registers (FO = 8, or F when
// F < 8; 4 at run-time F).  Per (dy, dz) it loads 6 float4 of the halo (4
// channels of 6 cells along x) once for the three dx taps, and per (tap,
// channel) its FO weights as float4 broadcasts: 30 shared loads feed 384
// FMAs at F >= 8.  Threads of a warp run along z, so a quarter warp's float4
// loads are 8 consecutive cells; ZS >= TZ + 2 is chosen by the caller so
// that they fall in distinct banks where TZ < 8.  The bias is added in the
// epilogue, which stores float4 runs of fo.  Tiles are cut to the grid and
// halved until the card holds about two blocks per SM (16^3 x 16: 4 x 8 x
// 16, 1024 blocks; 8^3 x 32: 4 x 4 x 8, 512 blocks).
//
// Weight gradient: dW[h][fo][(fi, tap)] = sum over cells of g[cell][fo] *
// in[cell + tap][fi] is a product of [F] x [27F] reduced over B * X * Y * Z
// cells per head.  Block (j, h, slice) takes the units (batch member, tile)
// j, j + NB, ... of head h and the slice's input channels (all of them up to
// F = 20; 8 of 32 at F = 32, so that a block keeps at most 256 threads);
// per unit it stages the cotangent tile [TX][TY][GZ][FP] and the input halo
// tile [TX + 2][TY + 2][ZS][slice] with cp.async, the next unit in flight
// while this one is used.  Thread (s, q) keeps a register tile of 4 fo x 4
// fi x 3 dz taps for one (dx, dy) (48 sums) over the (x, y) rows s, s + S,
// ... of each unit's tile, walking each row along z: the three dz taps
// slide along the row, so per cell it loads one float4 of g and one new
// float4 of the input for 48 FMAs.  Where a warp holds several splits (F <=
// 4) the split runs fastest, and GZ and ZS are padded so that a quarter
// warp's 8 rows fall in distinct banks.  The S splits meet in shared memory
// in a fixed order and the block writes its
// part of one scratch row [F][F][27]; a second pass adds the NB rows of each
// head in a fixed order into the parameter layout [H*F (out), F (in), 3, 3,
// 3].  No atomics: the result is the same in every run.  Scratch is NB * H *
// 27 * F * F floats (NB chosen for about three blocks per SM: 10.6 MB at
// 16^3 x 16, 12.4 MB at 8^3 x 32, where one row per (batch member, x plane)
// took 57 and 113 MB).
//
// --- 2D: conv2d_fwd_kernel<F>, conv2d_dw_kernel<F> + conv2d_dw_sum_kernel --
//
// Replace pallas_grid_conv2d and pallas_grid_conv2d_dm, which multiply
// banded tap matrices (pack_m2d, for the MXU) with lane-rolled copies of the
// grid.  Those layouts are not copied.  Both are bound by float32
// operations on this card (9 * F * F MACs per in-grid cell: 2.4 GFLOP for
// 64^2 x 16 at R = 128, 36 us at 67 TFLOP/s) except at F = 4, where the
// bytes bound (the two grids, 67 MB at 128^2 x 4, 20 us).
//
// Forward: one block per (row r, TX x TY tile of output cells).  It stages
// the head's weights as [tap][fi][fo] (fo padded to a multiple of 4) and the
// halo as [fi][TX + 2][YS], y contiguous; YS >= TY + 2 is chosen by the
// caller so that a warp's input loads fall in distinct banks.  The threads
// form F / FO groups of output channels, a warp inside one group; thread
// (x run, y) of a group keeps 4 cells along x times FO output channels in
// registers (FO as in 3D).  Per (fi, dy) it loads 6 input words once for
// the three dx taps, and per tap its FO weights as float4 broadcasts: at
// F = 16, 12 shared loads feed 96 FMAs.  The bias is added in the epilogue,
// which stores float4 runs of fo.  Small grids get smaller tiles so that
// the card holds about two blocks per SM (16^2 x 16 at R = 128: 8 x 8
// tiles, 512 blocks).
//
// Weight gradient: as in 3D with 9 taps and the whole F in every block:
// thread (s, q) keeps 4 fo x 4 fi x 3 dy taps for one dx; per unit the
// block stages the cotangent and input halo tiles as [cell][F] with plain
// loads.  Scratch is NB * H * F * F * 9 floats (about 3.5 MB at 64^2 x 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

// --- 2D kernels -------------------------------------------------------------

constexpr int kCX = 4;         // output cells a forward thread keeps along x
constexpr int kDwSums = 48;    // sums a weight-gradient thread keeps
constexpr int kDwThreads = 256;

__host__ __device__ constexpr int round4(int f) { return (f + 3) & ~3; }

// output channels a forward thread keeps; kF = 0: F at run time
template <int kF>
struct Conv2dFO {
  static constexpr int value = kF == 0 ? 4 : (kF < 8 ? kF : 8);
};

template <int kF>
__global__ void __launch_bounds__(512)
conv2d_fwd_kernel(const float* __restrict__ in,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int H, int X, int Y, int f_rt, int TX, int TY, int YS) {
  constexpr int FO = Conv2dFO<kF>::value;
  const int F = kF ? kF : f_rt;
  const int FP = round4(F);
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                 // [tap][fi][FP], fo padded with zeros
  float* in_s = smem + 9 * F * FP;   // [fi][TX + 2][YS]
  const int r = blockIdx.y;
  const int h = r % H;
  const int tiles_y = (Y + TY - 1) / TY;
  const int x0 = (blockIdx.x / tiles_y) * TX;
  const int y0 = (blockIdx.x % tiles_y) * TY;

  // weights: read in the parameter layout [fo][fi][tap] (coalesced)
  const float* w_h = weight + (size_t)h * F * F * 9;
  for (int i = threadIdx.x; i < F * F * 9; i += blockDim.x) {
    const int tap = i % 9;
    const int fi = (i / 9) % F;
    const int fo = i / (9 * F);
    w_s[(tap * F + fi) * FP + fo] = w_h[i];
  }
  if (FP != F) {
    for (int i = threadIdx.x; i < 9 * F * 4; i += blockDim.x)
      if (F + i % 4 < FP) w_s[(i / 4) * FP + F + i % 4] = 0.0f;
  }
  // the input halo, zeros outside the grid
  const int HX = TX + 2, HY = TY + 2, PS = HX * YS;
  const float* in_r = in + (size_t)r * X * Y * F;
  if (kF % 4 == 0 && kF != 0) {
    const int nq = F / 4;
    for (int i = threadIdx.x; i < HX * HY * nq; i += blockDim.x) {
      const int q = i % nq;
      const int c = i / nq;
      const int hx = c / HY, hy = c % HY;
      const int gx = x0 - 1 + hx, gy = y0 - 1 + hy;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y)
        v = *reinterpret_cast<const float4*>(
            in_r + ((size_t)gx * Y + gy) * F + 4 * q);
      float* dst = in_s + 4 * q * PS + hx * YS + hy;
      dst[0] = v.x;
      dst[PS] = v.y;
      dst[2 * PS] = v.z;
      dst[3 * PS] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < HX * HY * F; i += blockDim.x) {
      const int fi = i % F;
      const int c = i / F;
      const int hx = c / HY, hy = c % HY;
      const int gx = x0 - 1 + hx, gy = y0 - 1 + hy;
      in_s[fi * PS + hx * YS + hy] =
          (gx >= 0 && gx < X && gy >= 0 && gy < Y)
              ? in_r[((size_t)gx * Y + gy) * F + fi] : 0.0f;
    }
  }
  __syncthreads();

  // thread (group, x run, y): cells (x0 + xr * kCX + j, y0 + ly), j < kCX,
  // output channels fo0 .. fo0 + FO - 1
  const int per_group = (TX / kCX) * TY;
  const int t = threadIdx.x % per_group;
  const int fo0 = (threadIdx.x / per_group) * FO;
  const int ly = t % TY, xr = t / TY;
  float acc[kCX][FO];
#pragma unroll
  for (int j = 0; j < kCX; ++j)
#pragma unroll
    for (int o = 0; o < FO; ++o) acc[j][o] = 0.0f;

#pragma unroll 2
  for (int fi = 0; fi < F; ++fi) {
    const float* src = in_s + fi * PS + xr * kCX * YS + ly;
    const float* w_fi = w_s + fi * FP + fo0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float v[kCX + 2];
#pragma unroll
      for (int j = 0; j < kCX + 2; ++j) v[j] = src[j * YS + dy];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wp = w_fi + (dx * 3 + dy) * F * FP;
        float w[FO];
#pragma unroll
        for (int o = 0; o < FO; o += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wp + o);
          w[o] = w4.x;
          w[o + 1] = w4.y;
          w[o + 2] = w4.z;
          w[o + 3] = w4.w;
        }
#pragma unroll
        for (int j = 0; j < kCX; ++j)
#pragma unroll
          for (int o = 0; o < FO; ++o)
            acc[j][o] = fmaf(v[j + dx], w[o], acc[j][o]);
      }
    }
  }

  const int y = y0 + ly;
  if (y >= Y) return;
  float b[FO];
#pragma unroll
  for (int o = 0; o < FO; ++o)
    b[o] = fo0 + o < F ? bias[h * F + fo0 + o] : 0.0f;
#pragma unroll
  for (int j = 0; j < kCX; ++j) {
    const int x = x0 + xr * kCX + j;
    if (x >= X) break;
    float* dst = out + ((size_t)r * X * Y + (size_t)x * Y + y) * F + fo0;
    if (kF != 0) {
#pragma unroll
      for (int o = 0; o < FO; o += 4)
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[j][o] + b[o], acc[j][o + 1] + b[o + 1],
                        acc[j][o + 2] + b[o + 2], acc[j][o + 3] + b[o + 3]);
    } else {
#pragma unroll
      for (int o = 0; o < FO; ++o)
        if (fo0 + o < F) dst[o] = acc[j][o] + b[o];
    }
  }
}

template <int kF>
__global__ void __launch_bounds__(kDwThreads)
conv2d_dw_kernel(const float* __restrict__ in, const float* __restrict__ g,
                 float* __restrict__ partial, int H, int B, int X, int Y,
                 int f_rt, int TX, int TY, int NB, int S) {
  const int F = kF ? kF : f_rt;
  const int FP = round4(F);
  const int NA = FP / 4;
  const int NQ = NA * NA * 3;
  extern __shared__ __align__(16) float smem[];
  const int n_cells = TX * TY;
  const int HY = TY + 2;
  const int n_halo = (TX + 2) * HY;
  float* g_s = smem;                    // [TX * TY][FP]
  float* in_s = smem + n_cells * FP;    // [(TX + 2) * (TY + 2)][FP]
  const int h = blockIdx.y;
  const int j = blockIdx.x;
  // thread (s, q): q = (dx, fi quad c, fo quad a), a fastest
  const int q = threadIdx.x % NQ;
  const int s = threadIdx.x / NQ;
  const int a = q % NA;
  const int c = (q / NA) % NA;
  const int dx = q / (NA * NA);
  const int tiles_y = (Y + TY - 1) / TY;
  const int tiles = ((X + TX - 1) / TX) * tiles_y;
  const int units = B * tiles;

  float acc[3][4][4];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[dy][i][k] = 0.0f;

  for (int u = j; u < units; u += NB) {
    const int t = u % tiles;
    const int x0 = (t / tiles_y) * TX, y0 = (t % tiles_y) * TY;
    const size_t row = (size_t)((u / tiles) * H + h) * X * Y;
    __syncthreads();  // the previous unit's reads are done
    for (int i = threadIdx.x; i < (n_cells + n_halo) * NA; i += blockDim.x) {
      const int qq = i % NA;
      const int cell = i / NA;
      const float* src;
      float* dst;
      int gx, gy;
      if (cell < n_cells) {
        gx = x0 + cell / TY;
        gy = y0 + cell % TY;
        src = g;
        dst = g_s + cell * FP + 4 * qq;
      } else {
        const int hc = cell - n_cells;
        gx = x0 - 1 + hc / HY;
        gy = y0 - 1 + hc % HY;
        src = in;
        dst = in_s + hc * FP + 4 * qq;
      }
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y) {
        const float* p = src + (row + (size_t)gx * Y + gy) * F + 4 * qq;
        if (kF % 4 == 0 && kF != 0) {
          v = *reinterpret_cast<const float4*>(p);
        } else {
          const int left = F - 4 * qq;
          v.x = p[0];
          if (left > 1) v.y = p[1];
          if (left > 2) v.z = p[2];
          if (left > 3) v.w = p[3];
        }
      }
      *reinterpret_cast<float4*>(dst) = v;
    }
    __syncthreads();
    for (int cell = s; cell < n_cells; cell += S) {
      const int lx = cell / TY, ly = cell % TY;
      const float4 gv =
          *reinterpret_cast<const float4*>(g_s + cell * FP + 4 * a);
      const float* ip = in_s + ((lx + dx) * HY + ly) * FP + 4 * c;
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4 iv = *reinterpret_cast<const float4*>(ip + dy * FP);
        const float ir[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[dy][i][k] = fmaf(gr[i], ir[k], acc[dy][i][k]);
      }
    }
  }

  // the S splits meet in shared memory and are added in a fixed order
  __syncthreads();
  float* red = smem;  // [S][NQ][kDwSums]
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[(s * NQ + q) * kDwSums + (dy * 4 + i) * 4 + k] = acc[dy][i][k];
  __syncthreads();
  // partial[j][h][fo][fi][tap], tap = dx * 3 + dy
  float* dst = partial + ((size_t)j * H + h) * F * F * 9;
  for (int o = threadIdx.x; o < NQ * kDwSums; o += blockDim.x) {
    float sum = 0.0f;
    for (int ss = 0; ss < S; ++ss) sum += red[ss * NQ * kDwSums + o];
    const int qq = o / kDwSums, e = o % kDwSums;
    const int fo = 4 * (qq % NA) + (e / 4) % 4;
    const int fi = 4 * ((qq / NA) % NA) + e % 4;
    const int tap = (qq / (NA * NA)) * 3 + e / 16;
    if (fo < F && fi < F) dst[(fo * F + fi) * 9 + tap] = sum;
  }
}

// the weight gradient's second pass: per weight, a head's NB scratch rows
// added in order
__global__ void conv2d_dw_sum_kernel(const float* __restrict__ partial,
                                     float* __restrict__ d_weight, int NB,
                                     int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < NB; ++c) sum += partial[(size_t)c * n_out + o];
  d_weight[o] = sum;
}

// --- 3D kernels -------------------------------------------------------------

// 16-byte asynchronous copy device memory -> shared memory; with ``full``
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Four channels c4 .. c4 + 3 of one cell, zeros past F (run-time F: no
// alignment to 16 bytes).
__device__ __forceinline__ float4 load4_tail(const float* p, int left) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (left > 0) v.x = p[0];
  if (left > 1) v.y = p[1];
  if (left > 2) v.z = p[2];
  if (left > 3) v.w = p[3];
  return v;
}

// Division by a block-uniform d without a divide instruction: exact for
// n * d < 2^32 (the staging loops' indices are below 2^20, d below 2^12).
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int divisor)
      : d((unsigned)divisor),
        m(divisor > 1
              ? (unsigned)((((unsigned long long)1 << 32) + divisor - 1)
                           / divisor)
              : 0u) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)__umulhi((unsigned)n, m);
  }
};

// The head's weights in the forward's chunk layout: wpack[h][c][tap][k][FP]
// = weight[h * F + fo][4 * c + k][tap], zeros where fo or fi >= F, so that
// a chunk of four input channels is one contiguous run of 108 * FP floats.
__global__ void grid_conv3d_pack_kernel(const float* __restrict__ weight,
                                        float* __restrict__ wpack, int H,
                                        int F) {
  const int FP = round4(F);
  const int n = H * 27 * FP * FP;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int fo = i % FP;
  const int k = (i / FP) % 4;
  const int tap = (i / (4 * FP)) % 27;
  const int c = (i / (108 * FP)) % (FP / 4);
  const int h = i / (27 * FP * FP);
  const int fi = 4 * c + k;
  wpack[i] = (fo < F && fi < F)
                 ? weight[((size_t)(h * F + fo) * F + fi) * 27 + tap] : 0.0f;
}

template <int kF>
__global__ void __launch_bounds__(256, 2)
grid_conv3d_fwd_kernel(const float* __restrict__ in,
                       const float* __restrict__ wpack,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int H, int X, int Y, int Z,
                       int f_rt, int TX, int TY, int TZ, int ZS) {
  constexpr int FO = Conv2dFO<kF>::value;
  constexpr bool kVec = kF != 0 && kF % 4 == 0;
  const int F = kF ? kF : f_rt;
  const int FP = round4(F);
  const int NC = FP / 4;
  const int HY = TY + 2, HZ = TZ + 2;
  const int n_halo = (TX + 2) * HY * HZ;
  const int w_len = 108 * FP;                      // [tap][k][FP]
  const int stage_len = w_len + (TX + 2) * HY * ZS * 4;
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.y;
  const int h = r % H;
  const int tiles_z = (Z + TZ - 1) / TZ, tiles_y = (Y + TY - 1) / TY;
  const int z0 = (blockIdx.x % tiles_z) * TZ;
  const int y0 = ((blockIdx.x / tiles_z) % tiles_y) * TY;
  const int x0 = (blockIdx.x / (tiles_z * tiles_y)) * TX;
  const float* in_r = in + (size_t)r * X * Y * Z * F;
  const float* w_h = wpack + (size_t)h * NC * w_len;

  // chunk c (input channels 4c .. 4c + 3) into buffer ``buf``: its weights
  // and the halo tile [TX + 2][TY + 2][ZS] of float4, zeros outside the grid
  const FastDiv by_hz(HZ), by_hy(HY);
  auto stage = [&](int c, float* buf) {
    const float* w_c = w_h + (size_t)c * w_len;
    for (int i = threadIdx.x; i < w_len / 4; i += blockDim.x)
      cp_async16(buf + 4 * i, w_c + 4 * i, true);
    float* halo = buf + w_len;
    for (int i = threadIdx.x; i < n_halo; i += blockDim.x) {
      const int hxy = by_hz.div(i), hz = i - hxy * HZ;
      const int hx = by_hy.div(hxy), hy = hxy - hx * HY;
      const int gx = x0 - 1 + hx, gy = y0 - 1 + hy, gz = z0 - 1 + hz;
      const bool inside = gx >= 0 && gx < X && gy >= 0 && gy < Y &&
                          gz >= 0 && gz < Z;
      float* dst = halo + (hxy * ZS + hz) * 4;
      const size_t off =
          inside ? (((size_t)gx * Y + gy) * Z + gz) * F + 4 * c : 0;
      if (kVec) {
        cp_async16(dst, in_r + off, inside);
      } else {
        *reinterpret_cast<float4*>(dst) =
            inside ? load4_tail(in_r + off, F - 4 * c)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cp_async_commit();
  };

  // thread (fo group, x run, y, z): cells (x0 + xr * kCX + j, y0 + ly,
  // z0 + lz), j < kCX, output channels fo0 .. fo0 + FO - 1
  const int per_group = (TX / kCX) * TY * TZ;
  const int t = threadIdx.x % per_group;
  const int fo0 = (threadIdx.x / per_group) * FO;
  const int lz = t % TZ, ly = (t / TZ) % TY, xr = t / (TZ * TY);
  float acc[kCX][FO];
#pragma unroll
  for (int j = 0; j < kCX; ++j)
#pragma unroll
    for (int o = 0; o < FO; ++o) acc[j][o] = 0.0f;

  stage(0, smem);
  for (int c = 0; c < NC; ++c) {
    // the next chunk is copied while this one is used
    if (c + 1 < NC) {
      stage(c + 1, smem + ((c + 1) & 1) * stage_len);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* w_s = smem + (c & 1) * stage_len;
    const float* src = w_s + w_len + ((xr * kCX * HY + ly) * ZS + lz) * 4;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        float4 v[kCX + 2];
#pragma unroll
        for (int j = 0; j < kCX + 2; ++j)
          v[j] = *reinterpret_cast<const float4*>(
              src + ((j * HY + dy) * ZS + dz) * 4);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = w_s + ((dx * 3 + dy) * 3 + dz) * 4 * FP + fo0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float w[FO];
#pragma unroll
            for (int o = 0; o < FO; o += 4) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(wp + k * FP + o);
              w[o] = w4.x;
              w[o + 1] = w4.y;
              w[o + 2] = w4.z;
              w[o + 3] = w4.w;
            }
#pragma unroll
            for (int j = 0; j < kCX; ++j) {
              const float a = lane4(v[j + dx], k);
#pragma unroll
              for (int o = 0; o < FO; ++o)
                acc[j][o] = fmaf(a, w[o], acc[j][o]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks on
  }

  const int y = y0 + ly, z = z0 + lz;
  if (y >= Y || z >= Z) return;
  float b[FO];
#pragma unroll
  for (int o = 0; o < FO; ++o)
    b[o] = fo0 + o < F ? bias[h * F + fo0 + o] : 0.0f;
#pragma unroll
  for (int j = 0; j < kCX; ++j) {
    const int x = x0 + xr * kCX + j;
    if (x >= X) break;
    float* dst = out + ((((size_t)r * X + x) * Y + y) * Z + z) * F + fo0;
    if (kF != 0) {
#pragma unroll
      for (int o = 0; o < FO; o += 4)
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[j][o] + b[o], acc[j][o + 1] + b[o + 1],
                        acc[j][o + 2] + b[o + 2], acc[j][o + 3] + b[o + 3]);
    } else {
#pragma unroll
      for (int o = 0; o < FO; ++o)
        if (fo0 + o < F) dst[o] = acc[j][o] + b[o];
    }
  }
}

template <int kF>
__global__ void __launch_bounds__(kDwThreads)
grid_conv3d_dw_kernel(const float* __restrict__ in,
                      const float* __restrict__ g,
                      float* __restrict__ partial, int H, int B, int X,
                      int Y, int Z, int f_rt, int TX, int TY, int TZ, int ZS,
                      int GZ, int NCS, int NB, int S) {
  constexpr bool kVec = kF != 0 && kF % 4 == 0;
  const int F = kF ? kF : f_rt;
  const int FP = round4(F);
  const int NA = FP / 4;
  const int W = 4 * NCS;             // input channels of this block's slice
  const int NQ = 9 * NA * NCS;
  const int HY = TY + 2, HZ = TZ + 2;
  const int n_cells = TX * TY * TZ;
  const int n_halo = (TX + 2) * HY * HZ;
  const int stage_len = TX * TY * GZ * FP + (TX + 2) * HY * ZS * W;
  extern __shared__ __align__(16) float smem[];
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int fi0 = blockIdx.z * W;
  // thread (s, q): q = (dx, dy, fi quad c of the slice, fo quad a), a
  // fastest; it keeps 4 fo x 4 fi x 3 dz taps.  Where a warp holds several
  // splits (NQ < 32) the split runs fastest instead, S a multiple of 8, so
  // that a quarter warp reads 8 rows at one z.
  const int q = NQ < 32 ? threadIdx.x / S : threadIdx.x % NQ;
  const int s = NQ < 32 ? threadIdx.x % S : threadIdx.x / NQ;
  const int a = q % NA;
  const int c = (q / NA) % NCS;
  const int dx = q / (NA * NCS) / 3, dy = q / (NA * NCS) % 3;
  const int tiles_z = (Z + TZ - 1) / TZ, tiles_y = (Y + TY - 1) / TY;
  const int tiles = ((X + TX - 1) / TX) * tiles_y * tiles_z;
  const int units = B * tiles;

  // unit u = (batch member, tile): the cotangent tile [TX][TY][GZ][FP] and
  // the input halo tile [TX + 2][TY + 2][ZS][W] of the slice's channels
  const FastDiv by_na(NA), by_ncs(NCS), by_tz(TZ), by_ty(TY), by_hz(HZ),
      by_hy(HY);
  auto stage = [&](int u, float* buf) {
    const int t = u % tiles;
    const int z0 = (t % tiles_z) * TZ, y0 = ((t / tiles_z) % tiles_y) * TY;
    const int x0 = (t / (tiles_z * tiles_y)) * TX;
    const size_t row = (size_t)((u / tiles) * H + h) * X * Y * Z;
    for (int i = threadIdx.x; i < n_cells * NA; i += blockDim.x) {
      const int cell = by_na.div(i), qq = i - cell * NA;
      const int lxy = by_tz.div(cell), lz = cell - lxy * TZ;
      const int lx = by_ty.div(lxy);
      const int gx = x0 + lx, gy = y0 + lxy - lx * TY, gz = z0 + lz;
      const bool inside = gx < X && gy < Y && gz < Z;
      float* dst = buf + (lxy * GZ + lz) * FP + 4 * qq;
      const size_t off =
          inside ? (row + ((size_t)gx * Y + gy) * Z + gz) * F + 4 * qq : 0;
      if (kVec) {
        cp_async16(dst, g + off, inside);
      } else {
        *reinterpret_cast<float4*>(dst) =
            inside ? load4_tail(g + off, F - 4 * qq)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    float* halo = buf + TX * TY * GZ * FP;
    for (int i = threadIdx.x; i < n_halo * NCS; i += blockDim.x) {
      const int hc = by_ncs.div(i), qq = i - hc * NCS;
      const int hxy = by_hz.div(hc), hz = hc - hxy * HZ;
      const int hx = by_hy.div(hxy), hy = hxy - hx * HY;
      const int gx = x0 - 1 + hx, gy = y0 - 1 + hy, gz = z0 - 1 + hz;
      const bool inside = gx >= 0 && gx < X && gy >= 0 && gy < Y &&
                          gz >= 0 && gz < Z;
      float* dst = halo + (hxy * ZS + hz) * W + 4 * qq;
      const int ch = fi0 + 4 * qq;
      const size_t off =
          inside ? (row + ((size_t)gx * Y + gy) * Z + gz) * F + ch : 0;
      if (kVec) {
        cp_async16(dst, in + off, inside);
      } else {
        *reinterpret_cast<float4*>(dst) =
            inside ? load4_tail(in + off, F - ch)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cp_async_commit();
  };

  float acc[3][4][4];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[dz][i][k] = 0.0f;

  stage(j, smem);  // NB <= units: every block has a first unit
  int it = 0;
  for (int u = j; u < units; u += NB, ++it) {
    if (u + NB < units) {
      stage(u + NB, smem + ((it + 1) & 1) * stage_len);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* g_s = smem + (it & 1) * stage_len;
    const float* in_s = g_s + TX * TY * GZ * FP;
    // rows (x, y) s, s + S, ... of the tile, each walked along z: per cell
    // one float4 of g and one new float4 of the input (the three dz taps
    // slide along the row)
    for (int rr = s; rr < TX * TY; rr += S) {
      const float* gp = g_s + rr * GZ * FP + 4 * a;
      const float* ip = in_s +
          (((rr / TY + dx) * HY + rr % TY + dy) * ZS) * W + 4 * c;
      float4 i0 = *reinterpret_cast<const float4*>(ip);
      float4 i1 = *reinterpret_cast<const float4*>(ip + W);
      for (int lz = 0; lz < TZ; ++lz) {
        const float4 i2 =
            *reinterpret_cast<const float4*>(ip + (lz + 2) * W);
        const float4 gv = *reinterpret_cast<const float4*>(gp + lz * FP);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
        const float4 iv[3] = {i0, i1, i2};
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const float ir[4] = {iv[dz].x, iv[dz].y, iv[dz].z, iv[dz].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[dz][i][k] = fmaf(gr[i], ir[k], acc[dz][i][k]);
        }
        i0 = i1;
        i1 = i2;
      }
    }
    __syncthreads();  // this buffer is refilled two units on
  }

  // the S splits meet in shared memory and are added in a fixed order
  float* red = smem;  // [S][NQ][kDwSums]
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[(s * NQ + q) * kDwSums + (dz * 4 + i) * 4 + k] = acc[dz][i][k];
  __syncthreads();
  // partial[j][h][fo][fi][tap], tap = (dx * 3 + dy) * 3 + dz
  float* dst = partial + ((size_t)j * H + h) * F * F * 27;
  for (int o = threadIdx.x; o < NQ * kDwSums; o += blockDim.x) {
    float sum = 0.0f;
    for (int ss = 0; ss < S; ++ss) sum += red[ss * NQ * kDwSums + o];
    const int qq = o / kDwSums, e = o % kDwSums;
    const int fo = 4 * (qq % NA) + (e / 4) % 4;
    const int fi = fi0 + 4 * ((qq / NA) % NCS) + e % 4;
    const int tap = (qq / (NA * NCS)) * 3 + e / 16;
    if (fo < F && fi < F) dst[(fo * F + fi) * 27 + tap] = sum;
  }
}

// the 3D weight gradient's second pass: per weight, a head's NB scratch rows
// added in order
__global__ void grid_conv3d_dw_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ d_weight,
                                          int NB, int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < NB; ++c) sum += partial[(size_t)c * n_out + o];
  d_weight[o] = sum;
}

// Opt in to more than 48 KiB of dynamic shared memory where a launch needs
// it; returns the CUDA error of the request (0 = granted).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The 2D launches.  Threads and shared memory are recomputed here from the
// caller's tiling and must match it: a disagreement returns
// cudaErrorInvalidValue and launches nothing.

template <int kF>
int launch_conv2d_f(const float* in, const float* weight, const float* bias,
                    float* out, int R, int H, int X, int Y, int F, int TX,
                    int TY, int YS, int threads, int smem_bytes,
                    void* stream) {
  const int FP = round4(F);
  const int groups = FP / Conv2dFO<kF>::value;
  const int want_threads = (TX / kCX) * TY * groups;
  const size_t smem = (size_t)(9 * F * FP + F * (TX + 2) * YS) * sizeof(float);
  if (TX <= 0 || TX % kCX != 0 || TY <= 0 || YS < TY + 2 ||
      want_threads != threads || threads > 512 || (size_t)smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(conv2d_fwd_kernel<kF>, smem);
  if (err != 0) return err;
  dim3 grid((unsigned int)(((X + TX - 1) / TX) * ((Y + TY - 1) / TY)),
            (unsigned int)R);
  conv2d_fwd_kernel<kF><<<grid, threads, smem, (cudaStream_t)stream>>>(
      in, weight, bias, out, H, X, Y, F, TX, TY, YS);
  return (int)cudaGetLastError();
}

template <int kF>
int launch_conv2d_dw_f(const float* in, const float* g, float* partial,
                       float* d_weight, int R, int H, int X, int Y, int F,
                       int TX, int TY, int NB, int threads, int smem_bytes,
                       void* stream) {
  const int FP = round4(F);
  const int NQ = (FP / 4) * (FP / 4) * 3;
  const int S = threads / NQ;
  const size_t stage = (size_t)(TX * TY + (TX + 2) * (TY + 2)) * FP;
  const size_t red = (size_t)threads * kDwSums;
  const size_t smem = (stage > red ? stage : red) * sizeof(float);
  const int tiles = ((X + TX - 1) / TX) * ((Y + TY - 1) / TY);
  if (TX <= 0 || TY <= 0 || S < 1 || S * NQ != threads ||
      threads > kDwThreads || (size_t)smem_bytes != smem || NB < 1 ||
      NB > (R / H) * tiles)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem(conv2d_dw_kernel<kF>, smem);
  if (err != 0) return err;
  conv2d_dw_kernel<kF><<<dim3((unsigned int)NB, (unsigned int)H), threads,
                         smem, (cudaStream_t)stream>>>(
      in, g, partial, H, R / H, X, Y, F, TX, TY, NB, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_out = H * F * F * 9;
  conv2d_dw_sum_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(partial, d_weight, NB, n_out);
  return (int)cudaGetLastError();
}


// The 3D launches, on the caller's tiling (conv3d_tiling).  As for 2D,
// threads and shared memory are recomputed here and must match; a
// disagreement returns cudaErrorInvalidValue and launches nothing.

template <int kF>
int launch_conv3d_f(const float* in, const float* weight, const float* bias,
                    float* out, float* wpack, int R, int H, int X, int Y,
                    int Z, int F, int TX, int TY, int TZ, int ZS,
                    int threads, int smem_bytes, void* stream) {
  const int FP = round4(F);
  const int groups = FP / Conv2dFO<kF>::value;
  const int want_threads = (TX / kCX) * TY * TZ * groups;
  const size_t smem =
      (size_t)2 * (108 * FP + (TX + 2) * (TY + 2) * ZS * 4) * sizeof(float);
  if (TX <= 0 || TX % kCX != 0 || TY <= 0 || TZ <= 0 || ZS < TZ + 2 ||
      want_threads != threads || threads > 256 || (size_t)smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem(grid_conv3d_fwd_kernel<kF>, smem);
  if (err != 0) return err;
  const int n_pack = H * 27 * FP * FP;
  grid_conv3d_pack_kernel<<<(n_pack + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(weight, wpack, H, F);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 grid((unsigned int)(((X + TX - 1) / TX) * ((Y + TY - 1) / TY) *
                           ((Z + TZ - 1) / TZ)),
            (unsigned int)R);
  grid_conv3d_fwd_kernel<kF><<<grid, threads, smem, (cudaStream_t)stream>>>(
      in, wpack, bias, out, H, X, Y, Z, F, TX, TY, TZ, ZS);
  return (int)cudaGetLastError();
}

template <int kF>
int launch_conv3d_dw_f(const float* in, const float* g, float* partial,
                       float* d_weight, int R, int H, int X, int Y, int Z,
                       int F, int TX, int TY, int TZ, int ZS, int GZ, int NCS,
                       int NB, int threads, int smem_bytes, void* stream) {
  const int NA = round4(F) / 4;
  if (NCS < 1 || NA % NCS != 0) return (int)cudaErrorInvalidValue;
  const int NQ = 9 * NA * NCS;
  const int S = threads / NQ;
  const size_t stage = (size_t)TX * TY * GZ * 4 * NA
                       + (size_t)(TX + 2) * (TY + 2) * ZS * 4 * NCS;
  const size_t red = (size_t)threads * kDwSums;
  const size_t smem = (2 * stage > red ? 2 * stage : red) * sizeof(float);
  const int tiles = ((X + TX - 1) / TX) * ((Y + TY - 1) / TY) *
                    ((Z + TZ - 1) / TZ);
  if (TX <= 0 || TY <= 0 || TZ <= 0 || ZS < TZ + 2 || GZ < TZ || S < 1 ||
      S * NQ != threads || (NQ < 32 && S % 8 != 0) ||
      threads > kDwThreads || (size_t)smem_bytes != smem || NB < 1 ||
      NB > (R / H) * tiles)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem(grid_conv3d_dw_kernel<kF>, smem);
  if (err != 0) return err;
  grid_conv3d_dw_kernel<kF><<<dim3((unsigned int)NB, (unsigned int)H,
                                   (unsigned int)(NA / NCS)),
                              threads, smem, (cudaStream_t)stream>>>(
      in, g, partial, H, R / H, X, Y, Z, F, TX, TY, TZ, ZS, GZ, NCS, NB, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_out = H * F * F * 27;
  grid_conv3d_dw_sum_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                              (cudaStream_t)stream>>>(partial, d_weight, NB,
                                                      n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes: each launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).

// The 3D conv on the caller's tiling (conv3d_tiling): TX x TY x TZ output
// cells a block, halo z stride ZS, and the threads and shared-memory bytes
// that the tiling gives, which the launch checks.  ``wpack`` is scratch of
// H * 27 * FP * FP floats (FP = F rounded up to a multiple of 4) for the
// packed weights.
extern "C" int ct_grid_conv3d(const float* in, const float* weight,
                              const float* bias, float* out, float* wpack,
                              int R, int H, int X, int Y, int Z, int F,
                              int TX, int TY, int TZ, int ZS, int threads,
                              int smem, void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0 || Z <= 0) return 0;
  if (F <= 0 || F > 32 || H <= 0 || R % H != 0)
    return (int)cudaErrorInvalidValue;
  switch (F) {
#define CT_CONV3D(KF)                                                       \
  return launch_conv3d_f<KF>(in, weight, bias, out, wpack, R, H, X, Y, Z, F, \
                             TX, TY, TZ, ZS, threads, smem, stream)
    case 4: CT_CONV3D(4);
    case 8: CT_CONV3D(8);
    case 16: CT_CONV3D(16);
    case 32: CT_CONV3D(32);
    default: CT_CONV3D(0);
#undef CT_CONV3D
  }
}

// The 2D conv on the caller's tiling (conv2d_tiling): TX x TY output cells
// a block, halo row stride YS, and the threads and shared-memory bytes that
// the tiling gives, which the launch checks.
extern "C" int ct_grid_conv2d(const float* in, const float* weight,
                              const float* bias, float* out, int R, int H,
                              int X, int Y, int F, int TX, int TY, int YS,
                              int threads, int smem, void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0) return 0;
  if (F <= 0 || F > 32 || H <= 0 || R % H != 0)
    return (int)cudaErrorInvalidValue;
  switch (F) {
    case 4: return launch_conv2d_f<4>(in, weight, bias, out, R, H, X, Y, F,
                                      TX, TY, YS, threads, smem, stream);
    case 8: return launch_conv2d_f<8>(in, weight, bias, out, R, H, X, Y, F,
                                      TX, TY, YS, threads, smem, stream);
    case 16: return launch_conv2d_f<16>(in, weight, bias, out, R, H, X, Y, F,
                                        TX, TY, YS, threads, smem, stream);
    case 32: return launch_conv2d_f<32>(in, weight, bias, out, R, H, X, Y, F,
                                        TX, TY, YS, threads, smem, stream);
    default: return launch_conv2d_f<0>(in, weight, bias, out, R, H, X, Y, F,
                                       TX, TY, YS, threads, smem, stream);
  }
}


// The 3D weight gradient, two launches: ``partial`` is scratch of
// NB * H * F * F * 27 floats; NB blocks per head and input-channel slice
// (NCS channel quads each), each on TX x TY x TZ tiles with halo z stride
// ZS and cotangent z stride GZ.
extern "C" int ct_grid_conv3d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int Z, int F, int TX,
                                 int TY, int TZ, int ZS, int GZ, int NCS,
                                 int NB, int threads, int smem,
                                 void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0 || Z <= 0) return 0;
  if (F <= 0 || F > 32 || H <= 0 || R % H != 0)
    return (int)cudaErrorInvalidValue;
  switch (F) {
#define CT_CONV3D_DW(KF)                                                   \
  return launch_conv3d_dw_f<KF>(in, g, partial, d_weight, R, H, X, Y, Z, F, \
                                TX, TY, TZ, ZS, GZ, NCS, NB, threads, smem, \
                                stream)
    case 4: CT_CONV3D_DW(4);
    case 8: CT_CONV3D_DW(8);
    case 16: CT_CONV3D_DW(16);
    case 32: CT_CONV3D_DW(32);
    default: CT_CONV3D_DW(0);
#undef CT_CONV3D_DW
  }
}

// The 2D weight gradient, two launches: ``partial`` is scratch of
// NB * H * F * F * 9 floats, NB blocks per head, each TX x TY tiles.
extern "C" int ct_grid_conv2d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int F, int TX, int TY,
                                 int NB, int threads, int smem,
                                 void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0) return 0;
  if (F <= 0 || F > 32 || H <= 0 || R % H != 0)
    return (int)cudaErrorInvalidValue;
  switch (F) {
    case 4: return launch_conv2d_dw_f<4>(in, g, partial, d_weight, R, H, X,
                                         Y, F, TX, TY, NB, threads, smem,
                                         stream);
    case 8: return launch_conv2d_dw_f<8>(in, g, partial, d_weight, R, H, X,
                                         Y, F, TX, TY, NB, threads, smem,
                                         stream);
    case 16: return launch_conv2d_dw_f<16>(in, g, partial, d_weight, R, H, X,
                                           Y, F, TX, TY, NB, threads, smem,
                                           stream);
    case 32: return launch_conv2d_dw_f<32>(in, g, partial, d_weight, R, H, X,
                                           Y, F, TX, TY, NB, threads, smem,
                                           stream);
    default: return launch_conv2d_dw_f<0>(in, g, partial, d_weight, R, H, X,
                                          Y, F, TX, TY, NB, threads, smem,
                                          stream);
  }
}

