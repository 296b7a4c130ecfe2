// Grouped 'same' 3x3x3 (3D) and 3x3 (2D) convolutions + bias on flat grids
// [R, X, Y(, Z), F] (F contiguous), where row r belongs to head r % H and
// every head has its own F x F tap kernels, and their weight gradients.
// Float32 on the CUDA cores throughout: TF32 would miss the port's 1e-5
// parity with the plain versions.
//
// --- 3D: grid_conv_kernel<3>, grid_conv_dw_partial_kernel<3> + reduce ------
//
// Replace cloud_transformers_tpu/ops/pallas_grid_conv.py: pallas_grid_conv,
// which builds an im2col of three x slabs in VMEM and does one MXU matmul per
// x row, and pallas_grid_conv_dw, which multiplies that im2col with the
// cotangent and carries the sum over a head's batch members from one grid
// step to the next.  The DZ template parameter (taps along z) is 3 here.
//
// Forward: a direct convolution, one thread per output element
// (r, x, y, z, fo).  A block covers a run of output elements of one row r;
// it stages that head's 27 * F * F weights in shared memory as [tap][fi][fo]
// (108 KiB for F = 32, above the 48 KiB default, so the entry point opts in
// to more dynamic shared memory).  Inputs are read from device memory
// through L1: every MAC reloads its input word, which keeps the kernel far
// from its bound (float32 operations: about 6.4 GFLOP for 16^3 x 16 at
// R = 128).  The 2D design below is meant to carry over.
//
// Weight gradient, two passes: pass 1 takes one x plane of one row per
// block; thread (s, fi, fo) keeps the 27 taps' sums for its (fi, fo) in
// registers over the cells s, s + S, ..., the S partial sums meet in shared
// memory, and the block writes a scratch row; pass 2 adds a head's rows in a
// fixed order (no atomics: the same result in every run).
//
// --- 2D: conv2d_fwd_kernel<F>, conv2d_dw_kernel<F> + conv2d_dw_sum_kernel --
//
// Replace pallas_grid_conv2d and pallas_grid_conv2d_dm, which multiply
// banded tap matrices (pack_m2d, for the MXU) with lane-rolled copies of the
// grid.  Those layouts are not copied.  Both are bound by float32
// operations on this card (9 * F * F MACs per in-grid cell: 2.4 GFLOP for
// 64^2 x 16 at R = 128, 36 us at 67 TFLOP/s) except at F = 4, where the
// bytes bound (the two grids, 67 MB at 128^2 x 4, 20 us).  What holds a
// direct convolution back is loads: one input load per FMA.  Both kernels
// therefore stage a tile of the grid with its one-cell halo in shared
// memory (zeros where the halo leaves the grid, 16-byte loads from device
// memory when F % 4 == 0) and keep register tiles of the output, so that
// each shared-memory load feeds many FMAs.  F is a template parameter for
// F = 4, 8, 16 and 32 (loops unrolled, float4 loads); F = 0 is the variant
// that takes any F from 1 to 32 at run time, with the channels padded to a
// multiple of 4 in shared memory.  Tile sizes, threads, shared memory and
// blocks come from the caller (conv2d_tiling in ops/pallas_grid_conv.py);
// the entry points recompute threads and shared memory and refuse a launch
// whose numbers disagree.
//
// Forward: one block per (row r, TX x TY tile of output cells).  It stages
// the head's weights as [tap][fi][fo] (fo padded to a multiple of 4) and the
// halo as [fi][TX + 2][YS], y contiguous; YS >= TY + 2 is chosen by the
// caller so that a warp's input loads fall in distinct banks.  The threads
// form F / FO groups of output channels, a warp inside one group; thread
// (x run, y) of a group keeps 4 cells along x times FO output channels in
// registers (FO = 8, or F when F < 8; 4 at run-time F).  Per (fi, dy) it
// loads 6 input words once for the three dx taps, and per tap its FO
// weights as float4 broadcasts: at F = 16, 12 shared loads feed 96 FMAs.
// The bias is added in the epilogue, which stores float4 runs of fo.
// Small grids get smaller tiles so that the card holds about two blocks per
// SM (16^2 x 16 at R = 128: 8 x 8 tiles, 512 blocks).
//
// Weight gradient: dW[h][fo][(fi, tap)] = sum over cells of g[cell][fo] *
// in[cell + tap][fi] is a product of [F] x [9F] with a reduction over
// B * X * Y cells.  Block (j, h) takes the units (batch member, tile) j,
// j + NB, ... of head h, NB chosen by the caller so that all heads together
// give about three blocks per SM; per unit it stages the cotangent tile and
// the input halo tile as [cell][F] in shared memory.  Thread (s, q) keeps a
// register tile of 4 fo x 4 fi x 3 dy taps for one dx (48 sums) over the
// cells s, s + S, ... of each unit: per cell one float4 of g and three of
// the input, 48 FMAs, and the threads of a warp that share a cell read few
// distinct words (broadcasts).  The S splits meet in shared memory in a
// fixed order and the block writes one scratch row [F][F][9]; a second pass
// adds the NB rows of each head in a fixed order into the parameter layout
// [H*F (out), F (in), 3, 3].  No atomics: the result is the same in every
// run.  Scratch is NB * H * F * F * 9 floats (about 3.5 MB at 64^2 x 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

template <int DZ>
__global__ void grid_conv_kernel(const float* __restrict__ in,
                                 const float* __restrict__ weight,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int H, int X, int Y,
                                 int Z, int F) {
  constexpr int kTaps = 9 * DZ;
  extern __shared__ float w_s[];  // [taps][F][F] as (tap, fi, fo)
  const int r = blockIdx.y;
  const int h = r % H;
  const int n_w = kTaps * F * F;
  // weight is [H*F (out), F (in), 3, 3(, 3)] (OI(D)HW, groups = H)
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    const int fo = i % F;
    const int fi = (i / F) % F;
    const int tap = i / (F * F);
    w_s[i] = weight[((int64_t)(h * F + fo) * F + fi) * kTaps + tap];
  }
  __syncthreads();

  const int64_t cells = (int64_t)X * Y * Z;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cells * F) return;
  const int fo = (int)(t % F);
  const int64_t cell = t / F;
  const int z = (int)(cell % Z);
  const int y = (int)((cell / Z) % Y);
  const int x = (int)(cell / ((int64_t)Y * Z));
  const float* src_r = in + (int64_t)r * cells * F;

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
        const float* src = src_r + (((int64_t)xx * Y + yy) * Z + zz) * F;
        const float* w = w_s + ((dx * 3 + dy) * DZ + dz) * F * F + fo;
        for (int fi = 0; fi < F; ++fi) acc += src[fi] * w[fi * F];
      }
    }
  }
  out[(int64_t)r * cells * F + t] = acc + bias[h * F + fo];
}

template <int DZ>
__device__ __forceinline__ void dw_partial(const float* __restrict__ in,
                                           const float* __restrict__ g,
                                           float* __restrict__ partial, int H,
                                           int X, int Y, int Z, int F, int S) {
  constexpr int kTaps = 9 * DZ;
  extern __shared__ float acc_s[];  // [S][F * F][taps]
  const int r = blockIdx.y;
  const int h = r % H;
  const int b = r / H;
  const int x = blockIdx.x;
  const int fo = threadIdx.x % F;
  const int fi = (threadIdx.x / F) % F;
  const int s = threadIdx.x / (F * F);
  const int64_t cells = (int64_t)X * Y * Z;
  const float* in_r = in + (int64_t)r * cells * F;
  const float* g_r = g + (int64_t)r * cells * F;

  float acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = 0.0f;

  const int plane = Y * Z;
  for (int yz = s; yz < plane; yz += S) {
    const int y = yz / Z;
    const int z = yz % Z;
    const float gv = g_r[((int64_t)x * plane + yz) * F + fo];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
#pragma unroll
        for (int dz = 0; dz < DZ; ++dz) {
          const int zz = z + dz - DZ / 2;
          if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z)
            acc[(dx * 3 + dy) * DZ + dz] +=
                in_r[(((int64_t)xx * Y + yy) * Z + zz) * F + fi] * gv;
        }
      }
    }
  }

  const int pairs = F * F;
  const int pair = fo * F + fi;  // the parameter layout: out, then in
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
    acc_s[((int64_t)s * pairs + pair) * kTaps + t] = acc[t];
  __syncthreads();
  // partial[(b * X + x), h, fo, fi, tap]
  float* dst = partial
      + (((int64_t)b * X + x) * H + h) * (int64_t)pairs * kTaps;
  for (int o = threadIdx.x; o < pairs * kTaps; o += blockDim.x) {
    float sum = 0.0f;
    for (int ss = 0; ss < S; ++ss)
      sum += acc_s[(int64_t)ss * pairs * kTaps + o];
    dst[o] = sum;
  }
}

// blocks of up to 256 threads (F <= 16), with the compiler's own register
// choice
template <int DZ>
__global__ void grid_conv_dw_partial_kernel(const float* __restrict__ in,
                                            const float* __restrict__ g,
                                            float* __restrict__ partial,
                                            int H, int X, int Y, int Z, int F,
                                            int S) {
  dw_partial<DZ>(in, g, partial, H, X, Y, Z, F, S);
}

// blocks of F * F threads, up to 1024 (F = 32): at most 64 registers each
template <int DZ>
__global__ void __launch_bounds__(1024)
grid_conv_dw_partial_wide_kernel(const float* __restrict__ in,
                                 const float* __restrict__ g,
                                 float* __restrict__ partial, int H, int X,
                                 int Y, int Z, int F, int S) {
  dw_partial<DZ>(in, g, partial, H, X, Y, Z, F, S);
}

// instantiated for DZ = 3 only: the 2D weight gradient has its own kernels
template <int DZ>
__global__ void grid_conv_dw_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ d_weight,
                                           int n_chunks, int64_t n_out) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < n_chunks; ++c) sum += partial[(int64_t)c * n_out + o];
  d_weight[o] = sum;
}

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

// Opt in to more than 48 KiB of dynamic shared memory where a launch needs
// it; returns the CUDA error of the request (0 = granted).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DZ>
int launch_conv(const float* in, const float* weight, const float* bias,
                float* out, int R, int H, int X, int Y, int Z, int F,
                void* stream) {
  const int64_t n = (int64_t)X * Y * Z * F;
  const size_t smem = (size_t)9 * DZ * F * F * sizeof(float);
  if (n > 0 && R > 0) {
    const int err = allow_smem(grid_conv_kernel<DZ>, smem);
    if (err != 0) return err;
    dim3 grid((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)R);
    grid_conv_kernel<DZ><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        in, weight, bias, out, H, X, Y, Z, F);
  }
  return (int)cudaGetLastError();
}

template <int DZ>
int launch_dw(const float* in, const float* g, float* partial,
              float* d_weight, int R, int H, int X, int Y, int Z, int F,
              int S, void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0 || Z <= 0 || F <= 0) return 0;
  constexpr int kTaps = 9 * DZ;
  const int threads = F * F * S;
  const size_t smem = (size_t)threads * kTaps * sizeof(float);
  dim3 blocks((unsigned int)X, (unsigned int)R);
  int err;
  if (threads <= 256) {
    err = allow_smem(grid_conv_dw_partial_kernel<DZ>, smem);
    if (err != 0) return err;
    grid_conv_dw_partial_kernel<DZ><<<blocks, threads, smem,
                                     (cudaStream_t)stream>>>(
        in, g, partial, H, X, Y, Z, F, S);
  } else {
    err = allow_smem(grid_conv_dw_partial_wide_kernel<DZ>, smem);
    if (err != 0) return err;
    grid_conv_dw_partial_wide_kernel<DZ><<<blocks, threads, smem,
                                          (cudaStream_t)stream>>>(
        in, g, partial, H, X, Y, Z, F, S);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t n_out = (int64_t)H * F * F * kTaps;
  grid_conv_dw_reduce_kernel<DZ><<<
      (unsigned int)((n_out + kThreads - 1) / kThreads), kThreads, 0,
      (cudaStream_t)stream>>>(partial, d_weight, (R / H) * X, n_out);
  return (int)cudaGetLastError();
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

}  // namespace

// Plain C entry points for ctypes: each launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int ct_grid_conv3d(const float* in, const float* weight,
                              const float* bias, float* out, int R, int H,
                              int X, int Y, int Z, int F, void* stream) {
  return launch_conv<3>(in, weight, bias, out, R, H, X, Y, Z, F, stream);
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

// The 3D weight gradient, two launches.  ``partial`` is scratch of
// B * X * H * taps * F * F floats; ``S`` >= 1 is chosen by the caller so
// that F * F * S threads are at most 1024 and their taps * 4 bytes of
// shared memory each at most 227 KB.
extern "C" int ct_grid_conv3d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int Z, int F, int S,
                                 void* stream) {
  return launch_dw<3>(in, g, partial, d_weight, R, H, X, Y, Z, F, S, stream);
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
