// Grouped 'same' 3x3x3 (3D) or 3x3 (2D) convolution + bias on flat grids
// [R, X, Y, Z, F] (F contiguous), where row r belongs to head r % H and
// every head has its own F x F tap kernels.  A 2D grid [R, X, Y, F] is the
// 3D grid [R, X, Y, 1, F]: the kernels take DZ, the number of taps along z
// (3 in 3D, 1 in 2D), as a template parameter, so the 2D conv has 9 taps and
// never visits the z taps that would fall into the padding.
//
// Replaces cloud_transformers_tpu/ops/pallas_grid_conv.py: pallas_grid_conv
// (3D), which builds an im2col of three x slabs in VMEM and does one MXU
// matmul per x row, and pallas_grid_conv2d (2D), which multiplies banded
// tap matrices (pack_m2d) with lane-rolled copies of the grid.  Both layouts
// exist for the TPU's vector and matrix units and are not copied.
//
// Design: a direct convolution, one thread per output element
// (r, x, y, z, fo).  A block covers a run of output elements of one row r;
// it first stages that head's 9 * DZ * F * F weights in shared memory as
// [tap][fi][fo] (27 KiB for F = 16 in 3D, 108 KiB for F = 32, above the
// 48 KiB default, so the entry point opts in to more dynamic shared memory),
// so neighbouring threads, which differ in fo, read neighbouring words.
// Inputs are read from device memory through L1/L2: the F threads of one
// cell read the same words, and neighbouring cells' stencils overlap.
//
// Bound on the H100: float32 operations (up to 9 * DZ * F MACs per output;
// the taps inside the grid come to about 6.4 GFLOP for 16^3 x 16, 3.4 GFLOP
// for 32^3 x 4 and 2.4 GFLOP for 64^2 x 16 at R = 128), with bytes close
// behind for the F = 4 grids.  The kernel reaches neither: every MAC
// reloads its input from L1 instead of a register or shared tile.  Register
// tiling over fo and a shared-memory input halo, or tensor cores (TF32
// would cost the float32 parity), are later work.
//
// The weight gradients replace pallas_grid_conv_dw (3D), which multiplies
// the im2col of three x slabs with the cotangent on the MXU, and
// pallas_grid_conv2d_dm (2D), which accumulates the banded matrices' gradient;
// both carry the sum over a head's batch members from one grid step to the
// next.  Blocks here run in no order, so the sum over the B * X * Y * Z
// cells of a head takes two passes:
//
// * pass 1: a block takes one x plane of one row r.  Thread (s, fi, fo)
//   walks the plane's cells s, s + S, ... and keeps the 9 * DZ taps' sums
//   for its (fi, fo) in registers: per cell one cotangent word g[fo] and up
//   to 9 * DZ input words in[cell + tap][fi], taps outside the grid skipped.
//   The S partial sums meet in shared memory, and the block writes its
//   9 * DZ * F * F numbers to a scratch row of its own.  F * F * S threads:
//   256 up to F = 16, F * F (up to 1024, F = 32) above.
// * pass 2: one thread per weight adds the scratch rows of its head in a
//   fixed order and writes the gradient in the parameter layout
//   [H*F (out), F (in), 3, 3(, 3)].  No atomics: the result is the same in
//   every run.
//
// Bound on the H100: float32 operations (9 * DZ * F * F MACs per cell
// inside the grid, the same count as the forward), since the two grids are
// read once and the output is tiny.  As in the forward kernel, every MAC
// loads its input word through L1, which is what keeps it from that bound;
// an input halo in shared memory is later work.

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

// DZ only names the 2D and 3D launches apart in a profile
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

}  // namespace

// Plain C entry points for ctypes: each launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int ct_grid_conv3d(const float* in, const float* weight,
                              const float* bias, float* out, int R, int H,
                              int X, int Y, int Z, int F, void* stream) {
  return launch_conv<3>(in, weight, bias, out, R, H, X, Y, Z, F, stream);
}

extern "C" int ct_grid_conv2d(const float* in, const float* weight,
                              const float* bias, float* out, int R, int H,
                              int X, int Y, int F, void* stream) {
  return launch_conv<1>(in, weight, bias, out, R, H, X, Y, 1, F, stream);
}

// Weight gradients, two launches each.  ``partial`` is scratch of
// B * X * H * taps * F * F floats; ``S`` >= 1 is chosen by the caller so
// that F * F * S threads are at most 1024 and their taps * 4 bytes of
// shared memory each at most 227 KB.
extern "C" int ct_grid_conv3d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int Z, int F, int S,
                                 void* stream) {
  return launch_dw<3>(in, g, partial, d_weight, R, H, X, Y, Z, F, S, stream);
}

extern "C" int ct_grid_conv2d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int F, int S,
                                 void* stream) {
  return launch_dw<1>(in, g, partial, d_weight, R, H, X, Y, 1, F, S, stream);
}
