// Grouped 'same' 3x3x3 convolution + bias on flat grids [R, X, Y, Z, F]
// (F contiguous), where row r belongs to head r % H and every head has its
// own F x F tap kernels.
//
// Replaces cloud_transformers_tpu/ops/pallas_grid_conv.py: pallas_grid_conv
// (3D), which builds an im2col of three x slabs in VMEM and does one MXU
// matmul per x row.
//
// Design: a direct convolution, one thread per output element
// (r, x, y, z, fo).  A block covers a run of output elements of one row r;
// it first stages that head's 27 * F * F weights in shared memory as
// [tap][fi][fo] (at most 27 KiB for F = 16), so neighbouring threads, which
// differ in fo, read neighbouring words.  Inputs are read from device
// memory through L1/L2: the F threads of one cell read the same words, and
// neighbouring cells' stencils overlap.
//
// Bound on the H100: float32 operations (up to 27 * F MACs per output; the
// taps inside the grid come to about 6.4 GFLOP for 16^3 x 16 and 3.4 GFLOP
// for 32^3 x 4 at R = 128), with bytes close behind for 32^3 x 4.  The kernel reaches neither: every MAC reloads its input
// from L1 instead of a register or shared tile.  Register tiling over fo
// and a shared-memory input halo, or tensor cores (TF32 would cost the
// float32 parity), are later work.
//
// grid_conv3d_dw replaces pallas_grid_conv_dw of the same file (the weight
// gradient), which multiplies the im2col of three x slabs with the cotangent
// on the MXU and carries the sum over a head's batch members from one grid
// step to the next.  Blocks here run in no order, so the sum over the
// B * X * Y * Z cells of a head takes two passes:
//
// * pass 1: a block takes one x plane of one row r.  Thread (s, fi, fo)
//   walks the plane's cells s, s + S, ... and keeps the 27 taps' sums for
//   its (fi, fo) in registers: per cell one cotangent word g[fo]
//   and up to 27 input words in[cell + tap][fi], taps outside the grid
//   skipped.  The S partial sums meet in shared memory, and the block
//   writes its 27 * F * F numbers to a scratch row of its own.
// * pass 2: one thread per weight adds the scratch rows of its head in a
//   fixed order and writes the gradient in the parameter layout
//   [H*F (out), F (in), 3, 3, 3].  No atomics: the result is the same in
//   every run.
//
// Bound on the H100: float32 operations (27 * F * F MACs per cell inside
// the grid, the same count as the forward), since the two grids are read
// once and the output is tiny.  As in the forward kernel, every MAC loads
// its input word through L1, which is what keeps it from that bound; an
// input halo in shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void grid_conv3d_kernel(const float* __restrict__ in,
                                   const float* __restrict__ weight,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, int H, int X,
                                   int Y, int Z, int F) {
  extern __shared__ float w_s[];  // [27][F][F] as (tap, fi, fo)
  const int r = blockIdx.y;
  const int h = r % H;
  const int n_w = 27 * F * F;
  // weight is [H*F (out), F (in), 3, 3, 3] (OIDHW, groups = H)
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    const int fo = i % F;
    const int fi = (i / F) % F;
    const int tap = i / (F * F);
    w_s[i] = weight[((int64_t)(h * F + fo) * F + fi) * 27 + tap];
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
      for (int dz = 0; dz < 3; ++dz) {
        const int zz = z + dz - 1;
        if (zz < 0 || zz >= Z) continue;
        const float* src = src_r + (((int64_t)xx * Y + yy) * Z + zz) * F;
        const float* w = w_s + ((dx * 3 + dy) * 3 + dz) * F * F + fo;
        for (int fi = 0; fi < F; ++fi) acc += src[fi] * w[fi * F];
      }
    }
  }
  out[(int64_t)r * cells * F + t] = acc + bias[h * F + fo];
}

constexpr int kTaps = 27;

__global__ void grid_conv3d_dw_partial_kernel(const float* __restrict__ in,
                                              const float* __restrict__ g,
                                              float* __restrict__ partial,
                                              int H, int X, int Y, int Z,
                                              int F, int S) {
  extern __shared__ float acc_s[];  // [S][F * F][27]
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
        for (int dz = 0; dz < 3; ++dz) {
          const int zz = z + dz - 1;
          if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z)
            acc[(dx * 3 + dy) * 3 + dz] +=
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

__global__ void grid_conv3d_dw_reduce_kernel(const float* __restrict__ partial,
                                             float* __restrict__ d_weight,
                                             int n_chunks, int64_t n_out) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < n_chunks; ++c) sum += partial[(int64_t)c * n_out + o];
  d_weight[o] = sum;
}

}  // namespace

// Plain C entry point for ctypes: launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int ct_grid_conv3d(const float* in, const float* weight,
                              const float* bias, float* out, int R, int H,
                              int X, int Y, int Z, int F, void* stream) {
  const int64_t n = (int64_t)X * Y * Z * F;
  const size_t smem = (size_t)27 * F * F * sizeof(float);
  if (n > 0 && R > 0) {
    dim3 grid((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)R);
    grid_conv3d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        in, weight, bias, out, H, X, Y, Z, F);
  }
  return (int)cudaGetLastError();
}

// Weight gradient, two launches.  ``partial`` is scratch of
// B * X * H * 27 * F * F floats; ``threads`` = F * F * S with S >= 1 is
// chosen by the caller (at most 1024, and threads * 27 floats of shared
// memory at most 48 KiB).
extern "C" int ct_grid_conv3d_dw(const float* in, const float* g,
                                 float* partial, float* d_weight, int R,
                                 int H, int X, int Y, int Z, int F, int S,
                                 void* stream) {
  if (R <= 0 || X <= 0 || Y <= 0 || Z <= 0 || F <= 0) return 0;
  const int threads = F * F * S;
  const size_t smem = (size_t)threads * kTaps * sizeof(float);
  dim3 blocks((unsigned int)X, (unsigned int)R);
  grid_conv3d_dw_partial_kernel<<<blocks, threads, smem,
                                  (cudaStream_t)stream>>>(
      in, g, partial, H, X, Y, Z, F, S);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t n_out = (int64_t)H * F * F * kTaps;
  grid_conv3d_dw_reduce_kernel<<<
      (unsigned int)((n_out + kThreads - 1) / kThreads), kThreads, 0,
      (cudaStream_t)stream>>>(partial, d_weight, (R / H) * X, n_out);
  return (int)cudaGetLastError();
}
