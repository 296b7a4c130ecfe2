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
