// Train-mode BatchNorm over the channel-last rows [N, C] of the port's
// per-point tensors (rows at a stride LD, channels contiguous), with an
// optional ReLU after the affine, and its backward.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses its reductions and elementwise ops.  PyTorch's eager autograd ran
// it as about 12 forward and 20 backward elementwise ops, some 42 passes
// over the input and two saved temporaries a module (nn/norm.py).  Bound
// on this card: bytes.  At N x C = 196608 x 512 one pass over x is 403 MB,
// 120 us at 3.35 TB/s.  These kernels make three passes forward (a read of
// x for the statistics, a read of x and a write of y) and five backward (a
// read of x and dy for the two sums, a read of both and a write of dx),
// with the partial sums' few megabytes between them.
//
// Blocks are TR x lanes threads (TR * lanes <= 256; lanes * VEC channels a
// tile, at most 128, VEC = 4 where C, the row strides and the pointers
// allow float4).  A block owns chunks of TR * kRows consecutive rows of its
// tile; in a chunk a thread takes kRows rows TR apart.  An apply kernel's
// block takes one chunk.  A reduction's takes CH, as many as leave the card
// about four blocks an SM, so that its reduction at the end is paid once
// for many rows (at 196608 x 512: 8 chunks, 768 blocks; on an H100 SXM
// its time fell from 0.310 to 0.166 ms).  The plan is bn_plan in ops/batch_norm.py, which the
// entry points check.
//
// Forward, three launches:
//   bn_stats_kernel: a thread loads a chunk's kRows rows of its channels
//     into registers, takes the chunk's mean and, from the same registers,
//     its M2 = sum (x - mean)^2, and merges them into its own running
//     (count, mean, M2) by Chan's rule.  At the end the block merges its TR
//     row lanes in float64, in order, into (m_b, M2_b), m_b rounded to
//     float, and writes (m_b, o_b = n_b (mean_b - m_b), M2_b) to the
//     workspace [3][row blocks][C].
//   bn_stats_finish_kernel: per channel, Chan's merge of the blocks in
//     float64, in a fixed order: mean = sum_b (n_b m_b + o_b) / N, then M2
//     = sum_b M2_b + 2 d o_b + n_b d^2 with d = m_b - mean (o_b carries
//     m_b's rounding), so the variance is the JAX package's mean((x -
//     mean)^2) up to float32 rounding of the chunk terms.  It writes mean
//     and rstd = rsqrt(var + eps) and, where asked, moves the running
//     statistics by momentum (the variance with Bessel's factor).
//   bn_apply_kernel: y = (x - mean) * (rstd * scale) + bias, each operation
//     rounded on its own as PyTorch's separate ops round it, then the ReLU;
//     a read of x and a write of y.
// Backward, three launches:
//   bn_grad_sums_kernel: per block and channel, s1 = sum dy' and s2 = sum
//     dy' (x - mean), dy' = dy where the forward's y > 0 under the ReLU.  y
//     is recomputed from x by bn_out, the forward's own function, so the
//     mask is the forward's bit for bit.  Each thread sums its rows in
//     order, then the block its TR row lanes in order.
//   bn_grad_finish_kernel: the block sums in float64 in a fixed order;
//     d_bias = s1, d_scale = rstd * s2, and dx's coefficients k1 = s1 / N,
//     k2 = s2 rstd^2 / N (zero in eval mode, where mean and rstd are
//     constants).
//   bn_grad_apply_kernel: dx = (rstd * scale) (dy' - k1 - (x - mean) k2).
// No atomics anywhere: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;        // rows a thread a chunk (BN_ROWS)
constexpr int kChunks = 8;       // most chunks a block (BN_CHUNKS)
constexpr int kThreads = 256;    // most threads a block (BN_THREADS)
constexpr int kTile = 128;       // most channels a block (BN_TILE)
constexpr int kFinishLanes = 32;  // channels a finishing block
constexpr int kFinishRows = 8;    // its row-block lanes

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// The affine, each operation rounded on its own: the value the forward
// writes and the backward's mask both come from here.
__device__ __forceinline__ float bn_out(float x, float m, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), a), b);
}

// max(y, 0) that keeps a NaN, as torch.relu does.
__device__ __forceinline__ float relu(float y) { return y <= 0.f ? 0.f : y; }

// Per-channel coefficients of a lane: mean, rstd * scale, bias.
template <int VEC>
__device__ __forceinline__ void coefficients(
    const float* mean, const float* rstd, const float* scale,
    const float* bias, int c0, float (&m)[VEC], float (&a)[VEC],
    float (&b)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mean[c0 + j];
    a[j] = __fmul_rn(rstd[c0 + j], scale[c0 + j]);
    b[j] = bias[c0 + j];
  }
}

// Sum of ``v`` over the block's TR row lanes, in row-lane order, for the
// lane's VEC channels; every thread gets it.  ``sh`` holds TR * lanes * VEC
// floats.  Ends synchronised, so ``sh`` may be written again.
template <int VEC>
__device__ __forceinline__ void sum_row_lanes(float* sh, float (&v)[VEC],
                                              float (&out)[VEC]) {
  const int lanes = blockDim.x, tx = threadIdx.x;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    sh[(threadIdx.y * lanes + tx) * VEC + j] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = 0.f;
  for (int t = 0; t < blockDim.y; ++t) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] += sh[(t * lanes + tx) * VEC + j];
  }
  __syncthreads();
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const float* __restrict__ x, float* __restrict__ part,
                int N, int C, int LD, int CH) {
  __shared__ float sh_mean[kThreads * 4], sh_m2[kThreads * 4];
  __shared__ int sh_n[kThreads];
  const int TR = blockDim.y, ty = threadIdx.y, lanes = blockDim.x;
  const int tx = threadIdx.x;
  const int c0 = (blockIdx.y * lanes + tx) * VEC;
  const bool live = c0 < C;
  const int row0 = blockIdx.x * TR * kRows * CH;
  int n = 0;
  float mean[VEC] = {}, m2[VEC] = {};
  for (int ch = 0; ch < CH; ++ch) {
    const int base = row0 + ch * TR * kRows + ty;
    if (base >= N) break;
    const int nc = min(kRows, (N - base + TR - 1) / TR);
    float v[kRows][VEC];
    float s[VEC] = {};
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (live && k < nc) {
        load<VEC>(x + (int64_t)(base + k * TR) * LD + c0, v[k]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] += v[k][j];
    }
    const int nn = n + nc;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float mc = s[j] / (float)nc;
      float m2c = 0.f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float d = v[k][j] - mc;
        if (k < nc) m2c = __fmaf_rn(d, d, m2c);
      }
      const float d = mc - mean[j];
      mean[j] += d * ((float)nc / (float)nn);
      m2[j] += m2c + d * d * ((float)n * (float)nc / (float)nn);
    }
    n = nn;
  }
  // the block's TR row lanes, merged in order in float64
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sh_mean[(ty * lanes + tx) * VEC + j] = mean[j];
    sh_m2[(ty * lanes + tx) * VEC + j] = m2[j];
  }
  if (tx == 0) sh_n[ty] = n;
  __syncthreads();
  if (ty != 0 || !live) return;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    double bn = 0.0, bmean = 0.0, bm2 = 0.0;
    for (int t = 0; t < TR; ++t) {
      const int nt = sh_n[t];
      if (nt == 0) continue;
      const double tm = sh_mean[(t * lanes + tx) * VEC + j];
      const double d = tm - bmean;
      const double nn = bn + nt;
      bmean += d * (nt / nn);
      bm2 += sh_m2[(t * lanes + tx) * VEC + j] + d * d * (bn * nt / nn);
      bn = nn;
    }
    const float mb = (float)bmean;
    const int64_t at = (int64_t)blockIdx.x * C + c0 + j;
    const int64_t third = (int64_t)gridDim.x * C;
    part[at] = mb;
    part[third + at] = (float)(bn * (bmean - (double)mb));
    part[2 * third + at] = (float)bm2;
  }
}

// Sum of a double over the finishing block's row-block lanes, in order;
// every thread gets it.
__device__ __forceinline__ double sum_finish_lanes(double* sh, double v) {
  sh[threadIdx.y * kFinishLanes + threadIdx.x] = v;
  __syncthreads();
  double out = 0.0;
  for (int t = 0; t < kFinishRows; ++t)
    out += sh[t * kFinishLanes + threadIdx.x];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kFinishLanes * kFinishRows)
bn_stats_finish_kernel(const float* __restrict__ part, int NB, int BR, int N,
                       int C, float* __restrict__ mean,
                       float* __restrict__ rstd, float* run_mean,
                       float* run_var, float eps, float momentum,
                       float bessel, int update) {
  __shared__ double sh[kFinishRows * kFinishLanes];
  const int c = blockIdx.x * kFinishLanes + threadIdx.x;
  const bool live = c < C;
  const float* mbs = part;
  const float* offs = part + (int64_t)NB * C;
  const float* m2s = part + (int64_t)2 * NB * C;
  double s = 0.0;
  if (live)
    for (int b = threadIdx.y; b < NB; b += kFinishRows) {
      const int64_t at = (int64_t)b * C + c;
      s += (double)min(BR, N - b * BR) * mbs[at] + offs[at];
    }
  const double mu = sum_finish_lanes(sh, s) / (double)N;
  double m2 = 0.0;
  if (live)
    for (int b = threadIdx.y; b < NB; b += kFinishRows) {
      const int64_t at = (int64_t)b * C + c;
      const double d = (double)mbs[at] - mu;
      m2 += (double)m2s[at]
          + d * (2.0 * offs[at] + (double)min(BR, N - b * BR) * d);
    }
  const double M2 = sum_finish_lanes(sh, m2);
  if (threadIdx.y == 0 && live) {
    const float mf = (float)mu;
    const float vf = (float)(M2 / (double)N);
    mean[c] = mf;
    rstd[c] = rsqrtf(vf + eps);
    if (update) {
      const float rm = run_mean[c], rv = run_var[c];
      run_mean[c] = rm + momentum * (mf - rm);
      run_var[c] = rv + momentum * (vf * bessel - rv);
    }
  }
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ y, int N,
                int C, int LD) {
  const int TR = blockDim.y, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  float m[VEC], a[VEC], b[VEC];
  coefficients<VEC>(mean, rstd, scale, bias, c0, m, a, b);
  const int row0 = blockIdx.x * TR * kRows + ty;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = row0 + k * TR;
    if (r < N) {
      float v[VEC];
      load<VEC>(x + (int64_t)r * LD + c0, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[j] = bn_out(v[j], m[j], a[j], b[j]);
        if (RELU) v[j] = relu(v[j]);
      }
      store<VEC>(y + (int64_t)r * C + c0, v);
    }
  }
}

// dy' of one element: dy, or 0 where the ReLU's output was 0.
template <bool RELU>
__device__ __forceinline__ float masked(float g, float x, float m, float a,
                                        float b) {
  return RELU && bn_out(x, m, a, b) <= 0.f ? 0.f : g;
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_grad_sums_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ part,
                    int N, int C, int LDX, int LDY, int CH) {
  __shared__ float sh[kThreads * 4];
  const int TR = blockDim.y, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool live = c0 < C;
  float m[VEC], a[VEC], b[VEC];
  if (live) {
    coefficients<VEC>(mean, rstd, scale, bias, c0, m, a, b);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = a[j] = b[j] = 0.f;
  }
  const int row0 = blockIdx.x * TR * kRows * CH + ty;
  float s1[VEC] = {}, s2[VEC] = {};
  for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = row0 + (ch * kRows + k) * TR;
      if (live && r < N) {
        float xv[VEC], gv[VEC];
        load<VEC>(x + (int64_t)r * LDX + c0, xv);
        load<VEC>(dy + (int64_t)r * LDY + c0, gv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float g = masked<RELU>(gv[j], xv[j], m[j], a[j], b[j]);
          s1[j] += g;
          s2[j] = __fmaf_rn(g, __fsub_rn(xv[j], m[j]), s2[j]);
        }
      }
    }
  }
  float t1[VEC], t2[VEC];
  sum_row_lanes<VEC>(sh, s1, t1);
  sum_row_lanes<VEC>(sh, s2, t2);
  if (ty == 0 && live) {
    const int64_t at = (int64_t)blockIdx.x * C + c0;
    const int64_t half = (int64_t)gridDim.x * C;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      part[at + j] = t1[j];
      part[half + at + j] = t2[j];
    }
  }
}

__global__ void __launch_bounds__(kFinishLanes * kFinishRows)
bn_grad_finish_kernel(const float* __restrict__ part, int NB, int N, int C,
                      const float* __restrict__ rstd, int train,
                      float* __restrict__ coef,
                      float* __restrict__ d_scale,
                      float* __restrict__ d_bias) {
  __shared__ double sh[kFinishRows * kFinishLanes];
  const int c = blockIdx.x * kFinishLanes + threadIdx.x;
  const bool live = c < C;
  double s1 = 0.0, s2 = 0.0;
  if (live)
    for (int b = threadIdx.y; b < NB; b += kFinishRows) {
      s1 += (double)part[(int64_t)b * C + c];
      s2 += (double)part[(int64_t)(NB + b) * C + c];
    }
  s1 = sum_finish_lanes(sh, s1);
  s2 = sum_finish_lanes(sh, s2);
  if (threadIdx.y == 0 && live) {
    const double r = rstd[c];
    d_bias[c] = (float)s1;
    d_scale[c] = (float)(s2 * r);
    coef[c] = train ? (float)(s1 / N) : 0.f;
    coef[C + c] = train ? (float)(s2 * r * r / N) : 0.f;
  }
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ coef, float* __restrict__ dx,
                     int N, int C, int LDX, int LDY) {
  const int TR = blockDim.y, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  float m[VEC], a[VEC], b[VEC], k1[VEC], k2[VEC];
  coefficients<VEC>(mean, rstd, scale, bias, c0, m, a, b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    k1[j] = coef[c0 + j];
    k2[j] = coef[C + c0 + j];
  }
  const int row0 = blockIdx.x * TR * kRows + ty;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = row0 + k * TR;
    if (r < N) {
      float xv[VEC], gv[VEC];
      load<VEC>(x + (int64_t)r * LDX + c0, xv);
      load<VEC>(dy + (int64_t)r * LDY + c0, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float g = masked<RELU>(gv[j], xv[j], m[j], a[j], b[j]);
        const float xc = __fsub_rn(xv[j], m[j]);
        gv[j] = a[j] * (g - k1[j] - xc * k2[j]);
      }
      store<VEC>(dx + (int64_t)r * C + c0, gv);
    }
  }
}

// The plan's check: VEC 1 or 4 (4 only where C, the row strides and the
// pointers allow float4), lanes * VEC <= kTile, lanes * TR <= kThreads, NB
// row blocks of CH chunks of TR * kRows rows covering N exactly.
bool plan_ok(int N, int C, int vec, int lanes, int TR, int CH, int NB,
             const void* const* ptrs, int n_ptrs, const int* lds,
             int n_lds) {
  if (N <= 0 || C <= 0 || lanes <= 0 || TR <= 0) return false;
  if (CH <= 0 || CH > kChunks) return false;
  if (vec != 1 && vec != 4) return false;
  if (lanes * vec > kTile || lanes * TR > kThreads) return false;
  const int want = (C + vec - 1) / vec;
  if (lanes != (want < kTile / vec ? want : kTile / vec)) return false;
  const int64_t rows = (int64_t)TR * kRows * CH;
  if (NB != (N + rows - 1) / rows) return false;
  for (int i = 0; i < n_lds; ++i)
    if (lds[i] < C) return false;
  if (vec == 4) {
    if (C % 4) return false;
    for (int i = 0; i < n_lds; ++i)
      if (lds[i] % 4) return false;
    for (int i = 0; i < n_ptrs; ++i)
      if ((uintptr_t)ptrs[i] % 16) return false;
  }
  return true;
}

dim3 tiles(int NB, int C, int vec, int lanes) {
  return dim3(NB, (C + lanes * vec - 1) / (lanes * vec));
}

}  // namespace

// Statistics of x [N, C] (row stride LD): mean, rstd; the running ones
// moved where ``update``.  ``part`` is scratch of 3 * NB * C floats.
extern "C" int ct_bn_stats(const float* x, float* part, float* mean,
                           float* rstd, float* run_mean, float* run_var,
                           int N, int C, int LD, int vec, int lanes, int TR,
                           int CH, int NB, float eps, float momentum,
                           float bessel, int update, void* stream) {
  const void* ptrs[] = {x};
  if (!plan_ok(N, C, vec, lanes, TR, CH, NB, ptrs, 1, &LD, 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(lanes, TR);
  if (vec == 4)
    bn_stats_kernel<4><<<tiles(NB, C, vec, lanes), block, 0, s>>>(
        x, part, N, C, LD, CH);
  else
    bn_stats_kernel<1><<<tiles(NB, C, vec, lanes), block, 0, s>>>(
        x, part, N, C, LD, CH);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bn_stats_finish_kernel<<<(C + kFinishLanes - 1) / kFinishLanes,
                           dim3(kFinishLanes, kFinishRows), 0, s>>>(
      part, NB, TR * kRows * CH, N, C, mean, rstd, run_mean, run_var, eps,
      momentum, bessel, update);
  return (int)cudaGetLastError();
}

// y [N, C] (contiguous) = (x - mean) * (rstd * scale) + bias, then the ReLU
// where ``relu``: NA row blocks of one chunk.
extern "C" int ct_bn_apply(const float* x, const float* mean,
                           const float* rstd, const float* scale,
                           const float* bias, float* y, int N, int C, int LD,
                           int vec, int lanes, int TR, int NA, int relu,
                           void* stream) {
  const void* ptrs[] = {x, y};
  if (!plan_ok(N, C, vec, lanes, TR, 1, NA, ptrs, 2, &LD, 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = tiles(NA, C, vec, lanes), block(lanes, TR);
#define CT_BN_APPLY(V, R)                                                \
  bn_apply_kernel<V, R><<<grid, block, 0, s>>>(x, mean, rstd, scale, bias, \
                                               y, N, C, LD)
  if (vec == 4) {
    if (relu) CT_BN_APPLY(4, true); else CT_BN_APPLY(4, false);
  } else {
    if (relu) CT_BN_APPLY(1, true); else CT_BN_APPLY(1, false);
  }
#undef CT_BN_APPLY
  return (int)cudaGetLastError();
}

// The backward of ct_bn_apply (with the statistics' own where ``train``):
// dx [N, C] (contiguous), d_scale and d_bias [C] from x (row stride LDX)
// and dy (LDY): the sums on NB row blocks of CH chunks, dx on NA of one.
// ``part`` is scratch of 2 * NB * C floats, ``coef`` of 2 * C.
extern "C" int ct_bn_backward(const float* x, const float* dy,
                              const float* mean, const float* rstd,
                              const float* scale, const float* bias,
                              float* part, float* coef, float* dx,
                              float* d_scale, float* d_bias, int N, int C,
                              int LDX, int LDY, int vec, int lanes, int TR,
                              int CH, int NB, int NA, int relu, int train,
                              void* stream) {
  const void* ptrs[] = {x, dy, dx};
  const int lds[] = {LDX, LDY};
  if (!plan_ok(N, C, vec, lanes, TR, CH, NB, ptrs, 3, lds, 2) ||
      !plan_ok(N, C, vec, lanes, TR, 1, NA, ptrs, 3, lds, 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = tiles(NB, C, vec, lanes), block(lanes, TR);
#define CT_BN_SUMS(V, R)                                                   \
  bn_grad_sums_kernel<V, R><<<grid, block, 0, s>>>(x, dy, mean, rstd, scale, \
                                                   bias, part, N, C, LDX,    \
                                                   LDY, CH)
  if (vec == 4) {
    if (relu) CT_BN_SUMS(4, true); else CT_BN_SUMS(4, false);
  } else {
    if (relu) CT_BN_SUMS(1, true); else CT_BN_SUMS(1, false);
  }
#undef CT_BN_SUMS
  int err = (int)cudaGetLastError();
  if (err) return err;
  bn_grad_finish_kernel<<<(C + kFinishLanes - 1) / kFinishLanes,
                          dim3(kFinishLanes, kFinishRows), 0, s>>>(
      part, NB, N, C, rstd, train, coef, d_scale, d_bias);
  err = (int)cudaGetLastError();
  if (err) return err;
#define CT_BN_DX(V, R)                                                    \
  bn_grad_apply_kernel<V, R><<<tiles(NA, C, vec, lanes), block, 0, s>>>(   \
      x, dy, mean, rstd, scale, bias, coef, dx, N, C, LDX, LDY)
  if (vec == 4) {
    if (relu) CT_BN_DX(4, true); else CT_BN_DX(4, false);
  } else {
    if (relu) CT_BN_DX(1, true); else CT_BN_DX(1, false);
  }
#undef CT_BN_DX
  return (int)cudaGetLastError();
}
