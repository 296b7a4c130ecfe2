// The auction's two kernels for the Earth Mover's Distance: the per-round bid
// search (top2) and a window of whole auction rounds (auction_window).
//
// top2 replaces cloud_transformers_tpu/ops/pallas_emd.py: pallas_top2.  For
// every bidder j of x1 [B, W, 3] against the targets x2 [B, M, 3] with prices
// [B, M] it gives the best and the second-best of
//
//     value[j, k] = 3 - sqrt(max(|x1_j|^2 + |x2_k|^2 - 2 <x1_j, x2_k>, 0))
//                     - price_k
//
// over k, and the lowest k that reaches the best (first-occurrence argmax).
// The second-best counts multiplicity (it equals the best when two targets
// tie), and is -1e9 when there is one target only.
//
// Design: the N-body shape.  A block stages a tile of targets in shared
// memory as (x, y, z, |x2|^2) and price; a bidder is served by SPLIT
// neighbouring lanes of one warp (SPLIT = 1 .. 32, a power of two chosen by
// the caller), lane s taking the targets s, s + SPLIT, ... of every tile in
// rising order with a running (best, second-best, index) in registers.  At
// the end the SPLIT partial results meet by warp shuffles: the higher value
// wins, the lower index on equal values, and the second-best is
// max(min(best_a, best_b), max(second_a, second_b)).  The TPU kernel walks
// its target tiles one after another on one core; here a wide round takes a
// small SPLIT (lanes of a warp then read the same target: a broadcast) and a
// compacted round of 1024 to 4096 bidders takes SPLIT = 32, which is what
// fills the 132 SMs.  The [.., 8] lane padding, the 1e6 dummy targets and
// the tile-height rules of the TPU kernel are not carried over: the arrays
// are flat and the ragged ends are bounds-checked.
//
// Arithmetic: float32, every multiply, add and subtract through the
// round-to-nearest intrinsics, so nothing contracts to an FMA, and the
// square root is the IEEE one (no --use_fast_math).  The plain PyTorch
// version does the same operations in the same order, each rounded, so on
// the card the two agree bit for bit and the argmax with them; against the
// JAX package (whose cross term comes from a matrix unit) values agree to
// float32 rounding of numbers near 3, a few 1e-7.
//
// Bound on the H100: operations.  B * W * M pairs of 12 float32 operations
// and one square root, against 12 bytes per bidder and 16 per target read
// once.  The square root goes through the special-function unit (16 a clock
// on each SM against 128 float32 lanes), which makes it the tighter limit.
//
// auction_window replaces pallas_auction_window of the same file: up to
// rounds_cap whole auction rounds {bid, resolve, assign with eviction} for a
// fixed window of W bidders, with the price and owner state of all M targets
// kept on the chip between the rounds.
//
// Design: one block of 1024 threads per batch row, the rounds loop inside.
// price and owner (8 bytes a target) live in dynamic shared memory when they
// fit beside the lane arrays (M = 16384 takes 128 KiB of the 227 KiB), else
// they stay in the output arrays in device memory: larger M is slower, never
// wrong.  A pre-pass packs the targets as (x, y, z, |x2|^2) into scratch.
//   bid      a warp per active lane walks all M targets (the same value and
//            the same top-2 merge as top2); lanes that are assigned are
//            skipped, so a round costs what its active lanes cost.
//   resolve  a thread per lane looks at every other active lane that bid for
//            the same target: it wins unless one of them has a higher
//            increment, or the same one and a lower original point id.  No
//            atomics and no per-target key array: the result is the same in
//            every run, and exactly one lane per target adds to its price.
//   apply    the winner adds its increment to the price, takes the target,
//            and, if the previous owner is a lane of this window, sets that
//            lane bidding again.  An owner outside the window just loses the
//            target and waits for a later window.
// The __syncthreads() between the three phases and before the next round's
// bid are what keeps a round from reading a half-updated state.  The window
// ends when no lane is active, when rem rounds are spent or after
// rounds_cap rounds; used[b] is the number of rounds row b ran.
//
// Bound on the H100: operations, used * active * M pairs of the same cost as
// top2 plus the resolve pass (at most W * W comparisons a round).  One block
// per row on a card of 132 SMs cannot come near it with B = 1 or 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // top2 block
constexpr int kTile = 1024;         // targets staged per tile (20 KiB)
constexpr int kWindowThreads = 1024;
constexpr float kNeg = -1e9f;       // "no second-best", as in the JAX package
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// 3 - sqrt(max(|a|^2 + |t|^2 - 2 <a, t>, 0)) - price, nothing contracted
__device__ __forceinline__ float bid_value(float ax, float ay, float az,
                                           float asq, float4 t, float p) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(ax, t.x), __fmul_rn(ay, t.y)),
                __fmul_rn(az, t.z));
  const float d2 = __fsub_rn(__fadd_rn(asq, t.w), __fmul_rn(2.0f, cross));
  return __fsub_rn(__fsub_rn(3.0f, __fsqrt_rn(fmaxf(d2, 0.0f))), p);
}

struct Top2 {
  float best, better;
  int idx;
};

// targets arrive in rising k: strictly greater keeps the earlier index
__device__ __forceinline__ void top2_push(Top2& s, float v, int k) {
  if (v > s.best) {
    s.better = s.best;
    s.best = v;
    s.idx = k;
  } else if (v > s.better) {
    s.better = v;
  }
}

// the partial results of the `lanes` neighbouring lanes meet in all of them
__device__ __forceinline__ void top2_merge_lanes(Top2& s, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, s.best, off);
    const float obt = __shfl_xor_sync(kFull, s.better, off);
    const int oi = __shfl_xor_sync(kFull, s.idx, off);
    const float nbetter = fmaxf(fminf(s.best, ob), fmaxf(s.better, obt));
    if (ob > s.best || (ob == s.best && oi < s.idx)) s.idx = oi;
    s.best = fmaxf(s.best, ob);
    s.better = nbetter;
  }
}

template <int SPLIT>
__global__ void __launch_bounds__(kThreads)
top2_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ price, float* __restrict__ best,
            float* __restrict__ better, int* __restrict__ best_i, int W,
            int M) {
  constexpr int kBidders = kThreads / SPLIT;   // bidders per block
  __shared__ float4 t_s[kTile];
  __shared__ float p_s[kTile];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kBidders + threadIdx.x / SPLIT;
  const int slice = threadIdx.x % SPLIT;
  const bool valid = j < W;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (valid) {
    const float* a = x1 + ((int64_t)b * W + j) * 3;
    ax = a[0];
    ay = a[1];
    az = a[2];
  }
  const float asq = sq_norm(ax, ay, az);
  const float* x2b = x2 + (int64_t)b * M * 3;
  const float* pb = price + (int64_t)b * M;
  Top2 s = {kNeg, kNeg, 0};
  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int cnt = min(kTile, M - m0);
    __syncthreads();   // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float* c = x2b + (int64_t)(m0 + t) * 3;
      const float x = c[0], y = c[1], z = c[2];
      t_s[t] = make_float4(x, y, z, sq_norm(x, y, z));
      p_s[t] = pb[m0 + t];
    }
    __syncthreads();
#pragma unroll 4
    for (int t = slice; t < cnt; t += SPLIT)
      top2_push(s, bid_value(ax, ay, az, asq, t_s[t], p_s[t]), m0 + t);
  }
  top2_merge_lanes(s, SPLIT);
  if (valid && slice == 0) {
    const int64_t o = (int64_t)b * W + j;
    best[o] = s.best;
    better[o] = s.better;
    best_i[o] = s.idx;
  }
}

template <int SPLIT>
int launch_top2(const float* x1, const float* x2, const float* price,
                float* best, float* better, int* best_i, int B, int W, int M,
                cudaStream_t stream) {
  constexpr int kBidders = kThreads / SPLIT;
  dim3 grid((unsigned int)((W + kBidders - 1) / kBidders), (unsigned int)B);
  top2_kernel<SPLIT><<<grid, kThreads, 0, stream>>>(x1, x2, price, best,
                                                    better, best_i, W, M);
  return (int)cudaGetLastError();
}

// Dynamic shared memory: jr, la, bi [W] int, inc [W] float, win [W] int,
// then, if state_in_smem, price [M] float and owner [M] int.
__global__ void __launch_bounds__(kWindowThreads)
auction_window_kernel(const float* __restrict__ x1w,
                      const int* __restrict__ j_real,
                      const float* __restrict__ x2, float4* x2p,
                      float* price, int* owner, int* __restrict__ used,
                      int W, int M, int n, int rem, int rounds_cap,
                      float eps, int state_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lid = tid & 31, nwarps = nthreads >> 5;
  int* jr = reinterpret_cast<int*>(smem);   // original point id, n = padding
  int* la = jr + W;                         // the lane's target, -1 = bidding
  int* bi = la + W;                         // this round's bid target
  float* inc = reinterpret_cast<float*>(bi + W);   // this round's increment
  int* win = reinterpret_cast<int*>(inc + W);
  float* pr = price + (int64_t)b * M;
  int* ow = owner + (int64_t)b * M;
  float* pr_g = pr;
  int* ow_g = ow;
  if (state_in_smem) {
    pr = reinterpret_cast<float*>(win + W);
    ow = reinterpret_cast<int*>(pr + M);
    for (int k = tid; k < M; k += nthreads) {
      pr[k] = pr_g[k];
      ow[k] = ow_g[k];
    }
  }
  const float* x2b = x2 + (int64_t)b * M * 3;
  float4* tp = x2p + (int64_t)b * M;
  for (int k = tid; k < M; k += nthreads) {
    const float x = x2b[3 * k], y = x2b[3 * k + 1], z = x2b[3 * k + 2];
    tp[k] = make_float4(x, y, z, sq_norm(x, y, z));
  }
  int any = 0;
  for (int i = tid; i < W; i += nthreads) {
    const int j = j_real[(int64_t)b * W + i];
    jr[i] = j;
    la[i] = -1;
    any |= (j < n);
  }
  // also makes the packed targets visible to the whole block
  bool done = !__syncthreads_or(any);
  int rounds = 0;
  for (int r = 0; r < rounds_cap; ++r) {
    if (done || r >= rem) break;   // the same in every thread
    // bid: a warp per active lane
    for (int lane = warp; lane < W; lane += nwarps) {
      if (la[lane] >= 0 || jr[lane] >= n) continue;
      const float* a = x1w + ((int64_t)b * W + lane) * 3;
      const float ax = a[0], ay = a[1], az = a[2];
      const float asq = sq_norm(ax, ay, az);
      Top2 s = {kNeg, kNeg, 0};
#pragma unroll 4
      for (int k = lid; k < M; k += 32)
        top2_push(s, bid_value(ax, ay, az, asq, tp[k], pr[k]), k);
      top2_merge_lanes(s, 32);
      if (lid == 0) {
        bi[lane] = s.idx;
        inc[lane] = __fadd_rn(__fsub_rn(s.best, s.better), eps);
      }
    }
    __syncthreads();
    // resolve: highest increment per target, ties to the lowest point id
    for (int i = tid; i < W; i += nthreads) {
      int w = 0;
      if (la[i] < 0 && jr[i] < n) {
        w = 1;
        const int t = bi[i];
        const float my_inc = inc[i];
        const int my_j = jr[i];
        for (int i2 = 0; i2 < W; ++i2) {
          if (i2 == i || la[i2] >= 0 || jr[i2] >= n || bi[i2] != t) continue;
          if (inc[i2] > my_inc || (inc[i2] == my_inc && jr[i2] < my_j)) {
            w = 0;
            break;
          }
        }
      }
      win[i] = w;
    }
    __syncthreads();
    // apply: one winner per target, so no two threads touch one target or
    // one evicted lane; a winner was bidding, so it is nobody's owner
    for (int i = tid; i < W; i += nthreads) {
      if (!win[i]) continue;
      const int t = bi[i];
      const int prev = ow[t];
      pr[t] = __fadd_rn(pr[t], inc[i]);
      ow[t] = jr[i];
      la[i] = t;
      if (prev >= 0) {
        for (int i2 = 0; i2 < W; ++i2) {
          if (jr[i2] == prev) {
            la[i2] = -1;
            break;
          }
        }
      }
    }
    __syncthreads();
    any = 0;
    for (int i = tid; i < W; i += nthreads) any |= (la[i] < 0 && jr[i] < n);
    const bool all_done = !__syncthreads_or(any);
    ++rounds;
    done = all_done || (r + 1 >= rem);
  }
  if (state_in_smem) {
    for (int k = tid; k < M; k += nthreads) {
      pr_g[k] = pr[k];
      ow_g[k] = ow[k];
    }
  }
  if (tid == 0) used[b] = rounds;
}

}  // namespace

// Plain C entry points for ctypes: each launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).

// split: lanes per bidder, a power of two from 1 to 32.
extern "C" int ct_emd_top2(const float* x1, const float* x2,
                           const float* price, float* best, float* better,
                           int* best_i, int B, int W, int M, int split,
                           void* stream) {
  if (B <= 0 || W <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (split) {
    case 1: return launch_top2<1>(x1, x2, price, best, better, best_i, B, W, M, s);
    case 2: return launch_top2<2>(x1, x2, price, best, better, best_i, B, W, M, s);
    case 4: return launch_top2<4>(x1, x2, price, best, better, best_i, B, W, M, s);
    case 8: return launch_top2<8>(x1, x2, price, best, better, best_i, B, W, M, s);
    case 16: return launch_top2<16>(x1, x2, price, best, better, best_i, B, W, M, s);
    case 32: return launch_top2<32>(x1, x2, price, best, better, best_i, B, W, M, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the window kernel asks for.
static size_t window_smem(int W, int M, int state_in_smem) {
  return (size_t)W * 20 + (state_in_smem ? (size_t)M * 8 : 0);
}

// price and owner are updated in place; x2p is scratch of B * M * 4 floats.
// state_in_smem is the caller's choice and must fit: W * 20 + M * 8 bytes
// within the 232448 a block can have.
extern "C" int ct_emd_auction_window(const float* x1w, const int* j_real,
                                     const float* x2, float* x2p,
                                     float* price, int* owner, int* used,
                                     int B, int W, int M, int n, int rem,
                                     int rounds_cap, float eps,
                                     int state_in_smem, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = window_smem(W, M, state_in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      auction_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  auction_window_kernel<<<(unsigned int)B, kWindowThreads, smem,
                          (cudaStream_t)stream>>>(
      x1w, j_real, x2, reinterpret_cast<float4*>(x2p), price, owner, used, W,
      M, n, rem, rounds_cap, eps, state_in_smem);
  return (int)cudaGetLastError();
}
