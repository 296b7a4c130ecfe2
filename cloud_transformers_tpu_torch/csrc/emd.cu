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
// Design: the N-body shape turned so that lanes share bidders, in one
// launch.  A group of G lanes (G = 8, 16 or 32) holds the same 4 bidders
// (coordinates, |a|^2, and per lane a running best, second-best and index,
// in registers) and splits the targets: lane r takes r, r + G, ... of each
// tile, in rising k, so the first occurrence of the best is kept by strict
// comparison.  A block is 256 threads; its targets come in tiles of 256,
// packed into one of two shared-memory buffers as (x, y, z, |t|^2) and the
// skip's per-target terms: the next tile's coordinates and prices are
// loaded into registers before the current tile is searched and packed
// after it, one barrier a tile.  Each target a lane reads serves its four
// bidders.  At the end the group's lanes meet by shuffles in the order-free
// merge: best = max, the lower index on equal best, second-best =
// max(min(best_1, best_2), max(second_1, second_2)); it is commutative and
// associative, so the result does not depend on how the targets were cut.
// Where B * W is small the targets are also cut into chunks across blocks;
// each block writes its partial results, and the last block of a row of
// chunks to arrive (an integer arrival count, no float atomics) merges
// them.  The caller's cached top2_plan picks G and the chunks so that
// every width of the staged schedule (W = 16384 down to 256, B = 2 in
// training, 1 in evaluation) has about 256 blocks, two on each of the 132
// SMs; the entry point recomputes the plan's arithmetic and refuses a
// launch that disagrees.  The [.., 8] lane padding, the 1e6 dummy targets
// and the tile-height rules of the TPU kernel are not carried over.
//
// Why lanes share bidders: the skip below leaves a warp on the exact path
// whenever one of its lanes needs it.  With 32 different bidders in a warp
// (a thread a bidder) that happened for about a sixth of the targets; with
// G lanes on the same bidders and a threshold shared by the group it is a
// few percent, and a group's sharing costs a few shuffles after tiles 0,
// 1, 3, 7, 15, ...
//
// The square-root skip (where a lane has at least 32 targets of its
// chunk): before the exact value, a lower bound of d^2 - (c - b)^2 is made
// with four fused multiply-adds, where c = ((3 - price) + 2^-16 (8 +
// |price|)) (1 + 2^-16) is the target's half of the threshold and b =
// (v - 2^-16 |v|) (1 + 2^-16) the bidder's, from the highest second-best v
// that the group or the lane holds; |a|^2 and |t|^2 enter 2^-17 low and
// c^2 + b^2 2^-20 high.  If the bound is >= 0 the exact value is below v,
// which two targets that stay in the group's result back, so the pair
// would change nothing and is skipped; each margin is at least 5 times the
// float32 rounding it covers, in the exact path and in the bound.  A
// skipped pair costs 5 operations and a share of one branch, an evaluated
// one about 30 (the IEEE square root is a special-function operation and a
// correction sequence).
//
// Arithmetic: float32, every multiply, add and subtract of the value
// through the round-to-nearest intrinsics, so nothing contracts to an FMA,
// and the square root is the IEEE one (no --use_fast_math).  The plain
// PyTorch version does the same operations in the same order, each
// rounded, so on the card the two agree bit for bit and the argmax with
// them; against the JAX package (whose cross term comes from a matrix
// unit) values agree to float32 rounding of numbers near 3, a few 1e-7.
//
// Bound on the H100: operations.  B * W * M pairs of 12 float32 operations
// and one square root, against 12 bytes per bidder and 16 per target read
// once.  The square root goes through the special-function unit (16 a clock
// on each SM against 128 float32 lanes), which makes it the tighter limit.
// What holds the kernel above it: the unfused arithmetic takes 12
// instruction slots a pair where the bound counts FMA-rate operations, and
// the top-two update several more; the skip takes the square root and the
// update off most pairs at the price of 5 slots each.
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

constexpr int kTop2Threads = 256;   // top2 block (top2_plan's threads)
constexpr int kTop2Bidders = 4;     // bidders a top2 lane group holds
constexpr int kTop2Tile = 256;      // targets a staged tile (8 KiB)
// the square-root skip's margins: 2^-16 of the values' scale, 2^-17 of
// |a|^2 + |t|^2 and 2^-20 of the threshold's square, each several times
// the float32 rounding it covers
constexpr float kSkipRel = 1.52587890625e-05f;   // 2^-16
constexpr float kSkipSq = 0.999992370605f;       // 1 - 2^-17
constexpr float kSkipTh = 1.00000095367f;        // 1 + 2^-20
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

// The skip threshold's bidder half: (better - 2^-16 |better|) (1 + 2^-16).
__device__ __forceinline__ float skip_bidder(float better) {
  return (better - kSkipRel * fabsf(better)) * (1.0f + kSkipRel);
}

// A target as the search reads it from shared memory: p = (x, y, z,
// |t|^2) and q = ((1 - 2^-17) |t|^2 - (1 + 2^-20) c^2, price, c, 0) with c
// the skip threshold's target half, ((3 - price) + 2^-16 (8 + |price|))
// (1 + 2^-16).
__device__ __forceinline__ void pack_target(float x, float y, float z,
                                            float p, float4* dp,
                                            float4* dq) {
  const float sq = sq_norm(x, y, z);
  const float c = ((3.0f - p) + kSkipRel * (8.0f + fabsf(p)))
                  * (1.0f + kSkipRel);
  *dp = make_float4(x, y, z, sq);
  *dq = make_float4(sq * kSkipSq - c * c * kSkipTh, p, c, 0.0f);
}

// Block (bx, chunk, b): a group of kG neighbouring lanes holds the 4
// bidders (bx * (256 / kG) + g) * 4 + q of group g, the same in all its
// lanes, against the targets [chunk * chunk_len, min(M, (chunk + 1) *
// chunk_len)).  The targets come in tiles of kTop2Tile, packed into one of
// two shared-memory buffers by the block's first kTop2Tile threads: the
// next tile's coordinates and prices are loaded into registers before the
// current tile is searched and packed after it, one barrier a tile.  Lane
// r of a group takes the targets r, r + kG, ... of each tile, in rising
// order, with a running top two per bidder; each target it reads serves
// the four bidders.  A bidder's skip threshold is the group's second-best
// (the order-free merge of its lanes' top twos, by shuffles after tiles 0,
// 1, 3, 7, 15, ...) or the lane's own second-best, whichever is higher:
// either is backed by two targets that stay in the group's result, so a
// pair below it cannot change the bidder's top two.  The group's lanes
// then meet by shuffles.  With one chunk the block writes the result; with
// more it writes row chunk * B + b of the partial results [chunks, B, W],
// and the last of the chunks' blocks of (bx, b) to arrive (an arrival
// count in `arrived`, which it sets back to 0) merges them.
template <bool kSkip, int kG>
__global__ void __launch_bounds__(kTop2Threads)
top2_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ price, float* __restrict__ best,
            float* __restrict__ better, int* __restrict__ best_i,
            float* __restrict__ pb, float* __restrict__ ps,
            int* __restrict__ pi, int* __restrict__ arrived, int B, int W,
            int M, int chunk_len) {
  static_assert(kG >= 8 && kG <= 32, "the merge takes kG / 4 lanes a bidder");
  constexpr int kGroups = kTop2Threads / kG;
  constexpr int kPerBlock = kGroups * kTop2Bidders;
  __shared__ __align__(16) float4 s_p[2][kTop2Tile];
  __shared__ __align__(16) float4 s_q[2][kTop2Tile];
  __shared__ int s_last;
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int sub = threadIdx.x % kG;
  const int j0 = (blockIdx.x * kGroups + threadIdx.x / kG) * kTop2Bidders;
  const int k0 = chunk * chunk_len;
  const int k1 = min(M, k0 + chunk_len);
  float ax[kTop2Bidders], ay[kTop2Bidders], az[kTop2Bidders];
  float asq[kTop2Bidders], nx[kTop2Bidders], ny[kTop2Bidders];
  float nz[kTop2Bidders], asq_s[kTop2Bidders], shared_b[kTop2Bidders];
  float b2[kTop2Bidders], bq[kTop2Bidders];
  Top2 s[kTop2Bidders];
  // the skip threshold's bidder half from the second-best it stands for:
  // b = skip_bidder(value), kept as 2 b and (1 - 2^-17) |a|^2 - (1 +
  // 2^-20) b^2
  auto set_threshold = [&](int q, float value) {
    const float bb = skip_bidder(value);
    b2[q] = 2.0f * bb;
    bq[q] = asq_s[q] - bb * bb * kSkipTh;
  };
#pragma unroll
  for (int q = 0; q < kTop2Bidders; ++q) {
    const int j = min(j0 + q, W - 1);   // a bidder past W computes, unread
    const float* a = x1 + ((int64_t)b * W + j) * 3;
    ax[q] = a[0];
    ay[q] = a[1];
    az[q] = a[2];
    asq[q] = sq_norm(ax[q], ay[q], az[q]);
    nx[q] = -2.0f * ax[q];
    ny[q] = -2.0f * ay[q];
    nz[q] = -2.0f * az[q];
    asq_s[q] = asq[q] * kSkipSq;
    s[q] = Top2{kNeg, kNeg, 0};
    shared_b[q] = kNeg;
    set_threshold(q, kNeg);
  }
  const bool busy = j0 < W;   // the same in the whole group
  const float* gx = x2 + ((int64_t)b * M + k0) * 3;
  const float* gpr = price + (int64_t)b * M + k0;
  const int n = k1 - k0;
  const int tiles = (n + kTop2Tile - 1) / kTop2Tile;
  // the staging thread's target of the next tile, in registers
  float tx = 0.f, ty = 0.f, tz = 0.f, tpr = 0.f;
  auto fetch = [&](int tile) {
    const int i = tile * kTop2Tile + threadIdx.x;
    if (threadIdx.x < kTop2Tile && i < n) {
      tx = gx[3 * i];
      ty = gx[3 * i + 1];
      tz = gx[3 * i + 2];
      tpr = gpr[i];
    }
  };
  auto pack = [&](int tile) {
    if (threadIdx.x < kTop2Tile && tile * kTop2Tile + threadIdx.x < n)
      pack_target(tx, ty, tz, tpr, &s_p[tile & 1][threadIdx.x],
                  &s_q[tile & 1][threadIdx.x]);
  };
  fetch(0);
  pack(0);
  for (int tile = 0; tile < tiles; ++tile) {
    // the tile is packed, and every thread is done with the buffer that
    // the next tile goes to
    __syncthreads();
    if (tile + 1 < tiles) fetch(tile + 1);
    const int base = tile * kTop2Tile;
    const int cnt = busy ? min(kTop2Tile, n - base) : 0;
    const float4* cp = s_p[tile & 1];
    const float4* cq = s_q[tile & 1];
#pragma unroll 2
    for (int i = sub; i < cnt; i += kG) {
      const float4 t = cp[i];
      const float4 u = cq[i];
      const int k = k0 + base + i;
      if (kSkip) {
        // per bidder a lower bound of d^2 less the threshold's square,
        // (c - b)^2: where it is >= 0 the value is below a second-best the
        // group holds and would change nothing; the four tests first, then
        // one branch for the target
        bool skip_all = true;
        bool keep[kTop2Bidders];
#pragma unroll
        for (int q = 0; q < kTop2Bidders; ++q) {
          float e = __fmaf_rn(b2[q], u.z, u.x + bq[q]);
          e = __fmaf_rn(nx[q], t.x, e);
          e = __fmaf_rn(ny[q], t.y, e);
          e = __fmaf_rn(nz[q], t.z, e);
          keep[q] = !(e >= 0.0f);
          skip_all &= !keep[q];
        }
        if (skip_all) continue;
#pragma unroll
        for (int q = 0; q < kTop2Bidders; ++q) {
          if (!keep[q]) continue;
          top2_push(s[q], bid_value(ax[q], ay[q], az[q], asq[q], t, u.y),
                    k);
          set_threshold(q, fmaxf(shared_b[q], s[q].better));
        }
      } else {
#pragma unroll
        for (int q = 0; q < kTop2Bidders; ++q)
          top2_push(s[q], bid_value(ax[q], ay[q], az[q], asq[q], t, u.y),
                    k);
      }
    }
    if (kSkip && kG > 1 && (tile & (tile + 1)) == 0) {
#pragma unroll
      for (int q = 0; q < kTop2Bidders; ++q) {
        float v1 = s[q].best, v2 = s[q].better;
#pragma unroll
        for (int off = kG >> 1; off > 0; off >>= 1) {
          const float o1 = __shfl_xor_sync(kFull, v1, off);
          const float o2 = __shfl_xor_sync(kFull, v2, off);
          v2 = fmaxf(fminf(v1, o1), fmaxf(v2, o2));
          v1 = fmaxf(v1, o1);
        }
        shared_b[q] = fmaxf(shared_b[q], v2);
        set_threshold(q, fmaxf(shared_b[q], s[q].better));
      }
    }
    if (tile + 1 < tiles) pack(tile + 1);
  }
#pragma unroll
  for (int q = 0; q < kTop2Bidders; ++q) {
    top2_merge_lanes(s[q], kG);
    if (sub == 0 && j0 + q < W) {
      const int64_t o = (chunks == 1 ? 0 : (int64_t)chunk * B * W)
                        + (int64_t)b * W + j0 + q;
      (chunks == 1 ? best : pb)[o] = s[q].best;
      (chunks == 1 ? better : ps)[o] = s[q].better;
      (chunks == 1 ? best_i : pi)[o] = s[q].idx;
    }
  }
  if (chunks == 1) return;
  // the partial results of this block are written before it counts itself
  if (sub == 0) __threadfence();
  __syncthreads();
  int* count = arrived + (int64_t)b * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) s_last = atomicAdd(count, 1) == chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: kTop2Threads / kPerBlock lanes a bidder take the
  // chunks c = l, l + lanes, ... (read past L1: other blocks wrote them),
  // then meet by shuffles
  constexpr int kLanes = kTop2Threads / kPerBlock;
  const int jm = blockIdx.x * kPerBlock + threadIdx.x / kLanes;
  const int64_t row = (int64_t)b * W + min(jm, W - 1);
  Top2 m = {kNeg, kNeg, 0};
  for (int c = threadIdx.x % kLanes; c < chunks; c += kLanes) {
    const int64_t o = (int64_t)c * B * W + row;
    const float ob = __ldcg(pb + o), obt = __ldcg(ps + o);
    const int oi = __ldcg(pi + o);
    const float nbetter = fmaxf(fminf(m.best, ob), fmaxf(m.better, obt));
    if (ob > m.best || (ob == m.best && oi < m.idx)) m.idx = oi;
    m.best = fmaxf(m.best, ob);
    m.better = nbetter;
  }
  top2_merge_lanes(m, kLanes);
  if (threadIdx.x % kLanes == 0 && jm < W) {
    best[row] = m.best;
    better[row] = m.better;
    best_i[row] = m.idx;
  }
  if (threadIdx.x == 0) *count = 0;   // ready for the next call
}

template <int kG>
void launch_top2_search(dim3 grid, cudaStream_t s, int skip, const float* x1,
                        const float* x2, const float* price, float* best,
                        float* better, int* best_i, float* pb, float* ps,
                        int* pi, int* arrived, int B, int W, int M,
                        int chunk_len) {
  if (skip)
    top2_kernel<true, kG><<<grid, kTop2Threads, 0, s>>>(
        x1, x2, price, best, better, best_i, pb, ps, pi, arrived, B, W, M,
        chunk_len);
  else
    top2_kernel<false, kG><<<grid, kTop2Threads, 0, s>>>(
        x1, x2, price, best, better, best_i, pb, ps, pi, arrived, B, W, M,
        chunk_len);
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

// The bid search on the caller's plan (top2_plan), one launch.  Its
// integers come as one host array p, cached per shape by the wrapper (one
// ctypes argument instead of nine; ctypes converts every argument on every
// call): B, W, M, then `threads` a block, `group` lanes (8, 16 or 32) to a
// set of 4 bidders, `bidder_blocks` blocks of bidders per batch row, the
// targets in `chunks` chunks of `chunk_len`, and `skip`, which turns the
// exact square-root skip on.  With more than one chunk, `scratch` holds 3 *
// chunks * B * W words of partial results and `arrived` B * bidder_blocks
// ints that are 0 (the kernel leaves them 0 again; calls that may overlap
// need counts of their own).  The entry point recomputes the plan's
// arithmetic and launches nothing when it disagrees.
extern "C" int ct_emd_top2(const float* x1, const float* x2,
                           const float* price, float* best, float* better,
                           int* best_i, float* scratch, int* arrived,
                           const int* p, void* stream) {
  const int B = p[0], W = p[1], M = p[2], threads = p[3], group = p[4],
            bidder_blocks = p[5], chunks = p[6], chunk_len = p[7],
            skip = p[8];
  if (B <= 0 || W <= 0) return 0;
  if (group != 8 && group != 16 && group != 32)
    return (int)cudaErrorInvalidValue;
  const int per_block = kTop2Threads / group * kTop2Bidders;
  if (M <= 0 || threads != kTop2Threads ||
      bidder_blocks != (W + per_block - 1) / per_block || chunks <= 0 ||
      chunks > 65535 || B > 65535 || chunk_len <= 0 ||
      (int64_t)chunk_len * chunks < M ||
      (int64_t)chunk_len * (chunks - 1) >= M ||
      (int64_t)B * M * 3 >= ((int64_t)1 << 31) ||
      (chunks > 1 && (scratch == nullptr || arrived == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pb = scratch;
  float* ps = pb + (chunks > 1 ? (int64_t)chunks * B * W : 0);
  int* pi = reinterpret_cast<int*>(ps + (chunks > 1 ? (int64_t)chunks * B * W
                                                     : 0));
  const dim3 grid((unsigned)bidder_blocks, (unsigned)chunks, (unsigned)B);
  switch (group) {
#define CT_TOP2(G)                                                         \
  case G:                                                                  \
    launch_top2_search<G>(grid, s, skip, x1, x2, price, best, better,      \
                          best_i, pb, ps, pi, arrived, B, W, M, chunk_len); \
    break
    CT_TOP2(8);
    CT_TOP2(16);
    CT_TOP2(32);
#undef CT_TOP2
  }
  return (int)cudaGetLastError();
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
