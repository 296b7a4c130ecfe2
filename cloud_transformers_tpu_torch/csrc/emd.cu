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
// auction_window replaces pallas_auction_window of the same file
// (cloud_transformers_tpu/ops/pallas_emd.py:373, pallas_call at :417): up
// to rounds_cap whole auction rounds {bid, resolve, assign with eviction}
// for a fixed window of W bidders (the points still unassigned), with the
// price and owner state of all M targets kept on the chip between rounds.
// A lane that wins stops bidding, a lane evicted by another lane of the
// window bids again, an owner outside the window just loses its target;
// per target the highest increment wins, ties to the lowest point id; the
// window ends when no lane is active, after rem rounds or after rounds_cap.
//
// Bound on the H100: operations, the bids the data needs times M pairs of
// top2's cost (the square roots at the special-function rate); for the
// checked call of chip_smoke.py (B = 2, W = 512, M = 16384, 3 rounds from
// a mid-auction state) about 0.004 ms on 132 SMs.  A cluster a row can
// use B * C SMs, so its own ceiling there is about 0.016 ms at C = 16.
//
// Design: a thread-block cluster of C = 16 CTAs (512 threads) per batch
// row, the rounds loop inside, launched with cudaLaunchKernelEx.  CTA r
// owns a slice of L = ceil(M / C) targets and keeps its state in its own
// shared memory: packed (x, y, z, |t|^2), the skip terms with the price,
// a 64-bit bid key and the owner, 44 bytes a target (L = 1024 at M =
// 16384), packed once a launch from the slice alone.  Where a slice does
// not fit beside the lane arrays it stays in scratch in device memory,
// slower and the same.  CTA r also owns W / C lanes (point id, target or
// -1, bid target, increment).  Five phases a round, a cluster.sync() after
// each:
//   bid      every CTA searches its slice for every active lane with
//            top2_kernel's loop (BidderSet: four bidders a lane group,
//            each target read serving four, the exact square-root skip
//            where a lane has 32 targets or more, its threshold shared
//            after the slice's first 64, 128, 256, 512 targets) and
//            writes one partial top two a lane;
//   merge    a warp per own active lane reads the C partials by
//            cluster.map_shared_rank and merges them order-free (bit-equal
//            to one sweep over all M targets); the increment's bits go to
//            the high half of the target's key in its home CTA by a 32-bit
//            distributed shared-memory max;
//   tie      the lanes whose increment stands put the complement of their
//            point id into the low half (max: the lowest id), so the key is
//            the largest (increment, -id) of the target's bidders, the same
//            in every run;
//   apply    the lane whose key stands won and is the target's only writer:
//            price += inc (one __fadd_rn), owner = its id;
//   evict    winners clear their keys; an assigned lane reads its target's
//            owner once and bids again if another lane of the window took
//            it (the window's lanes own nothing when it starts, so this is
//            the JAX kernel's eviction by point id); the own lanes still
//            bidding form the next round's list, and each CTA gathers the
//            cluster's lists (their counts end the window).
// One 64-bit max in place of the two halves loses updates on the card
// (red.shared::cluster.max.u64, and atomicMax through the mapped pointer:
// a contested target can go to a lower increment; splat_variants.py
// --kernel auction_window --variants runs both as key64red and key64).
// What this does about the one-block kernel it replaces: a row spreads over
// C SMs, not one; each target read serves four bidders and most pairs skip
// the square root; the only fixed cost a launch is packing the CTA's own
// slice (no M x 16-byte scratch, no copy of a row's state in and out of
// one block); resolve is O(1) a lane (no scan of the window) and eviction
// one read a lane (no search for the evicted id).  Owner, used and price
// are bit-equal to the plain version on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// the window kernel: threads a CTA, CTAs a batch row's cluster (above 8: a
// non-portable size), the shared memory a CTA can have on an H100
constexpr int kWindowThreads = 512;
constexpr int kWindowCluster = 16;
constexpr int64_t kWindowSmem = 232448;
// targets of a slice between the bid's threshold sharings (after tiles 0,
// 1, 3, 7, ...): a quarter of top2's tile, since a slice is short and the
// first tile goes without a threshold
constexpr int kWindowTile = 64;
// the square-root skip pays where a lane has this many targets or more
constexpr int kTop2SkipMin = 32;
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

// The square-root skip's per-target terms of a target with |t|^2 = sq at
// price p: ((1 - 2^-17) |t|^2 - (1 + 2^-20) c^2, p, c, 0), with c the skip
// threshold's target half, ((3 - p) + 2^-16 (8 + |p|)) (1 + 2^-16).
__device__ __forceinline__ float4 skip_terms(float sq, float p) {
  const float c = ((3.0f - p) + kSkipRel * (8.0f + fabsf(p)))
                  * (1.0f + kSkipRel);
  return make_float4(sq * kSkipSq - c * c * kSkipTh, p, c, 0.0f);
}

// A target as the search reads it: p = (x, y, z, |t|^2) and q =
// skip_terms(|t|^2, price), which holds the price in q.y.
__device__ __forceinline__ void pack_target(float x, float y, float z,
                                            float p, float4* dp,
                                            float4* dq) {
  const float sq = sq_norm(x, y, z);
  *dp = make_float4(x, y, z, sq);
  *dq = skip_terms(sq, p);
}

// top2_kernel's inner loop as the window's bid takes it: four bidders that
// a group of kG neighbouring lanes holds in all its lanes (coordinates,
// |a|^2, a running top two each and the square-root skip's bidder half).
// The group's lanes split the targets; each target a lane reads serves the
// four bidders.  A bidder's skip threshold is the group's second-best (the
// order-free merge of its lanes' top twos, by shuffles after tiles 0, 1,
// 3, 7, 15, ...) or the lane's own second-best, whichever is higher:
// either is backed by two targets that stay in the group's result, so a
// pair below it cannot change the bidder's top two.  (top2_kernel keeps
// the loop written out: called through this struct it compiled to a
// longer kernel that ran slower on the card.)
template <bool kSkip, int kG>
struct BidderSet {
  static_assert(kG >= 8 && kG <= 32, "the merge takes kG / 4 lanes a bidder");
  float ax[kTop2Bidders], ay[kTop2Bidders], az[kTop2Bidders];
  float asq[kTop2Bidders], nx[kTop2Bidders], ny[kTop2Bidders];
  float nz[kTop2Bidders], asq_s[kTop2Bidders], shared_b[kTop2Bidders];
  float b2[kTop2Bidders], bq[kTop2Bidders];
  Top2 s[kTop2Bidders];

  // the skip threshold's bidder half from the second-best it stands for:
  // b = skip_bidder(value), kept as 2 b and (1 - 2^-17) |a|^2 - (1 +
  // 2^-20) b^2
  __device__ __forceinline__ void set_threshold(int q, float value) {
    const float bb = skip_bidder(value);
    b2[q] = 2.0f * bb;
    bq[q] = asq_s[q] - bb * bb * kSkipTh;
  }

  __device__ __forceinline__ void init(int q, const float* a) {
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

  // the packed targets i = sub, sub + kG, ... < cnt of (cp, cq), in rising
  // order; target i has the index k0 + i
  __device__ __forceinline__ void search(const float4* cp, const float4* cq,
                                         int cnt, int k0, int sub) {
#pragma unroll 2
    for (int i = sub; i < cnt; i += kG) {
      const float4 t = cp[i];
      const float4 u = cq[i];
      const int k = k0 + i;
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
          top2_push(s[q], bid_value(ax[q], ay[q], az[q], asq[q], t, u.y), k);
          set_threshold(q, fmaxf(shared_b[q], s[q].better));
        }
      } else {
#pragma unroll
        for (int q = 0; q < kTop2Bidders; ++q)
          top2_push(s[q], bid_value(ax[q], ay[q], az[q], asq[q], t, u.y), k);
      }
    }
  }

  // after tile `tile` of a search: the group's second-best raises the
  // thresholds after tiles 0, 1, 3, 7, ... (every lane of the warp comes)
  __device__ __forceinline__ void share(int tile) {
    if (!kSkip || (tile & (tile + 1)) != 0) return;
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
};

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

// ---- the auction window on a thread-block cluster per batch row -------

// A window CTA's arguments (one struct: a cluster launch takes them by
// cudaLaunchKernelEx).  The state of a slice is in the CTA's shared memory
// (in_smem) or in `scratch`: [B * C * L] packed targets, then as many skip
// terms, keys and owners.
struct WindowArgs {
  const float* x1w;
  const int* j_real;
  const float* x2;
  const float* price;
  const int* owner;
  float* price_out;
  int* owner_out;
  int* used;
  unsigned char* scratch;
  int B, W, M, C, L, WL, n, rem, rounds_cap, in_smem;
  float eps;
};

// A bid's key: the increment's bits above (they sort as unsigned integers,
// the increment being >= 0), the point id's complement below, so that the
// largest key is the highest increment and, among equal ones, the lowest
// id.  The kernel takes the max in two 32-bit passes, the high half first.
__device__ __forceinline__ unsigned long long bid_key(float inc, int j) {
  return ((unsigned long long)__float_as_uint(inc) << 32)
         | (unsigned long long)(0xffffffffu - (unsigned)j);
}

// max(*w, v) into the 32-bit word at w of CTA r's shared memory (w: the
// word's address in this CTA's), a distributed shared-memory reduction
// addressed in the cluster's shared window
__device__ __forceinline__ void cluster_max(unsigned* w, int r, unsigned v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"((unsigned)__cvta_generic_to_shared(w)), "r"(r));
  asm volatile("red.shared::cluster.max.u32 [%0], %1;" ::"r"(remote), "r"(v)
               : "memory");
}

// Phase 1 of a round in one CTA: the top two of every active lane (act[0,
// total)) over the CTA's slice (nk packed targets from index k0), four
// lanes a group of kG threads (a BidderSet), the slice cut into tiles of
// kWindowTile for the threshold's sharing; part[lane] = (best, better,
// index).
// The loops are the same in the whole CTA, so every warp meets its shuffles.
template <bool kSkip, int kG>
__device__ __forceinline__ void window_bid(const WindowArgs& a, int b,
                                           const float4* tp,
                                           const float4* tq, int k0, int nk,
                                           const int* act, int total,
                                           int4* part) {
  constexpr int kGroups = kWindowThreads / kG;
  const int sub = threadIdx.x % kG;
  const int sets = (total + kTop2Bidders - 1) / kTop2Bidders;
  const int tiles = (nk + kWindowTile - 1) / kWindowTile;
  for (int s0 = 0; s0 < sets; s0 += kGroups) {
    const int set = s0 + threadIdx.x / kG;
    const bool busy = set < sets;   // the same in the whole group
    BidderSet<kSkip, kG> bs;
    int lane[kTop2Bidders];
#pragma unroll
    for (int q = 0; q < kTop2Bidders; ++q) {
      lane[q] = act[min(set * kTop2Bidders + q, total - 1)];
      bs.init(q, a.x1w + ((int64_t)b * a.W + lane[q]) * 3);
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int base = tile * kWindowTile;
      bs.search(tp + base, tq + base,
                busy ? min(kWindowTile, nk - base) : 0, k0 + base, sub);
      bs.share(tile);
    }
#pragma unroll
    for (int q = 0; q < kTop2Bidders; ++q) {
      top2_merge_lanes(bs.s[q], kG);
      if (sub == 0 && busy && set * kTop2Bidders + q < total)
        part[lane[q]] = make_int4(__float_as_int(bs.s[q].best),
                                  __float_as_int(bs.s[q].better),
                                  bs.s[q].idx, 0);
    }
  }
}

// Batch row b on the cluster of C CTAs blockIdx.x / C.  CTA `rank` owns the
// targets [rank * L, min(M, (rank + 1) * L)) (its slice: packed target,
// skip terms with the price, bid key, owner) and the lanes [rank * WL,
// min(W, (rank + 1) * WL)) (point id, target or -1, bid target,
// increment).  Dynamic shared memory: part [W] int4, the slice's state if
// in_smem (L x 44 bytes), act [W], jr, la, bi, inc [WL], the own lanes
// still bidding as two lists [2][WL] (a round reads one and writes the
// other), their counts [2] and the cluster's list offsets [C + 1].
__global__ void __launch_bounds__(kWindowThreads, 1)
auction_window_kernel(const WindowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, L = a.L, WL = a.WL, W = a.W, M = a.M;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  int4* part = reinterpret_cast<int4*>(smem);
  unsigned char* rest = smem + (size_t)16 * W;
  float4 *tp, *tq;
  unsigned long long* key;
  int* ow;
  if (a.in_smem) {
    tp = reinterpret_cast<float4*>(rest);
    tq = tp + L;
    key = reinterpret_cast<unsigned long long*>(tq + L);
    ow = reinterpret_cast<int*>(key + L);
    rest = reinterpret_cast<unsigned char*>(ow + L);
  } else {
    const int64_t all = (int64_t)a.B * C * L;
    const int64_t at = ((int64_t)b * C + rank) * L;
    tp = reinterpret_cast<float4*>(a.scratch) + at;
    tq = reinterpret_cast<float4*>(a.scratch) + all + at;
    key = reinterpret_cast<unsigned long long*>(
              reinterpret_cast<float4*>(a.scratch) + 2 * all) + at;
    ow = reinterpret_cast<int*>(
             reinterpret_cast<unsigned long long*>(
                 reinterpret_cast<float4*>(a.scratch) + 2 * all) + all) + at;
  }
  int* act = reinterpret_cast<int*>(rest);
  int* jr = act + W;
  int* la = jr + WL;
  int* bi = la + WL;
  float* inc = reinterpret_cast<float*>(bi + WL);
  int* lst = reinterpret_cast<int*>(inc + WL);
  int* cnt = lst + 2 * WL;
  int* off = cnt + 2;
  // rank r's copy of a slice array: another CTA's shared memory, or its
  // part of the scratch
  auto slice = [&](auto* p, int r) {
    return a.in_smem ? cluster.map_shared_rank(p, r)
                     : p + (int64_t)(r - rank) * L;
  };
  // max(half, v) into half `hi` of target t's key in its home CTA
  auto key_half = [&](int t, int hi, unsigned v) {
    const int h = t / L;
    unsigned* w = reinterpret_cast<unsigned*>(key + (t - h * L)) + hi;
    if (a.in_smem)
      cluster_max(w, h, v);
    else
      atomicMax(w + (int64_t)(h - rank) * L * 2, v);
  };
  const int k0 = rank * L;
  const int nk = max(0, min(M, k0 + L) - k0);
  const int l0 = rank * WL;
  const int nl = max(0, min(W, l0 + WL) - l0);
  {
    const float* xs = a.x2 + ((int64_t)b * M + k0) * 3;
    const float* ps = a.price + (int64_t)b * M + k0;
    const int* os = a.owner + (int64_t)b * M + k0;
    for (int i = tid; i < nk; i += kWindowThreads) {
      pack_target(xs[3 * i], xs[3 * i + 1], xs[3 * i + 2], ps[i], tp + i,
                  tq + i);
      ow[i] = os[i];
      key[i] = 0ull;
    }
  }
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();
  for (int i = tid; i < nl; i += kWindowThreads) {
    const int j = a.j_real[(int64_t)b * W + l0 + i];
    jr[i] = j;
    la[i] = -1;
    if (j < a.n) lst[atomicAdd(cnt, 1)] = l0 + i;
  }
  // after a cluster.sync(): the window's active lanes, from every CTA's
  // list `par`, into act (in rank order); -> their number
  auto gather = [&](int par) {
    if (warp == 0) {
      const int c = lid < C ? *cluster.map_shared_rank(cnt + par, lid) : 0;
      int sum = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, sum, d);
        if (lid >= d) sum += o;
      }
      if (lid < C) off[lid + 1] = sum;
      if (lid == 0) off[0] = 0;
    }
    __syncthreads();
    const int total = off[C];
    for (int i = tid; i < total; i += kWindowThreads) {
      int r = 0;
      while (off[r + 1] <= i) ++r;
      act[i] = *cluster.map_shared_rank(lst + par * WL + (i - off[r]), r);
    }
    __syncthreads();
    return total;
  };
  cluster.sync();   // the slices are loaded, the first lists written
  int total = gather(0);
  int rounds = 0;
  for (int r = 0; r < a.rounds_cap && r < a.rem && total > 0; ++r) {
    const int par = r & 1;
    const int own = cnt[par];
    const int* mine = lst + par * WL;
    // 1. bid: every CTA searches its slice for every active lane, with the
    // lane group that takes the fewest steps: passes over the lane sets
    // times targets a lane
    {
      const int sets = (total + kTop2Bidders - 1) / kTop2Bidders;
      int g = 8, steps = 0x7fffffff;
      for (int t = 8; t <= 32; t *= 2) {
        const int cost = (sets + kWindowThreads / t - 1) / (kWindowThreads / t)
                         * ((nk + t - 1) / t);
        if (cost < steps) {
          steps = cost;
          g = t;
        }
      }
      const bool skip = nk >= kTop2SkipMin * g;
#define CT_WINDOW_BID(S, G) \
  window_bid<S, G>(a, b, tp, tq, k0, nk, act, total, part)
      if (g == 8) {
        if (skip) CT_WINDOW_BID(true, 8); else CT_WINDOW_BID(false, 8);
      } else if (g == 16) {
        if (skip) CT_WINDOW_BID(true, 16); else CT_WINDOW_BID(false, 16);
      } else {
        if (skip) CT_WINDOW_BID(true, 32); else CT_WINDOW_BID(false, 32);
      }
#undef CT_WINDOW_BID
    }
    cluster.sync();
    // 2. a warp per own active lane merges the C partial results (lane c
    // reads CTA c's; the merge is order-free), and the increment's bits go
    // to the high half of its target's key in the target's home CTA (max)
    for (int e = warp; e < own; e += kWindowThreads / 32) {
      const int lane = mine[e];
      Top2 m = {kNeg, kNeg, 0x7fffffff};
      if (lid < C) {
        const int4 v = *cluster.map_shared_rank(part + lane, lid);
        m = Top2{__int_as_float(v.x), __int_as_float(v.y), v.z};
      }
      top2_merge_lanes(m, 32);
      if (lid == 0) {
        const int i = lane - l0;
        const float d = __fadd_rn(__fsub_rn(m.best, m.better), a.eps);
        bi[i] = m.idx;
        inc[i] = d;
        key_half(m.idx, 1, __float_as_uint(d));
      }
    }
    cluster.sync();
    // 3. the lanes whose increment stands put their id's complement into
    // the low half (max: the lowest id)
    for (int e = tid; e < own; e += kWindowThreads) {
      const int i = mine[e] - l0;
      const int t = bi[i];
      const unsigned* high =
          reinterpret_cast<const unsigned*>(slice(key, t / L) + t % L) + 1;
      if (*high == __float_as_uint(inc[i]))
        key_half(t, 0, 0xffffffffu - (unsigned)jr[i]);
    }
    if (tid == 0) cnt[par ^ 1] = 0;
    cluster.sync();
    // 4. resolve and apply: the lane whose key stands at its target won;
    // it is the target's only writer this round
    for (int e = tid; e < own; e += kWindowThreads) {
      const int i = mine[e] - l0;
      const int t = bi[i], h = t / L, k = t % L;
      if (slice(key, h)[k] == bid_key(inc[i], jr[i])) {
        float4* q = slice(tq, h) + k;
        *q = skip_terms(slice(tp, h)[k].w, __fadd_rn(q->y, inc[i]));
        slice(ow, h)[k] = jr[i];
        la[i] = t;
      }
    }
    cluster.sync();
    // 5. the winners clear their targets' keys; an assigned lane whose
    // target has another owner now was evicted by a lane of the window and
    // bids again; the own lanes still bidding form the next list
    for (int e = tid; e < own; e += kWindowThreads) {
      const int t = la[mine[e] - l0];
      if (t >= 0) slice(key, t / L)[t % L] = 0ull;
    }
    for (int i = tid; i < nl; i += kWindowThreads) {
      int t = la[i];
      if (t >= 0 && slice(ow, t / L)[t % L] != jr[i]) la[i] = t = -1;
      if (t < 0 && jr[i] < a.n)
        lst[(par ^ 1) * WL + atomicAdd(cnt + (par ^ 1), 1)] = l0 + i;
    }
    cluster.sync();
    ++rounds;
    total = gather(par ^ 1);
  }
  {
    float* po = a.price_out + (int64_t)b * M + k0;
    int* oo = a.owner_out + (int64_t)b * M + k0;
    for (int i = tid; i < nk; i += kWindowThreads) {
      po[i] = tq[i].y;
      oo[i] = ow[i];
    }
  }
  if (rank == 0 && tid == 0) a.used[b] = rounds;
  cluster.sync();   // no CTA leaves while another may read its lists
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

// Shared memory of a window CTA: the lane arrays (W lanes, WL of its own)
// and a slice's state (L targets).
static int64_t window_lane_bytes(int W, int WL) {
  return (int64_t)20 * W + (int64_t)24 * WL + 4 * (2 + kWindowCluster + 1);
}
static int64_t window_state_bytes(int L) { return (int64_t)44 * L; }

// The window on the caller's plan (auction_window_plan), one cluster launch.
// Its integers come as one host array p, cached per shape by the wrapper:
// B, W, M, then the cluster's CTAs C (kWindowCluster), its threads, the
// slice length L = ceil(M / C), the lanes a CTA owns WL = ceil(W / C), the
// dynamic shared memory and whether the state is in it (else `scratch`
// holds B * C * L * 44 bytes).  price and owner are read, price_out and
// owner_out written (no two of them alias).  The entry point recomputes the
// plan's arithmetic and launches nothing when it disagrees; a cluster
// launch that the card refuses returns its error.
extern "C" int ct_emd_auction_window(const float* x1w, const int* j_real,
                                     const float* x2, const float* price,
                                     const int* owner, float* price_out,
                                     int* owner_out, int* used,
                                     void* scratch, const int* p, int n,
                                     int rem, int rounds_cap, float eps,
                                     void* stream) {
  const int B = p[0], W = p[1], M = p[2], C = p[3], threads = p[4],
            L = p[5], WL = p[6], smem = p[7], in_smem = p[8];
  if (B <= 0) return 0;
  if (W <= 0 || M <= 0 || C != kWindowCluster || threads != kWindowThreads ||
      L != (M + C - 1) / C || WL != (W + C - 1) / C ||
      (in_smem != 0 && in_smem != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t lane = window_lane_bytes(W, WL);
  const int64_t state = window_state_bytes(L);
  if (lane > kWindowSmem || (in_smem && lane + state > kWindowSmem) ||
      smem != lane + in_smem * state || (!in_smem && scratch == nullptr) ||
      (int64_t)B * C > 0x7fffffff || (int64_t)B * M * 3 >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      auction_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == 0 && C > 8)
    err = (int)cudaFuncSetAttribute(
        auction_window_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  if (err != 0) return err;
  const WindowArgs a = {x1w, j_real, x2, price, owner, price_out, owner_out,
                        used, static_cast<unsigned char*>(scratch), B, W, M,
                        C, L, WL, n, rem, rounds_cap, in_smem, eps};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kWindowThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, auction_window_kernel, a);
  return err != 0 ? err : (int)cudaGetLastError();
}
