// The pair sweep's kernels for Hopper (sm_90a): K2 (conservative cull), K3
// (per-ray refine, with the walk order it feeds), K5 (the windowed walk's
// window refine) and K4 (the candidate walk and sweep, which also serves K6
// and the windowed walk's rounds).
//
// Each one computes exactly what its plain torch version in
// accel/pairs.py computes, op for op (built with -fmad=false, so no product
// and sum fuse, and without fast math, so 1/x is IEEE division). Layouts:
// rays ride structure-of-arrays, [rows, n] with n = B * BLOCK sorted lanes;
// block b owns lanes [b * BLOCK, (b + 1) * BLOCK).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "candidate_test.cuh"

namespace {

using akr::kInf;

// ---------------------------------------------------------------------- K2
// Replaces akari_render_tpu/accel/pairs.py::_cull_kernel (via _cull_einit).
// The conservative block-interval cull: each (block, cluster) element runs
// the interval chain (origin box x inverse-direction interval against the
// cluster's slabs, per axis), clamps entry by the block's min tmin and
// exit by its max t-limit, and writes the entry or +inf. The chain is 88
// FP32 operations (interval_entry: per axis 4 subtractions, 8 products,
// 12 min/max for the two interval products and 4 for entry and exit; then
// two clamps, the compare and the select).
//
// Bound: writing e_con, [B, K] f32 (75 MB at 1920x1080 with K = 4,633),
// unless every element runs the full chain: 88 operations an element
// against 4 bytes lie just above the card's 67 TFLOP/s : 3.35 TB/s. The
// earlier kernel (one thread an element) issued ~150 instructions an
// element (a 64-bit division, 6 box and 16 summary loads, the chain): it
// was issue-bound at several times the bound. What the design does:
// 1. Tiles. A CTA takes kCullBlocks ray blocks x kCullClusters clusters.
//    The tile's summaries go into shared memory once (read back as
//    broadcasts), each thread holds its cluster's box in registers and
//    loops over the blocks, and each block's row of stores coalesces
//    across the tile's clusters, two rows an iteration. No division.
// 2. Cases, each exact (pairs.py::cull_einit_cased_torch is this kernel
//    step for step in torch, held bit for bit against the chain):
//    - a dead block (min tmin > max t-limit: entry >= min tmin > max
//      t-limit >= exit) culls every cluster: its row is +inf, no chain;
//    - a sign case: a block whose inverse-direction interval lies strictly
//      on one side of zero on every axis (the summary is per block, so the
//      branch is uniform), against a cluster whose box has min <= max on
//      every axis. An axis's entry, the least of the chain's 8 products,
//      is then the least of the 4 products of n0lo = bmin - ohi and n1hi =
//      bmax - olo (the n farthest down and up) with the interval's ends,
//      and its exit the largest of them: with the inverse direction of one
//      sign a product is monotone in n. Rounding is monotone too, so the
//      value is the chain's, and a nonzero value has one bit pattern: where
//      both are nonzero on every axis the bits are the chain's (no product
//      is NaN: the bounds and ends are ordered, the ends finite and
//      nonzero).
//      Elsewhere (a signed zero, an underflow) the element runs the full
//      chain, out of line. That is 2 subtractions, 4 products, 6 min/max,
//      2 zero tests, entry and exit per axis: 52 operations an element in
//      place of 88, with no select or shared load inside the chain.
//    - every other block (an axis that straddles zero) runs the chain.
// K3 and K5 keep the chain (interval_entry) for their warp summaries.
constexpr int kCullClusters = 128;  // a tile's clusters: one a thread
constexpr int kCullBlocks = 16;     // a tile's ray blocks: each thread loops over them
constexpr bool kCullCases = true;   // the dead-block and sign cases (else the chain everywhere)
// a summary's flags, kept in its pad slot [15] in shared memory
constexpr int kCullDead = 1, kCullCased = 2;

// K2's chain for one interval summary s[16] (olo xyz | ohi xyz | ilo xyz |
// ihi xyz | min tmin | max t-limit) against one box (bmin, bmax xyz): the
// entry, or +inf where the box is rejected. It is conservative: a lane whose
// origin, inverse direction and limits lie in the summary's intervals and
// whose own slab test (K3's) passes the box has near >= the entry and far
// <= the exit, since rounding is monotone (the lane's (bound - o) lies
// between the rounded ends of the interval's, and a product is extreme at
// its intervals' corners).
__device__ __forceinline__ float interval_entry(const float* __restrict__ s, const float* bmin,
                                                const float* bmax) {
  float entry = -kInf, exit_ = kInf;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float olo = s[a], ohi = s[3 + a], il = s[6 + a], ih = s[9 + a];
    const float n0lo = bmin[a] - ohi, n0hi = bmin[a] - olo;
    const float n1lo = bmax[a] - ohi, n1hi = bmax[a] - olo;
    float p1 = n0lo * il, p2 = n0lo * ih, p3 = n0hi * il, p4 = n0hi * ih;
    const float t0lo = fminf(fminf(p1, p2), fminf(p3, p4));
    const float t0hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    p1 = n1lo * il; p2 = n1lo * ih; p3 = n1hi * il; p4 = n1hi * ih;
    const float t1lo = fminf(fminf(p1, p2), fminf(p3, p4));
    const float t1hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    entry = fmaxf(entry, fminf(t0lo, t1lo));
    exit_ = fminf(exit_, fmaxf(t0hi, t1hi));
  }
  entry = fmaxf(entry, s[12]);  // min tmin
  exit_ = fminf(exit_, s[13]);  // max t-limit
  return entry <= exit_ ? entry : kInf;
}

// The sign case of interval_entry (note 2 above) on a summary whose flags
// say cased: returns false where it cannot vouch for the chain's bits.
__device__ __forceinline__ bool cased_entry(const float* __restrict__ s, const float* bmin,
                                            const float* bmax, float& e) {
  float entry = -kInf, exit_ = kInf;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float il = s[6 + a], ih = s[9 + a];
    const float n0lo = bmin[a] - s[3 + a], n1hi = bmax[a] - s[a];
    const float p1 = n0lo * il, p2 = n0lo * ih, p3 = n1hi * il, p4 = n1hi * ih;
    const float lo = fminf(fminf(p1, p2), fminf(p3, p4));
    const float hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    ok = ok && fabsf(lo) > 0.f && fabsf(hi) > 0.f;  // false for +-0
    entry = fmaxf(entry, lo);
    exit_ = fminf(exit_, hi);
  }
  entry = fmaxf(entry, s[12]);
  exit_ = fminf(exit_, s[13]);
  e = entry <= exit_ ? entry : kInf;
  return ok;
}

// The full chain out of line, so that the rare element of a cased block
// that needs it branches to it instead of predicating it everywhere.
__device__ __noinline__ float interval_entry_call(const float* s, float x0, float y0, float z0,
                                                  float x1, float y1, float z1) {
  const float bmin[3] = {x0, y0, z0}, bmax[3] = {x1, y1, z1};
  return interval_entry(s, bmin, bmax);
}

// A summary's flags (kCullDead, kCullCased): pairs.py::cull_row_cases.
__device__ __forceinline__ int cull_flags(const float* s) {
  if (s[12] > s[13]) return kCullDead;
  bool cased = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float olo = s[a], ohi = s[3 + a], il = s[6 + a], ih = s[9 + a];
    cased = cased && (il > 0.f || ih < 0.f) && il <= ih && fabsf(il) < kInf &&
            fabsf(ih) < kInf && olo <= ohi;
  }
  return cased ? kCullCased : 0;
}

__global__ void __launch_bounds__(kCullClusters)
cull_kernel(const float* __restrict__ summ, const float* __restrict__ cb6,
            float* __restrict__ out, int B, int K) {
  __shared__ __align__(16) float s_summ[kCullBlocks * 16];
  const int k = blockIdx.x * kCullClusters + threadIdx.x;
  const int b0 = blockIdx.y * kCullBlocks;
  const int nb = min(kCullBlocks, B - b0);
  for (int i = threadIdx.x; i < nb * 16; i += kCullClusters)
    s_summ[i] = summ[int64_t(b0) * 16 + i];
  __syncthreads();
  if (threadIdx.x < nb)
    s_summ[threadIdx.x * 16 + 15] = __int_as_float(cull_flags(s_summ + threadIdx.x * 16));
  __syncthreads();
  if (k >= K) return;
  float bmin[3], bmax[3];
  bool box_ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = cb6[int64_t(a) * K + k];
    bmax[a] = cb6[int64_t(3 + a) * K + k];
    box_ok = box_ok && bmin[a] <= bmax[a];
  }
  float* row = out + int64_t(b0) * K + k;
#pragma unroll 2
  for (int r = 0; r < nb; ++r, row += K) {
    const float* s = s_summ + r * 16;
    const int flags = __float_as_int(s[15]);
    float e;
    if (kCullCases && (flags & kCullDead)) {
      e = kInf;
    } else if (kCullCases && (flags & kCullCased) && box_ok) {
      if (!cased_entry(s, bmin, bmax, e))
        e = interval_entry_call(s, bmin[0], bmin[1], bmin[2], bmax[0], bmax[1], bmax[2]);
    } else {
      e = interval_entry(s, bmin, bmax);
    }
    *row = e;
  }
}

// ---------------------------------------------------------------------- K3
// Replaces akari_render_tpu/accel/pairs.py::_refine_all_kernel (via
// _refine_all) and the stable argsort of its rows that follows it (the
// walk order, pairs.py::walk_order): for one ray block, every cluster's
// minimum entry over the lanes whose own [tmin, t-limit] slab interval
// overlaps it (+inf if none), and the block's walk: the clusters of finite
// entry in ascending (entry, id) order, their entries and their count.
//
// Bound: FP32 ALU, a slab test (27 operations) per lane and cluster that
// no exact skip removes, and the [B, K] e_con read and e_init write. Run
// in full that is every lane against every cluster of the tiles K2 leaves,
// and the earlier kernel (one thread a cluster, every lane in turn) did
// just that; but a block's lanes reach few clusters, and the walk's argsort
// went through device memory three more times. What the design does:
// 1. Exact skips, in two levels. A cluster whose K2 entry is +inf is
//    skipped (K2's interval chain is conservative: interval_entry). Each of
//    the block's 16 warps of 32 lanes gets an interval summary of its live
//    lanes, and a cluster is slab-tested against a warp's lanes only when
//    K2's chain passes it on that summary: the same proof. A lane whose
//    tmin is not below its t-limit never passes (near >= tmin > far), so it
//    is left out of the summaries and never passes here. On classroom's
//    bounce rays about one (cluster, warp) pair in eight is left.
// 2. A warp owns its 32 lanes, their rays in registers: it tests its own
//    summary against the chunk's clusters (a lane a cluster), and for each
//    cluster that passes, two at a time, every lane runs its slab test and
//    a warp reduction on ordered bits takes the minimum, folded into the
//    cluster's minimum by a shared atomicMin. `min` is exact and commutes,
//    so neither the lane order nor the warps' order changes a bit. No
//    queue and no barrier between the summary test and the slab tests; a
//    warp of dead lanes skips the chunk.
// 3. The walk order in shared memory. The finite entries go into a list of
//    64-bit keys (entry as ordered bits, cluster id), sorted by a bitonic
//    network in the block: ties in the entry go to the lower id, which is
//    the stable argsort's order (an entry of -0 keys as +0, as the argsort
//    compares them). Only worder[b, :kcnt[b]] and went[b, :kcnt[b]] are
//    written: K4 reads nothing past kcnt. Above kKeysSmem clusters the keys
//    live in a global scratch row of the block instead.
// Clusters go in chunks of one a thread: K2's entries of all of them are
// read first (a rejected cluster's e_init is +inf at once, and a chunk with
// no candidate is skipped), then, a chunk at a time, each thread stages
// its candidate's box and the warps test and run them: two barriers a
// chunk.
constexpr int kRefineThreads = akr::kMaxLanes;  // a ray block's lanes, one a thread
constexpr int kGroups = kRefineThreads / 32;    // the lanes' warps, each with a summary
// shared memory of refine_walk_kernel, in floats: summaries [16][16], a
// chunk's boxes [6][512], its minima [512] (ordered bits), four counters,
// every chunk's candidate bits [chunks][16], then the keys (uint64)
constexpr int kSmSumm = 0;
constexpr int kSmBox = kSmSumm + 16 * kGroups;
constexpr int kSmMin = kSmBox + 6 * kRefineThreads;
constexpr int kSmCount = kSmMin + kRefineThreads;
constexpr int kSmCand = kSmCount + 4;
constexpr int kKeysSmem = 12288;  // clusters whose keys fit in shared memory
__host__ __device__ constexpr int refine_keys_offset(int K) {  // in floats, 8-byte aligned
  return (kSmCand + kGroups * ((K + kRefineThreads - 1) / kRefineThreads) + 1) & ~1;
}
constexpr unsigned kNoEntry = 0xff800000u;  // ordered_bits(+inf)

__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Append `v` to a shared list at *count if `p`: one atomicAdd a warp.
template <typename T>
__device__ __forceinline__ void warp_append(bool p, T v, T* list, int* count) {
  const unsigned vote = __ballot_sync(akr::kFullWarp, p);
  if (!vote) return;
  const int lane = threadIdx.x & 31;
  int pos = 0;
  if (lane == 0) pos = atomicAdd(count, __popc(vote));
  pos = __shfl_sync(akr::kFullWarp, pos, 0) + __popc(vote & ((1u << lane) - 1u));
  if (p) list[pos] = v;
}

// This thread's lane of a ray block in registers, v = (o xyz, inverse
// direction xyz, tmin, t-limit), and its warp's interval summary of the
// live lanes in s_summ[warp * 16, +16) (K2's layout; [14] is 1 when the
// warp has a live lane), written by the warp's lane 0. A lane whose tmin is
// not at or below its t-limit (NaN limits among them) never passes a slab
// test: its limits become +inf and -inf (near >= +inf > -inf >= far), and it
// is left out of the summary. Returns whether the lane is live. The rays
// must be finite (sort_rays makes them so). Shared by K3 and K5.
__device__ __forceinline__ bool load_lane_summary(const float* __restrict__ o,
                                                  const float* __restrict__ inv,
                                                  const float* __restrict__ lim, int n, int64_t l,
                                                  float* v, float* s_summ) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v[0] = o[l];
  v[1] = o[n + l];
  v[2] = o[2 * int64_t(n) + l];
  v[3] = inv[l];
  v[4] = inv[n + l];
  v[5] = inv[2 * int64_t(n) + l];
  v[6] = lim[l];
  v[7] = lim[n + l];
  const bool live = v[6] <= v[7];
  if (!live) {
    v[6] = kInf;
    v[7] = -kInf;
  }
  float sm[14];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sm[a] = live ? v[a] : kInf;
    sm[3 + a] = live ? v[a] : -kInf;
    sm[6 + a] = live ? v[3 + a] : kInf;
    sm[9 + a] = live ? v[3 + a] : -kInf;
  }
  sm[12] = v[6];
  sm[13] = v[7];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 14; ++i) {
      const float x = __shfl_xor_sync(akr::kFullWarp, sm[i], off);
      sm[i] = (i < 3 || (i >= 6 && i < 9) || i == 12) ? fminf(sm[i], x) : fmaxf(sm[i], x);
    }
  }
  const bool any_live = __any_sync(akr::kFullWarp, live);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 14; ++i) s_summ[warp * 16 + i] = sm[i];
    s_summ[warp * 16 + 14] = any_live ? 1.f : 0.f;
  }
  return live;
}

// The warps of the block with a live lane, as bits (after the barrier that
// follows load_lane_summary).
__device__ __forceinline__ unsigned live_warp_bits(const float* s_summ) {
  unsigned bits = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) bits |= (s_summ[g * 16 + 14] > 0.f ? 1u : 0u) << g;
  return bits;
}

// One lane's slab test against the staged box `cl` of a [6][kRefineThreads]
// chunk (refine_all_torch's and refine_torch's op order): whether its
// [tmin, t-limit] interval overlaps the box, and its entry `near`.
__device__ __forceinline__ bool lane_slab(const float* s_box, int cl, const float* v, float& near) {
  near = -kInf;
  float far = kInf;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (s_box[a * kRefineThreads + cl] - v[a]) * v[3 + a];
    const float t1 = (s_box[(3 + a) * kRefineThreads + cl] - v[a]) * v[3 + a];
    near = fmaxf(near, fminf(t0, t1));
    far = fminf(far, fmaxf(t0, t1));
  }
  near = fmaxf(near, v[6]);
  far = fminf(far, v[7]);
  return near <= far;
}

// One lane's slab entry into the chunk's cluster `cl`, as ordered bits,
// kNoEntry where it misses.
__device__ __forceinline__ unsigned lane_entry(const float* s_box, int cl, const float* v) {
  float near;
  return lane_slab(s_box, cl, v, near) ? akr::ordered_bits(near) : kNoEntry;
}

__global__ void __launch_bounds__(kRefineThreads, 2)
refine_walk_kernel(const float* __restrict__ cb6, const float* __restrict__ o,
                   const float* __restrict__ inv, const float* __restrict__ lim,
                   const float* __restrict__ e_con, float* __restrict__ e_init,
                   int32_t* __restrict__ worder, float* __restrict__ went,
                   int32_t* __restrict__ kcnt, unsigned long long* __restrict__ g_keys,
                   int32_t* __restrict__ counts, int K, int n) {
  extern __shared__ __align__(16) float smem[];
  float* s_summ = smem + kSmSumm;
  float* s_box = smem + kSmBox;
  unsigned* s_min = reinterpret_cast<unsigned*>(smem + kSmMin);
  unsigned* s_cand = reinterpret_cast<unsigned*>(smem + kSmCand);  // [chunks][16]
  int* s_count = reinterpret_cast<int*>(smem + kSmCount);  // [1] keys, [2] tests, [3] units
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = int64_t(b) * K;
  unsigned long long* keys =
      g_keys ? g_keys + row
             : reinterpret_cast<unsigned long long*>(smem + refine_keys_offset(K));

  // this thread's lane, and each warp's summary of its live lanes
  float v[8];
  load_lane_summary(o, inv, lim, n, int64_t(b) * kRefineThreads + tid, v, s_summ);
  if (tid < 4) s_count[tid] = 0;
  __syncthreads();
  const unsigned live_warps = live_warp_bits(s_summ);
  const bool warp_live = (live_warps >> warp) & 1u;
  int n_tests = 0, n_units = 0;  // this warp's tally for `counts` (lane 0's)

  // K2's entries first, all loads in flight at once: a cluster it rejects
  // gets +inf here; each chunk's candidates as bits, a word a warp, and a
  // chunk without any is skipped below
  const int chunks = (K + kRefineThreads - 1) / kRefineThreads;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c = ch * kRefineThreads + tid;
    const bool cand = c < K && live_warps && e_con[row + c] < kInf;
    if (c < K && !cand) e_init[row + c] = kInf;
    const unsigned word = __ballot_sync(akr::kFullWarp, cand);
    if (lane == 0) s_cand[ch * kGroups + warp] = word;
  }
  __syncthreads();

  for (int ch = 0; ch < chunks; ++ch) {
    const unsigned* cand_words = s_cand + ch * kGroups;  // the same in every thread
    unsigned any = 0;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) any |= cand_words[r];
    if (!any) continue;
    const int c = ch * kRefineThreads + tid;
    const bool cand = (cand_words[warp] >> lane) & 1u;
    if (cand) {
#pragma unroll
      for (int a = 0; a < 6; ++a) s_box[a * kRefineThreads + tid] = cb6[int64_t(a) * K + c];
    }
    s_min[tid] = kNoEntry;
    __syncthreads();
    if (warp_live) {
      for (int r = 0; r < kGroups; ++r) {
        const unsigned cw = cand_words[r];
        if (!cw) continue;
        bool p = false;
        if ((cw >> lane) & 1u) {
          const int cl = r * 32 + lane;
          float bmin[3], bmax[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            bmin[a] = s_box[a * kRefineThreads + cl];
            bmax[a] = s_box[(3 + a) * kRefineThreads + cl];
          }
          p = interval_entry(s_summ + warp * 16, bmin, bmax) < kInf;
        }
        unsigned pass = __ballot_sync(akr::kFullWarp, p);
        n_tests += __popc(cw);
        n_units += __popc(pass);
        while (pass) {  // two clusters at a time: independent chains
          const int c0 = r * 32 + __ffs(pass) - 1;
          pass &= pass - 1u;
          const int c1 = pass ? r * 32 + __ffs(pass) - 1 : c0;
          pass &= pass - 1u;
          const unsigned m0 = __reduce_min_sync(akr::kFullWarp, lane_entry(s_box, c0, v));
          const unsigned m1 = __reduce_min_sync(akr::kFullWarp, lane_entry(s_box, c1, v));
          if (lane == 0) {
            if (m0 != kNoEntry) atomicMin(s_min + c0, m0);
            if (m1 != kNoEntry) atomicMin(s_min + c1, m1);
          }
        }
      }
    }
    // the minima are complete; a thread's own box and minimum slots are
    // written again only by itself, in the next chunk, after this read
    __syncthreads();
    float e = kInf;
    if (cand) {
      e = from_ordered_bits(s_min[tid]);
      e_init[row + c] = e;
    }
    const unsigned long long key =
        ((unsigned long long)akr::ordered_bits(e + 0.f) << 32) | unsigned(c);  // -0 keys as +0
    warp_append<unsigned long long>(e < kInf, key, keys, s_count + 1);
  }
  if (counts && lane == 0) {
    atomicAdd(s_count + 2, n_tests);
    atomicAdd(s_count + 3, n_units);
  }
  __syncthreads();  // every key and tally has landed

  // the walk: sort keys[0, m) ascending; the network's slots past m hold
  // +inf in effect (a pair that reaches one never swaps), so no padding
  const int m = s_count[1];
  int P = 1;
  while (P < m) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (P >> 1); t += kRefineThreads) {
        const int grp = t / j, pos = t - grp * j;
        const int lo = j == (k >> 1) ? grp * k + pos : grp * 2 * j + pos;
        const int hi = j == (k >> 1) ? grp * k + k - 1 - pos : lo + j;
        if (hi < m) {
          const unsigned long long x = keys[lo], y = keys[hi];
          if (y < x) {
            keys[lo] = y;
            keys[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < m; i += kRefineThreads) {
    const unsigned long long x = keys[i];
    worder[row + i] = int32_t(unsigned(x));
    went[row + i] = from_ordered_bits(unsigned(x >> 32));
  }
  if (tid == 0) {
    kcnt[b] = m;
    if (counts) {
      counts[2 * b] = s_count[2];
      counts[2 * b + 1] = s_count[3];
    }
  }
}

size_t refine_walk_smem(int K) {
  return (size_t(refine_keys_offset(K)) + (K <= kKeysSmem ? size_t(2) * K : 0)) * sizeof(float);
}

// ---------------------------------------------------------------------- K5
// Replaces akari_render_tpu/accel/pairs.py::_refine_kernel (via _refine),
// with the gather of the window's boxes that feeds it: for one ray block
// and each member of its window (a cluster id, win_i[b, w]) whose
// member_ok is set, 1 where any lane's [tmin, t-limit] slab interval
// overlaps the cluster's box, else 0; 0 where member_ok is clear. lim row 1
// is the lane's current limit (its best t, -inf once occluded).
//
// Bound: FP32 ALU, a slab test (27 operations) per lane and member that no
// exact skip removes, and the ids, flags and output ([B, W]) with the
// lanes' 8 floats. Run in full that is every lane against every member
// that no lane passes (85 % of a window's members on classroom) in every
// block, live or not, and the earlier kernel (one thread a member, the
// block's lanes one after another, from a [B, 6, W] gather made before it)
// did just that. What the design does:
// 1. Members by id. A block reads its members' flags first and returns at
//    once when none is set: the blocks that the walk has finished (most of
//    them after the first rounds) cost one row of flags. The boxes of a
//    chunk of 512 members are gathered from cb6 (4,633 x 6 floats, held in
//    L2) into shared memory; no [B, 6, W] array exists.
// 2. K3's exact skip. Each of the block's 16 warps holds its 32 lanes in
//    registers and an interval summary of its live lanes
//    (load_lane_summary). A warp tests its summary against the chunk's
//    members (a lane a member) with K2's chain (interval_entry: a lane that
//    passes a box passes it on the summary, by monotone rounding), and runs
//    its lanes' slab tests only on the members that pass, two at a time.
// 3. The first lane that passes ends a member. A member's flag is one bit
//    of a word a warp of members in shared memory, set by atomicOr; a warp
//    drops the members other warps have passed before it tests them. OR is
//    exact and commutes, so the result does not depend on the warps' order;
//    the counters of units run do.
// kStats adds each block's counters into counts[b]: members with member_ok,
// (member, warp) summary tests, units of 32 slab tests run.
template <bool kStats>
__global__ void __launch_bounds__(kRefineThreads, 2)
window_refine_kernel(const float* __restrict__ cb6, const int32_t* __restrict__ win_i,
                     const uint8_t* __restrict__ member_ok, const float* __restrict__ o,
                     const float* __restrict__ inv, const float* __restrict__ lim,
                     int32_t* __restrict__ out, int32_t* __restrict__ counts, int K, int W,
                     int n) {
  __shared__ float s_summ[16 * kGroups];
  __shared__ float s_box[6 * kRefineThreads];
  __shared__ unsigned s_cand[kGroups];    // the chunk's members with member_ok, a word a warp
  __shared__ unsigned s_passed[kGroups];  // ... that a lane passes
  __shared__ int s_count[3];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = int64_t(b) * W;

  bool any = false;
  for (int w = tid; w < W; w += kRefineThreads) any |= member_ok[row + w] != 0;
  if (!__syncthreads_or(any)) {  // a block the walk has finished, or one with no member left
    for (int w = tid; w < W; w += kRefineThreads) out[row + w] = 0;
    if (kStats && tid < 3) counts[3 * int64_t(b) + tid] = 0;
    return;
  }
  float v[8];
  load_lane_summary(o, inv, lim, n, int64_t(b) * kRefineThreads + tid, v, s_summ);
  if (kStats && tid < 3) s_count[tid] = 0;
  __syncthreads();
  const bool warp_live = (live_warp_bits(s_summ) >> warp) & 1u;
  int n_ok = 0, n_tests = 0, n_units = 0;  // this warp's tally (lane 0's)
  const volatile unsigned* passed_now = s_passed;

  for (int c0 = 0; c0 < W; c0 += kRefineThreads) {
    const int w = c0 + tid;
    const bool ok = w < W && member_ok[row + w] != 0;
    const unsigned word = __ballot_sync(akr::kFullWarp, ok);
    if (ok) {
      const int id = win_i[row + w];
#pragma unroll
      for (int a = 0; a < 6; ++a) s_box[a * kRefineThreads + tid] = cb6[int64_t(a) * K + id];
    }
    if (lane == 0) {
      s_cand[warp] = word;
      s_passed[warp] = 0u;
    }
    n_ok += __popc(word);
    __syncthreads();
    if (warp_live) {
      for (int r = 0; r < kGroups; ++r) {
        const unsigned cw = s_cand[r];
        if (!cw) continue;
        bool p = false;
        if ((cw >> lane) & 1u) {
          const int m = r * 32 + lane;
          float bmin[3], bmax[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            bmin[a] = s_box[a * kRefineThreads + m];
            bmax[a] = s_box[(3 + a) * kRefineThreads + m];
          }
          p = interval_entry(s_summ + warp * 16, bmin, bmax) < kInf;
        }
        unsigned pass = __ballot_sync(akr::kFullWarp, p);
        n_tests += __popc(cw);
        while (true) {
          // lane 0's read of the members passed so far, the same in every lane
          pass &= ~__shfl_sync(akr::kFullWarp, unsigned(passed_now[r]), 0);
          if (!pass) break;
          const int m0 = __ffs(pass) - 1;
          pass &= pass - 1u;
          const int m1 = pass ? __ffs(pass) - 1 : m0;  // two at a time: independent chains
          pass &= pass - 1u;
          float near;
          const bool h0 = __any_sync(akr::kFullWarp, lane_slab(s_box, r * 32 + m0, v, near));
          const bool h1 = __any_sync(akr::kFullWarp, lane_slab(s_box, r * 32 + m1, v, near));
          n_units += m1 != m0 ? 2 : 1;
          if (lane == 0 && (h0 || h1))
            atomicOr(s_passed + r, (h0 ? 1u << m0 : 0u) | (h1 ? 1u << m1 : 0u));
        }
      }
    }
    // every flag of the chunk is set; a warp's words are written again only
    // by its own lane 0, in the next chunk, after its lanes read them here
    __syncthreads();
    if (w < W) out[row + w] = ok ? int32_t((s_passed[warp] >> lane) & 1u) : 0;
  }
  if (kStats) {
    if (lane == 0) {
      atomicAdd(s_count, n_ok);
      atomicAdd(s_count + 1, n_tests);
      atomicAdd(s_count + 2, n_units);
    }
    __syncthreads();
    if (tid < 3) counts[3 * int64_t(b) + tid] = s_count[tid];
  }
}

// ---------------------------------------------------------------------- K4
// Replaces akari_render_tpu/accel/pairs.py::_sweep_ent_kernel with
// mt_block_update (via _sweep_ent), and the host's round loop around it
// (intersect_pairs' while_loop of MAXC-candidate rounds).
//
// The TPU grid walks candidates in sequence with the best hits carried
// across steps; Hopper has no ordered grid, so one CUDA block per 512-ray
// block walks that block's whole candidate list worder[b, :kcnt[b]] inside
// the kernel: one launch per traversal and no host sync per round. Each
// step refreshes the block horizon (the max over lanes of the live
// t-limit: best t, or for any hit -3e38 once occluded) and stops the walk
// once the candidate's entry lies beyond it (the entries ascend and the
// horizon only shrinks); else the block runs the candidate test it shares
// with K7 (candidate_test.cuh): each lane box-tests the candidate against
// its best t now, and the block's warps share out the slots of the lanes
// that pass.
//
// Bound: the latency of a step, times the steps of the longest walk (see
// the header: with the box test little arithmetic is left). What the
// design does about it: the walk's entries are computed once by K3 against
// the rays' first limits, so a block reaches many candidates that most of
// its lanes can no longer hit; the box test against the lane's best t now
// drops those lanes (99 in 100 on classroom), and the slots of the rest
// run across all the warps, not down one thread. The candidates ride a
// two-buffer ring: the copy of candidate k + 1 (cp.async: its row,
// transform and box, 6 KB from L2) is started before candidate k is tested
// and awaited after, and one barrier a step serves the horizon, the ring
// and the copy's visibility (the candidate test holds two more when a lane
// passes, none when none does). The horizon stays exact, one reduction a
// candidate: testing a candidate that the plain walk stops before could
// change a hit on a rounding. The ray, its inverse direction and its best
// hit live in registers; __launch_bounds__ keeps two 512-thread blocks
// resident an SM (registers set that, not the 41 KB of shared memory:
// pairs.py::kernel_info reports both; a third block costs a spill and is
// slower where the longest walk sets the time).
//
// With early_out 0 the same kernel serves K6 (_sweep_kernel): every
// candidate of the list is tested (no horizon), except those whose entry
// is +inf, which mark JAX's dummy rows. `walked` (or null) receives each
// block's count of candidates tested; the kStats instantiation also sums
// the candidate test's CullStats per block into `stats`.
template <bool kStats>
__global__ void __launch_bounds__(akr::kMaxLanes, 2)
sweep_kernel(const int32_t* __restrict__ worder, const float* __restrict__ went,
             const int32_t* __restrict__ kcnt, const int32_t* __restrict__ tri_row,
             const float* __restrict__ tri, const float* __restrict__ xf,
             const float* __restrict__ boxes, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ lim,
             const float* __restrict__ ex, float* __restrict__ best, int K, int n_cand, int C,
             int n, int any_hit, int early_out, int32_t* __restrict__ walked,
             int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int sf = akr::stage_floats(C);  // two stage buffers, the test's scratch, the maxima
  const akr::CullScratch scratch = akr::cull_scratch(smem + 2 * sf, blockDim.x);
  float* s_red = smem + 2 * sf + akr::scratch_floats(blockDim.x);  // [2][32] per-warp maxima
  const int b = blockIdx.x;
  const int64_t lane = int64_t(b) * blockDim.x + threadIdx.x;
  const akr::LaneRay ray = akr::load_lane_ray(o, d, lim, ex, n, lane);
  akr::LaneBest hit = akr::load_lane_best(best, n, lane);
  akr::CullStats st;
  if (threadIdx.x == 0) *scratch.count = 0;  // visible, as the next, after the first barrier
  if (!xf) {
    akr::stage_identity(smem, C);
    akr::stage_identity(smem + sf, C);
  }

  const int cnt = kcnt[b];
  const int64_t wrow = int64_t(b) * K;
  int steps = 0, parity = 0;
  // candidate k's copy is in flight iff its entry is finite
  float e = cnt > 0 ? went[wrow] : kInf;
  if (e < kInf) {
    const int ci = worder[wrow];
    akr::stage_candidate(smem, tri, xf, boxes, n_cand, tri_row ? tri_row[ci] : ci, ci, C);
  }
  for (int k = 0; k < cnt; ++k) {
    const float e_next = k + 1 < cnt ? went[wrow + k + 1] : kInf;
    int ci_next = 0, row_next = 0;
    if (e_next < kInf) {
      ci_next = worder[wrow + k + 1];
      row_next = tri_row ? tri_row[ci_next] : ci_next;
    }
    akr::stage_wait();
    // the barrier: candidate k's copy is visible, and every warp has left
    // candidate k - 1, whose buffer the next copy overwrites
    if (early_out) {
      const float horizon = akr::block_max(akr::lane_limit(ray, hit, any_hit), s_red, parity);
      if (!(e <= horizon)) break;  // ascending entries, shrinking horizon: done
    } else {
      __syncthreads();
    }
    if (e_next < kInf)
      akr::stage_candidate(smem + ((k + 1) & 1) * sf, tri, xf, boxes, n_cand, row_next, ci_next,
                           C);
    if (e < kInf) {  // else a dummy candidate (the same for the whole block)
      ++steps;
      akr::candidate_test<kStats>(smem + (k & 1) * sf, C, ray, hit, hit.t, any_hit, scratch,
                                  st);
    }
    e = e_next;
  }
  akr::stage_wait();  // a walk that stopped early leaves no copy behind
  if (walked && threadIdx.x == 0) walked[b] = steps;
  if (kStats) akr::add_cull_stats(stats, b, st);
  akr::store_lane_best(best, n, lane, hit);
}

size_t sweep_smem(int C, int lanes) {
  return (size_t(2) * akr::stage_floats(C) + akr::scratch_floats(lanes) + 64) * sizeof(float);
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; each launches on `stream` and returns cudaGetLastError().

// K2: summ [B, 16], cb6 [6, K] -> out [B, K].
extern "C" int akr_cull(const float* summ, const float* cb6, float* out, int B, int K,
                        void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const dim3 grid((K + kCullClusters - 1) / kCullClusters, (B + kCullBlocks - 1) / kCullBlocks);
  cull_kernel<<<grid, kCullClusters, 0, static_cast<cudaStream_t>(stream)>>>(summ, cb6, out, B,
                                                                               K);
  return static_cast<int>(cudaGetLastError());
}

// K3 and the walk order: cb6 [6, K], o / inv [3, n], lim [2, n], e_con
// [B, K] -> e_init [B, K], worder [B, K] int32 and went [B, K] (each row
// written up to kcnt), kcnt [B] int32; n = B * block_lanes, block_lanes
// 512. keys: a uint64 [B, K] scratch when K > kKeysSmem (akr_refine_walk_keys
// says), else null. counts (or null): [B, 2] int32, each block's (cluster,
// warp) summary tests and the units of 32 slab tests run.
extern "C" int akr_refine_walk(const float* cb6, const float* o, const float* inv,
                               const float* lim, const float* e_con, float* e_init,
                               int32_t* worder, float* went, int32_t* kcnt, void* keys,
                               int32_t* counts, int B, int K, int block_lanes, void* stream) {
  if (B <= 0) return 0;
  if (block_lanes != kRefineThreads || K < 0 || (K > kKeysSmem) != (keys != nullptr) ||
      refine_walk_smem(K) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = refine_walk_smem(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        refine_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refine_walk_kernel<<<B, kRefineThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cb6, o, inv, lim, e_con, e_init, worder, went, kcnt,
      static_cast<unsigned long long*>(keys), counts, K, B * block_lanes);
  return static_cast<int>(cudaGetLastError());
}

// The clusters above which akr_refine_walk takes a global key scratch.
extern "C" int akr_refine_walk_keys() { return kKeysSmem; }

// K5: cb6 [6, K], win_i [B, W] int32 (cluster ids; read where member_ok),
// member_ok [B, W] bool, o / inv [3, n], lim [2, n] -> out [B, W] int32,
// n = B * block_lanes (512). counts (or null: the kernel without counters):
// [B, 3] int32, each block's members with member_ok, (member, warp)
// summary tests and units of 32 slab tests run.
extern "C" int akr_refine_window(const float* cb6, const int32_t* win_i, const uint8_t* member_ok,
                                 const float* o, const float* inv, const float* lim, int32_t* out,
                                 int32_t* counts, int B, int K, int W, int block_lanes,
                                 void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (block_lanes != kRefineThreads) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = counts ? window_refine_kernel<true> : window_refine_kernel<false>;
  kernel<<<B, kRefineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cb6, win_i, member_ok, o, inv, lim, out, counts, K, W, B * block_lanes);
  return static_cast<int>(cudaGetLastError());
}

// K4 (early_out 1) and K6 (early_out 0): worder [B, K] int32 candidate
// ids, went [B, K], kcnt [B] int32, tri_row (null: row = candidate id), xf
// (null: identity) and boxes [7, n_cand] (the candidates' world boxes and
// sliver flags, pairs.py::candidate_test_boxes) indexed by
// candidate id, tri [R, C, 12], o / d [3, n], lim [2, n], ex [4, n], best
// [4, n] in and out, walked [B] int32 out (or null), stats [B, 4] int32,
// zeroed (or null: the kernel without counters); n = B * block_lanes,
// block_lanes a multiple of 32 up to 512. tri and xf must be 16-byte
// aligned.
extern "C" int akr_sweep(const int32_t* worder, const float* went, const int32_t* kcnt,
                         const int32_t* tri_row, const float* tri, const float* xf,
                         const float* boxes, const float* o, const float* d, const float* lim,
                         const float* ex, float* best, int B, int K, int n_cand, int C,
                         int block_lanes, int any_hit, int early_out, int32_t* walked,
                         int32_t* stats, void* stream) {
  if (B <= 0) return 0;
  if (!boxes || block_lanes <= 0 || block_lanes > akr::kMaxLanes || block_lanes % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(tri) | reinterpret_cast<uintptr_t>(xf)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = stats ? sweep_kernel<true> : sweep_kernel<false>;
  const size_t smem = sweep_smem(C, block_lanes);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, block_lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      worder, went, kcnt, tri_row, tri, xf, boxes, o, d, lim, ex, best, K, n_cand, C,
      B * block_lanes, any_hit, early_out, walked, stats);
  return static_cast<int>(cudaGetLastError());
}

// The resources of K2, K3, K5 and K4/K6 (in that order) at C slots a
// candidate, block_lanes lanes a block and, for K3, K clusters: out is a
// host array [4][6] (akr::kernel_info's layout).
extern "C" int akr_pairs_kernel_info(int32_t* out, int C, int block_lanes, int K) {
  cudaError_t err = akr::kernel_info(cull_kernel, kCullClusters, 0, out);
  if (err == cudaSuccess)
    err = akr::kernel_info(refine_walk_kernel, kRefineThreads, refine_walk_smem(K), out + 6);
  if (err == cudaSuccess)
    err = akr::kernel_info(window_refine_kernel<false>, kRefineThreads, 0, out + 12);
  if (err == cudaSuccess)
    err = akr::kernel_info(sweep_kernel<false>, block_lanes, sweep_smem(C, block_lanes),
                           out + 18);
  return static_cast<int>(err);
}
