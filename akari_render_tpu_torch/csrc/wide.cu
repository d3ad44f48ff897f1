// K7, the wide-BVH walk for Hopper (sm_90a).
//
// Replaces akari_render_tpu/accel/wide.py::_walk_kernel (via _walk), the
// round loop of intersect_wide around it, and the sweep that loop feeds
// (_sweep_ent): on the TPU the walk emits its leaves to a second kernel and
// the host repeats rounds, a workaround for a DMA fault there; here a leaf
// is tested where it is popped, so a traversal is one launch.
//
// One CUDA block per sorted ray block, one thread per lane. The block's
// stack (child word, entry, leaf row) lives in shared memory. Each step
// pops the top:
// - an entry beyond the block horizon (the max over lanes of the live
//   t-limit) is dropped: it lower-bounds every hit below it for every lane;
// - an internal node: each lane slab-tests the 8 child boxes against its
//   live [tmin, t-limit]; a child's entry is the minimum over the lanes
//   that pass; the children with an entry are pushed far-to-near in the
//   block's octant order (the nibbles of the node's order word for the
//   octant of the block's first lane, near-first, pushed from the last);
// - a leaf stages its candidate's C x 12 triangles, world->local row and
//   box and runs the candidate test shared with K4 (candidate_test.cuh),
//   then the horizon is refreshed.
//
// It computes what the plain version (accel/wide.py::wide_walk_torch)
// computes: the push order is fixed at build time, so the depth-first leaf
// order does not depend on how fresh the limits are; a dropped pop or an
// unpushed child lies beyond every lane's limit; the slab and candidate
// arithmetic is the same op for op (-fmad=false, IEEE division). Child
// boxes are f32 bit patterns in the int32 table; an empty slot's 1e38
// bounds overflow to +-inf, never NaN (the rays are finite, the inverse
// directions finite and non-zero), so fminf/fmaxf agree with torch. An
// entry is only ever compared, so taking the minima on ordered bits (where
// -0 < +0) changes nothing.
//
// Bound: with the candidate test's skips (see candidate_test.cuh) little
// arithmetic is left: 8 x 12 slab operations per lane and node, a box test
// per lane and leaf and the slots of the few lanes that pass it. The time
// is the latency of the walk's steps, one after another in each block, and
// the longest walk sets the launch. What the design does about it:
// - a node step is as short as the block-wide minima allow: every thread
//   reads the node's row from global memory (one row for the whole block:
//   L1 and L2 serve it, no staging barrier), a warp takes each child's
//   minimum with one redux on the ordered bits and one shared atomicMin,
//   and after the one barrier that completes the entries the first 8
//   lanes of every warp rank the children by a ballot: every warp knows
//   the new depth, warp 0 writes the pushes, and a second barrier shows
//   them to the block (per-warp values reduced by a few threads and a
//   push by one thread cost three more barriers);
// - a leaf's row, transform and box arrive by cp.async. When the entry
//   under a popped leaf is a leaf too (siblings mostly are), its copy is
//   started before this leaf is tested and awaited before the horizon's
//   barrier, which makes it visible: that leaf then needs no staging
//   barrier. A leaf takes three or four barriers (staging unless
//   prefetched, two in the candidate test, the horizon);
// - __launch_bounds__ keeps two blocks resident an SM (registers set that).
// The kStats instantiation reads the clock around node and leaf steps; the
// split is in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "candidate_test.cuh"

namespace {

using akr::kInf;
using akr::kMaxLanes;

constexpr int kStackDepth = 192;  // accel/wide.py STACK_DEPTH; build_wide asserts the tree fits
constexpr float kNeg = -3e38f;

constexpr unsigned kInfBits = 0xff800000u;  // akr::ordered_bits(+inf)

// ordered_bits' inverse.
__device__ __forceinline__ float unordered_bits(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b ^ 0x80000000u) : ~b);
}

// leaf_test 0 (the probe entry point only) pops and counts the leaves
// without testing them: the walk of the rays' first limits, which prices a
// node step. The kStats instantiation sums the candidate test's CullStats
// per block into `stats` and thread 0's clock cycles in node steps and in
// leaf steps into `cycles` [B, 2].
template <bool kStats>
__global__ void __launch_bounds__(kMaxLanes, 2)
wide_walk_kernel(const int32_t* __restrict__ nodes, const float* __restrict__ tri,
                 const float* __restrict__ xf, const float* __restrict__ boxes,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ lim, const float* __restrict__ ex,
                 float* __restrict__ best, int n_cand, int C, int n, int any_hit, int leaf_test,
                 int32_t* __restrict__ counts, int32_t* __restrict__ stats,
                 long long* __restrict__ cycles) {
  __shared__ int32_t s_sid[kStackDepth];
  __shared__ float s_se[kStackDepth];
  __shared__ int32_t s_srow[kStackDepth];
  __shared__ unsigned s_ent[16];  // two rows of 8 child entries (ordered bits), by node parity
  __shared__ float s_hred[64];    // block_max's two rows
  extern __shared__ __align__(16) float smem[];  // two staged candidates, the test's scratch

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, wlane = threadIdx.x & 31;
  const int sf = akr::stage_floats(C);
  const int64_t lane0 = int64_t(b) * blockDim.x;
  const int64_t lane = lane0 + threadIdx.x;
  const akr::LaneRay ray = akr::load_lane_ray(o, d, lim, ex, n, lane);
  akr::LaneBest hit = akr::load_lane_best(best, n, lane);
  akr::CullStats st;
  const akr::CullScratch scratch = akr::cull_scratch(smem + 2 * sf, blockDim.x);
  const float ov[3] = {ray.wox, ray.woy, ray.woz};
  const float invd[3] = {ray.ivx, ray.ivy, ray.ivz};
  // the block's octant: that of its first lane
  const int oct = (d[lane0] < 0.f ? 4 : 0) + (d[int64_t(n) + lane0] < 0.f ? 2 : 0) +
                  (d[2 * int64_t(n) + lane0] < 0.f ? 1 : 0);

  if (threadIdx.x == 0) {  // the root, entry -3e38
    s_sid[0] = 0;
    s_se[0] = kNeg;
    s_srow[0] = 0;
  }
  if (threadIdx.x == 0) *scratch.count = 0;
  if (threadIdx.x < 16) s_ent[threadIdx.x] = kInfBits;
  if (!xf) {
    akr::stage_identity(smem, C);
    akr::stage_identity(smem + sf, C);
  }
  // `use`: the stage buffer of the next leaf; `ready`: the candidate that
  // already lies there, visible to the block (-1: none)
  int parity = 0, node_parity = 0, use = 0, ready = -1;
  float horizon = akr::block_max(akr::lane_limit(ray, hit, any_hit), s_hred, parity);
  int sp = 1, expanded = 0, tested = 0;
  long long mark = 0, node_cycles = 0, leaf_cycles = 0;
  if (kStats) mark = clock64();
  while (sp > 0) {
    const int sp1 = sp - 1;
    const int32_t val = s_sid[sp1];
    const float ent = s_se[sp1];
    const int32_t row = s_srow[sp1];
    sp = sp1;
    if (!(ent <= horizon)) continue;  // beyond every lane's limit (block-uniform)
    if (val < -1) {                   // a leaf: candidate -val - 2, triangle row `row`
      ++tested;
      if (!leaf_test) continue;
      const int ci = -val - 2;
      float* buf = smem + use * sf;
      if (ready != ci) {  // the last barrier ended every read of this buffer
        akr::stage_candidate(buf, tri, xf, boxes, n_cand, row, ci, C);
        akr::stage_wait();
        __syncthreads();
      }
      // if the next pop is a leaf too, its copy flies while this one is tested
      int next = -1;
      if (sp > 0 && s_sid[sp - 1] < -1 && s_se[sp - 1] <= horizon) {
        next = -s_sid[sp - 1] - 2;
        akr::stage_candidate(smem + (use ^ 1) * sf, tri, xf, boxes, n_cand, s_srow[sp - 1], next,
                             C);
      }
      akr::candidate_test<kStats>(buf, C, ray, hit, hit.t, any_hit, scratch, st);
      akr::stage_wait();  // the horizon's barrier makes the next leaf's copy visible
      horizon = akr::block_max(akr::lane_limit(ray, hit, any_hit), s_hred, parity);
      ready = next;
      use ^= 1;
      if (kStats) {
        const long long now = clock64();
        leaf_cycles += now - mark;
        mark = now;
      }
      continue;
    }
    if (val < 0) continue;  // an empty slot is never pushed
    ++expanded;
    // the node's row straight from global memory (every thread reads the
    // same words: L1 and L2 serve them), each child's entry by one redux
    // a warp on the ordered bits and one shared atomicMin a warp and child
    const int32_t* __restrict__ nrow = nodes + int64_t(val) * 128;
    unsigned* child_ent = s_ent + 8 * node_parity;
    const float t1 = akr::lane_limit(ray, hit, any_hit);
    unsigned mine = kInfBits;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float near = kNeg, far = -kNeg;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float bmin = __int_as_float(__ldg(nrow + 8 * a + s));
        const float bmax = __int_as_float(__ldg(nrow + 8 * (3 + a) + s));
        const float ta = (bmin - ov[a]) * invd[a];
        const float tb = (bmax - ov[a]) * invd[a];
        near = fmaxf(near, fminf(ta, tb));
        far = fminf(far, fmaxf(ta, tb));
      }
      near = fmaxf(near, ray.tmin);
      far = fminf(far, t1);
      const unsigned m =
          __reduce_min_sync(akr::kFullWarp, akr::ordered_bits(near <= far ? near : kInf));
      if (wlane == s) mine = m;
    }
    if (wlane < 8 && mine != kInfBits) atomicMin(child_ent + wlane, mine);
    __syncthreads();  // the eight entries are complete
    // lanes 0..7 of every warp take the order word's nibbles far-to-near
    // (the nibbles are near-first), so every warp knows the new depth;
    // warp 0 writes the pushes, each at its rank among the children kept
    const int slot = (__ldg(nrow + 56 + oct) >> (4 * (7 - (wlane & 7)))) & 7;
    const float e_s = unordered_bits(child_ent[slot]);
    const int32_t c_s = __ldg(nrow + 48 + slot);
    const bool keep = wlane < 8 && e_s < 1e30f && c_s != -1;
    const unsigned kept = __ballot_sync(akr::kFullWarp, keep);
    if (warp == 0) {
      if (keep) {
        const int top = sp1 + __popc(kept & ((1u << wlane) - 1u));
        s_sid[top] = c_s;
        s_se[top] = e_s;
        s_srow[top] = __ldg(nrow + 64 + slot);
      }
      if (wlane < 8) s_ent[8 * (node_parity ^ 1) + wlane] = kInfBits;  // the next node's row
    }
    sp = sp1 + __popc(kept);
    node_parity ^= 1;
    __syncthreads();  // the pushes are visible
    if (kStats) {
      const long long now = clock64();
      node_cycles += now - mark;
      mark = now;
    }
  }
  if (kStats) {
    akr::add_cull_stats(stats, b, st);
    if (threadIdx.x == 0) {
      cycles[2 * b] = node_cycles;
      cycles[2 * b + 1] = leaf_cycles;
    }
  }
  if (counts && threadIdx.x == 0) {
    counts[2 * b] = expanded;
    counts[2 * b + 1] = tested;
  }
  akr::store_lane_best(best, n, lane, hit);
}

size_t walk_smem(int C, int lanes) {
  return size_t(2 * akr::stage_floats(C) + akr::scratch_floats(lanes)) * sizeof(float);
}

cudaError_t launch_walk(bool with_stats, const int32_t* nodes, const float* tri, const float* xf,
                        const float* boxes, const float* o, const float* d, const float* lim,
                        const float* ex, float* best, int B, int n_cand, int C, int block_lanes,
                        int any_hit, int leaf_test, int32_t* counts, int32_t* stats,
                        long long* cycles, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (!boxes || block_lanes <= 0 || block_lanes > kMaxLanes || block_lanes % 32)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tri) | reinterpret_cast<uintptr_t>(xf)) & 15)
    return cudaErrorMisalignedAddress;
  auto kernel = with_stats ? wide_walk_kernel<true> : wide_walk_kernel<false>;
  const size_t smem = walk_smem(C, block_lanes);
  if (smem > 40 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, block_lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      nodes, tri, xf, boxes, o, d, lim, ex, best, n_cand, C, B * block_lanes, any_hit, leaf_test,
      counts, stats, cycles);
  return cudaGetLastError();
}

}  // namespace

// K7: nodes [Nn, 128] int32, tri [R, C, 12], xf [n_cand, 16] (null:
// identity) and boxes [7, n_cand] (the candidates' world boxes and sliver
// flags, pairs.py::candidate_test_boxes) by candidate id, o / d
// [3, n], lim [2, n], ex [4, n], best [4, n] in and out, counts [B, 2] int32
// out (nodes expanded, leaves tested; or null); n = B * block_lanes,
// block_lanes a multiple of 32 up to 512. All pointers are device pointers,
// tri and xf 16-byte aligned; launches on `stream`, returns
// cudaGetLastError().
extern "C" int akr_wide_walk(const int32_t* nodes, const float* tri, const float* xf,
                             const float* boxes, const float* o, const float* d, const float* lim,
                             const float* ex, float* best, int B, int n_cand, int C,
                             int block_lanes, int any_hit, int32_t* counts, void* stream) {
  return static_cast<int>(launch_walk(false, nodes, tri, xf, boxes, o, d, lim, ex, best, B, n_cand,
                                      C, block_lanes, any_hit, 1, counts, nullptr, nullptr,
                                      stream));
}

// The measuring form of K7, on no render's path: the same walk with the
// candidate test's counters summed per block into stats [B, 4] int32 and
// thread 0's clock cycles in node and in leaf steps written to cycles
// [B, 2] int64 (both zeroed by the caller); leaf_test 0 leaves the leaves
// untested.
extern "C" int akr_wide_walk_probe(const int32_t* nodes, const float* tri, const float* xf,
                                   const float* boxes, const float* o, const float* d,
                                   const float* lim, const float* ex, float* best, int B,
                                   int n_cand, int C, int block_lanes, int any_hit,
                                   int leaf_test, int32_t* counts, int32_t* stats,
                                   long long* cycles, void* stream) {
  return static_cast<int>(launch_walk(true, nodes, tri, xf, boxes, o, d, lim, ex, best, B, n_cand,
                                      C, block_lanes, any_hit, leaf_test, counts, stats, cycles,
                                      stream));
}

// K7's resources at C slots a candidate and block_lanes lanes a block into
// the host array out[6] (akr::kernel_info's layout).
extern "C" int akr_wide_kernel_info(int32_t* out, int C, int block_lanes) {
  return static_cast<int>(akr::kernel_info(wide_walk_kernel<false>, block_lanes,
                                           walk_smem(C, block_lanes), out));
}
