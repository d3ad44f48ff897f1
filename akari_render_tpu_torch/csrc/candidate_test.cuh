// The candidate test of the cluster tier, shared by K4/K6 (pairs.cu), K7
// (wide.cu) and the flat tier's K1 (intersect.cu, a tile of consecutive
// triangles as the candidate, the identity as its row): a block's 512 rays
// against the C triangles of one candidate cluster, staged in shared memory
// with the candidate's world->local row, its world box and its sliver flag.
//
// What it computes is pairs.py::_mt_update (mt_block_update of the JAX
// package): every value that reaches `best` is produced by the same
// operations in the same order (the sources are built with -fmad=false and
// IEEE division), so the traversals and their plain versions agree bit for
// bit. Closest hit takes, of the slots with t below the lane's best
// (strict), the one of least t, the first among equals: the TPU's (t, first
// slot) pick within a candidate and its strict `<` across candidates; a
// lane with the per-lane any-hit flag drops its
// best t to kAnyHitRetired once a candidate improved it. Any hit keeps t
// and records the minimum global id of the hitting slots of each candidate
// that hits. Global ids are gid + xf[12] (the instance's id offset); gid <
// 0 marks padding. The ray is transformed with the unnormalised local
// direction, so t stays the world parameter.
//
// What bounds it on this card. Run in full, a candidate is 512 lanes x C
// slots x ~80 instructions (46 flops, an IEEE division, the compares) and
// the block walks hundreds of candidates: FP32 rate. But a block's 512
// sorted lanes reach a candidate when any one of them may, and on
// classroom one or two lanes in a hundred can. Once those are found, what
// is left to compute is small, and the time is the latency of one step of
// the walk: its barriers and the longest chain of dependent instructions
// between them. So the design first removes work that provably cannot
// change `best`, then spreads what is left over the whole block:
//
// 1. box_pass: each lane slab-tests its ray against the candidate's world
//    box over [tmin, its best t now]; only lanes that pass go on. The test
//    must not reject a lane whose Möller-Trumbore test below would hit,
//    and that test runs in the candidate's local space, where t, u and v
//    carry rounding of their own: about 2^-23 x the coordinates' magnitude
//    for the world->local transform and the box's own local->world
//    rounding, divided by the sine of the angle between the ray and the
//    triangle's plane for the solve. The box is therefore widened on every
//    side by kBoxRel x s + kBoxAbs, s the largest |origin| + |box bound|
//    over the axes: 2^-10 s is ~8,000 roundings of a coordinate of
//    magnitude s, which covers the transform outright and costs nothing in
//    culling (a centimetre on a ten-metre room). With unit directions a
//    widened slab also moves its t interval by at least that margin, far
//    more than t's rounding. The margin is argued and tested, not proven:
//    by the estimate above the solve is covered down to ~0.01 degree
//    between ray and plane; on rays aimed at the box-defining triangles
//    within 1e-6 to 1e-4 rad (0.00006 to 0.006 degree) of their planes,
//    with the t-limit cut before and behind the target, no hit of
//    _mt_update fails the test (tests/test_torch_candidate_cull.py, which
//    holds pairs.py::box_pass_torch, this test op for op, against
//    _mt_update). Below 1e-6 rad, close to the least angle a float32
//    direction can hold, _mt_update's own t, u and v are rounding noise of
//    the order of the scene, and about one in 10^4 of the hits it then
//    reports lies outside any box margin that still culls.
//    One case lies outside any margin at every angle, and meshes hold it
//    (the poles of a latitude-longitude sphere): a sliver triangle, whose
//    edges e1 and e2 are parallel to within kSliverSin (zero area among
//    them). Its determinant is rounding noise, mostly above the 1e-12
//    threshold, and _mt_update reports hits far from the triangle. So a
//    candidate whose row holds a sliver carries a flag beside its box
//    (pairs.py::candidate_test_boxes), and its lanes that fail the box test
//    but can still be hit are queued for the sliver slots alone.
// 2. The passing lanes are queued in shared memory and the block's warps
//    share out (queued lane, 32 slots) units, a slot a thread: the C slots
//    of the few lanes that matter run side by side (candidate_test). A
//    lane's own thread looping over its C slots is a chain of C x ~100
//    cycles a candidate, with the other warps waiting at the barrier
//    (built and measured: six times slower).
// 3. A triangle's 12-float row is read as three float4; the rows arrive by
//    cp.async (stage_candidate), so a caller can have the next candidate
//    in flight while this one is tested.
//
// Tried and left out (PERF.md has the numbers): leaving a slot early on
// the numerators of u, v and t, before the division. Once only the lanes
// that pass the box test run any slot, it saved nothing measurable.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace akr {

constexpr float kInf = INFINITY;
constexpr float kAnyHitRetired = -3e38f;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxLanes = 512;  // lanes of a sorted ray block: threads of a walking CUDA block

// box_pass widens the candidate's box by kBoxRel * s + kBoxAbs a side
constexpr float kBoxRel = 0.0009765625f;  // 2^-10
constexpr float kBoxAbs = 1e-6f;
// a triangle is a sliver if |e1 x e2| <= kSliverSin |e1| |e2|
constexpr float kSliverSin2 = 9.5367431640625e-07f;  // (2^-10)^2
constexpr int kSliverOnly = 1 << 16;  // in a queued lane's id: test the sliver slots only

// One lane's ray as the sorted structure-of-arrays holds it: origin,
// direction, [tmin, tlim], three exclusion ids and the per-lane any-hit
// flag (ex row 3 > 0.5); inv is the inverse direction of the slab tests
// (|d| clamped to 1e-20, as the sort computes it).
struct LaneRay {
  float wox, woy, woz, wdx, wdy, wdz, tmin, tlim, ex0, ex1, ex2;
  float ivx, ivy, ivz;
  bool sh;
};

// One lane's best hit: t, global id (as float, -1 none), u, v.
struct LaneBest {
  float t, id, u, v;
};

// Where the candidate test's work went (the kStats instantiations only):
// per thread, summed per block by add_cull_stats.
struct CullStats {
  unsigned units = 0;     // units of work run: a queued lane x 32 slots, one warp (lane 0 counts)
  unsigned lane_box = 0;  // (lane, candidate) pairs that passed the box test
  unsigned slots = 0;     // (lane, slot) pairs tested (padding slots are not)
  unsigned hits = 0;      // (lane, slot) pairs that hit
};
constexpr int kStatInts = 4;

__device__ __forceinline__ float slab_inverse(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ LaneRay load_lane_ray(const float* __restrict__ o,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ lim,
                                                 const float* __restrict__ ex, int64_t n,
                                                 int64_t lane) {
  LaneRay r;
  r.wox = o[lane]; r.woy = o[n + lane]; r.woz = o[2 * n + lane];
  r.wdx = d[lane]; r.wdy = d[n + lane]; r.wdz = d[2 * n + lane];
  r.tmin = lim[lane]; r.tlim = lim[n + lane];
  r.ex0 = ex[lane]; r.ex1 = ex[n + lane]; r.ex2 = ex[2 * n + lane];
  r.sh = ex[3 * n + lane] > 0.5f;
  r.ivx = slab_inverse(r.wdx); r.ivy = slab_inverse(r.wdy); r.ivz = slab_inverse(r.wdz);
  return r;
}

__device__ __forceinline__ LaneBest load_lane_best(const float* __restrict__ best, int64_t n,
                                                   int64_t lane) {
  return {best[lane], best[n + lane], best[2 * n + lane], best[3 * n + lane]};
}

__device__ __forceinline__ void store_lane_best(float* __restrict__ best, int64_t n,
                                                int64_t lane, const LaneBest& b) {
  best[lane] = b.t;
  best[n + lane] = b.id;
  best[2 * n + lane] = b.u;
  best[3 * n + lane] = b.v;
}

// The lane's live t-limit, whose block maximum is the horizon: its best t,
// or for any hit kAnyHitRetired once occluded, else its t-limit.
__device__ __forceinline__ float lane_limit(const LaneRay& r, const LaneBest& b, int any_hit) {
  return any_hit ? (b.id >= 0.f ? kAnyHitRetired : r.tlim) : b.t;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullWarp, v, off));
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

// Block-wide max of v, the same value in every thread, with one barrier:
// s_red holds two rows of 32 floats and `parity` (block-uniform, flipped
// here) picks the row, so the next call's writes cannot reach a row that a
// slow warp still reads. The barrier also orders every shared-memory access
// before it against those after it.
__device__ __forceinline__ float block_max(float v, float* s_red, int& parity) {
  float* row = s_red + 32 * parity;
  parity ^= 1;
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  float m = row[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, row[w]);
  return m;
}

// Floats of one staged candidate: C x 12 triangles | 16 transform | 8 box
// (min xyz, max xyz, sliver flag, 1 unused); a multiple of 4, so
// consecutive buffers stay 16-byte aligned.
__host__ __device__ constexpr int stage_floats(int C) { return C * 12 + 16 + 8; }

// The whole block starts the copy of candidate ci into `buf`: its C x 12
// triangle row (16 bytes a thread and pass), its 16-float world->local row
// (xf null: the caller wrote the identity once) and its box and sliver
// flag boxes[:, ci] (boxes [7, n_cand]). The copies are one cp.async group
// of each thread; stage_wait, then a barrier, makes them visible to the
// block.
// tri and xf must be 16-byte aligned (the entry points check).
__device__ __forceinline__ void stage_candidate(float* buf, const float* __restrict__ tri,
                                                const float* __restrict__ xf,
                                                const float* __restrict__ boxes, int n_cand,
                                                int64_t row, int64_t ci, int C) {
  const float4* src = reinterpret_cast<const float4*>(tri + row * C * 12);
  float4* dst = reinterpret_cast<float4*>(buf);
  for (int i = threadIdx.x; i < C * 3; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
  if (xf && threadIdx.x < 4)
    __pipeline_memcpy_async(dst + C * 3 + threadIdx.x,
                            reinterpret_cast<const float4*>(xf + ci * 16) + threadIdx.x,
                            sizeof(float4));
  if (threadIdx.x < 7)
    __pipeline_memcpy_async(buf + C * 12 + 16 + threadIdx.x,
                            boxes + int64_t(threadIdx.x) * n_cand + ci, sizeof(float));
  __pipeline_commit();
}

// This thread's staged copies have all landed.
__device__ __forceinline__ void stage_wait() { __pipeline_wait_prior(0); }

// The identity transform into a stage buffer's transform row (xf null).
__device__ __forceinline__ void stage_identity(float* buf, int C) {
  if (threadIdx.x < 16) {
    const int i = threadIdx.x;
    buf[C * 12 + i] = (i == 0 || i == 5 || i == 10) ? 1.f : 0.f;
  }
}

// Can the lane's ray, over [tmin, t1], reach the box widened by the margin
// (see the header's note 1)? box: min xyz | max xyz.
__device__ __forceinline__ bool box_pass(const float* box, const LaneRay& r, float t1) {
  const float s = fmaxf(fmaxf(fabsf(r.wox) + fmaxf(fabsf(box[0]), fabsf(box[3])),
                              fabsf(r.woy) + fmaxf(fabsf(box[1]), fabsf(box[4]))),
                        fabsf(r.woz) + fmaxf(fabsf(box[2]), fabsf(box[5])));
  const float m = kBoxRel * s + kBoxAbs;
  const float ax = ((box[0] - m) - r.wox) * r.ivx, bx = ((box[3] + m) - r.wox) * r.ivx;
  const float ay = ((box[1] - m) - r.woy) * r.ivy, by = ((box[4] + m) - r.woy) * r.ivy;
  const float az = ((box[2] - m) - r.woz) * r.ivz, bz = ((box[5] + m) - r.woz) * r.ivz;
  const float near = fmaxf(fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz)), r.tmin);
  const float far = fminf(fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz)), t1);
  return near <= far;
}

// Is the triangle a sliver (pairs.py::sliver_slots)?
__device__ __forceinline__ bool sliver(const float4& w0, const float4& w1, const float4& w2) {
  const float e1x = w0.w, e1y = w1.x, e1z = w1.y;
  const float e2x = w1.z, e2y = w1.w, e2z = w2.x;
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  return cx * cx + cy * cy + cz * cz <=
         kSliverSin2 * ((e1x * e1x + e1y * e1y + e1z * e1z) * (e2x * e2x + e2y * e2y + e2z * e2z));
}

// Möller-Trumbore of one ray (local origin o, direction d) against one
// triangle (vertex a, edges e1, e2), exactly as _mt_update writes it.
struct SlotTest {
  float t, u, v;
  bool ok;  // |det| > 1e-12, u >= 0, v >= 0, u + v <= 1
};

__device__ __forceinline__ SlotTest mt_slot(const float4& w0, const float4& w1, const float4& w2,
                                            const float4& q0, const float4& q1) {
  const float ox = q0.x, oy = q0.y, oz = q0.z, dx = q0.w, dy = q1.x, dz = q1.y;
  const float ax = w0.x, ay = w0.y, az = w0.z;
  const float e1x = w0.w, e1y = w1.x, e1z = w1.y;
  const float e2x = w1.z, e2y = w1.w, e2z = w2.x;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = ox - ax, ty = oy - ay, tz = oz - az;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (qx * dx + qy * dy + qz * dz) * inv_det;
  const float t = (qx * e2x + qy * e2y + qz * e2z) * inv_det;
  return {t, u, v, ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f};
}

// Shared-memory scratch of candidate_test, beside the staged candidate:
// the rays of the queued lanes (12 floats each: local origin and
// direction, tmin, best t, three exclusion ids, the lane with kSliverOnly
// if it failed the box test), each
// lane's result key, and the count of passing lanes.
struct CullScratch {
  float* pass;               // [blockDim.x][12], 16-byte aligned
  unsigned long long* key;   // [blockDim.x]
  int* count;                // [1], zero between calls
};
__host__ __device__ constexpr int scratch_floats(int lanes) { return lanes * 12 + lanes * 2 + 4; }

__device__ __forceinline__ CullScratch cull_scratch(float* base, int lanes) {
  return {base, reinterpret_cast<unsigned long long*>(base + lanes * 12),
          reinterpret_cast<int*>(base + lanes * 14)};
}

constexpr unsigned long long kNoHit = ~0ull;

// A float as an unsigned that orders the same way (for atomicMin).
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The whole block against the candidate staged in `buf` (stage_candidate's
// layout, visible to every thread), each lane's box test over [tmin,
// box_t1] (box_t1 >= b.t: the lane's best t, or for K1 that t widened);
// folds an improvement into each lane's b. Every thread of the block must
// call it: it holds two barriers. The caller's next barrier must come
// before the next call (it does: the horizon's).
//
// 1. Each lane runs box_pass and the lanes that pass queue their ray, in
//    the candidate's local space, in shared memory (a warp ballot, one
//    atomicAdd a warp). On classroom one or two lanes in a hundred pass.
//    Where the candidate holds sliver triangles, the lanes that fail but
//    can still be hit are queued too, for the sliver slots alone.
// 2. The block's warps share out the queue, a unit of work being one
//    queued lane against 32 consecutive slots, one slot a thread, so the
//    C slots of the few lanes that matter run side by side over all the
//    warps instead of one after another in the lane's own thread. A slot
//    that hits (mt_slot, then _mt_update's compares) sends atomicMin to
//    the lane's key: (t, slot) for closest hit, which is
//    _mt_update's pick (least t, first slot among equals), or the least
//    hitting global id for any hit. atomicMin is exact and commutes, so the
//    result does not depend on the order of the queue or of the units.
// 3. Each queued lane reads its key; a closest-hit lane that was hit runs
//    the winning slot once more for its t, u, v and id (the same operations
//    on the same values: the same bits).
template <bool kStats>
__device__ __forceinline__ void candidate_test(const float* buf, int C, const LaneRay& r,
                                               LaneBest& b, float box_t1, int any_hit,
                                               const CullScratch& s, CullStats& st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float4* t4 = reinterpret_cast<const float4*>(buf);
  const float* box = buf + C * 12 + 16;
  // t > tmin and t < b.t cannot both hold for a lane with b.t <= tmin
  const bool live = b.t > r.tmin;
  const bool in_box = live && box_pass(box, r, box_t1);
  const bool active = in_box || (live && box[6] > 0.f);  // box[6]: the row holds slivers
  const unsigned vote = __ballot_sync(kFullWarp, active);
  int pos = 0;
  if (vote) {
    if (lane == 0) pos = atomicAdd(s.count, __popc(vote));
    pos = __shfl_sync(kFullWarp, pos, 0) + __popc(vote & ((1u << lane) - 1u));
  }
  if (active) {
    const float* x = buf + C * 12;
    float4* q = reinterpret_cast<float4*>(s.pass + 12 * pos);
    q[0] = make_float4(x[0] * r.wox + x[1] * r.woy + x[2] * r.woz + x[3],
                       x[4] * r.wox + x[5] * r.woy + x[6] * r.woz + x[7],
                       x[8] * r.wox + x[9] * r.woy + x[10] * r.woz + x[11],
                       x[0] * r.wdx + x[1] * r.wdy + x[2] * r.wdz);
    q[1] = make_float4(x[4] * r.wdx + x[5] * r.wdy + x[6] * r.wdz,
                       x[8] * r.wdx + x[9] * r.wdy + x[10] * r.wdz, r.tmin, b.t);
    q[2] = make_float4(r.ex0, r.ex1, r.ex2,
                       __int_as_float(int(threadIdx.x) | (in_box ? 0 : kSliverOnly)));
    s.key[threadIdx.x] = kNoHit;
  }
  const int queued = __syncthreads_count(active);
  if (queued == 0) return;  // block-uniform
  if (kStats) st.lane_box += in_box;

  const float id_off = buf[C * 12 + 12];
  const int chunks = (C + 31) >> 5;
  for (int unit = warp; unit < queued * chunks; unit += nwarps) {
    const int p = unit / chunks;
    const int j = ((unit - p * chunks) << 5) + lane;
    if (kStats) st.units += 1;
    if (j >= C) continue;
    const float4 w0 = t4[3 * j], w1 = t4[3 * j + 1], w2 = t4[3 * j + 2];
    const float gid = w2.y;
    if (!(gid >= 0.f)) continue;  // padding
    const float4* q = reinterpret_cast<const float4*>(s.pass + 12 * p);
    const float4 q0 = q[0], q1 = q[1], q2 = q[2];
    const int who = __float_as_int(q2.w);
    if ((who & kSliverOnly) && !sliver(w0, w1, w2)) continue;
    const SlotTest m = mt_slot(w0, w1, w2, q0, q1);
    const float gidw = gid + id_off;
    const bool hit = m.ok && m.t > q1.z && m.t < q1.w && gidw != q2.x && gidw != q2.y &&
                     gidw != q2.z;
    if (kStats) {
      st.slots += 1;
      st.hits += hit;
    }
    if (hit) {
      const unsigned long long k =
          any_hit ? (unsigned long long)ordered_bits(gidw)
                  : ((unsigned long long)ordered_bits(m.t) << 32) | (unsigned)j;
      atomicMin(s.key + (who & (kSliverOnly - 1)), k);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *s.count = 0;
  if (!active) return;
  const unsigned long long k = s.key[threadIdx.x];
  if (k == kNoHit) return;
  if (any_hit) {
    b.id = __uint_as_float(unsigned(k) & 0x7fffffffu);  // ordered_bits of an id >= 0
    return;
  }
  // the winning slot once more, for this lane alone
  const int j = int(unsigned(k));
  const float4* q = reinterpret_cast<const float4*>(s.pass + 12 * pos);
  const SlotTest m = mt_slot(t4[3 * j], t4[3 * j + 1], t4[3 * j + 2], q[0], q[1]);
  b.t = r.sh ? kAnyHitRetired : m.t;
  b.id = t4[3 * j + 2].y + id_off;
  b.u = m.u;
  b.v = m.v;
}

// Sum a block's CullStats into stats[kStatInts * block ..) (zeroed by the
// caller), in the struct's order.
__device__ __forceinline__ void add_cull_stats(int32_t* __restrict__ stats, int block,
                                               const CullStats& st) {
  const unsigned v[kStatInts] = {st.units, warp_sum(st.lane_box), warp_sum(st.slots),
                                 warp_sum(st.hits)};
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kStatInts; ++i) atomicAdd(stats + kStatInts * block + i, int(v[i]));
  }
}

}  // namespace akr
