// The candidate test of the cluster tier, shared by K4/K6 (pairs.cu) and
// K7 (wide.cu): one lane's ray against the C triangles of one candidate
// cluster, staged in shared memory with the candidate's world->local row.
//
// It repeats pairs.py::_mt_update (mt_block_update of the JAX package) op
// for op: the sources are built with -fmad=false and IEEE division, so the
// two traversals and their plain versions agree bit for bit.
//
// Closest hit takes a slot when t < the running best (strict), which equals
// the TPU's (t, first slot) pick within a candidate and its strict `<`
// across candidates; a lane with the per-lane any-hit flag drops its best t
// to kAnyHitRetired once a candidate improved it. Any hit keeps t and
// records the minimum global id of the hitting slots of each candidate
// that hits. Global ids are gid + xf[12] (the instance's id offset); gid <
// 0 marks padding. The ray is transformed with the unnormalised local
// direction, so t stays the world parameter.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace akr {

constexpr float kInf = INFINITY;
constexpr float kAnyHitRetired = -3e38f;

// One lane's ray as the sorted structure-of-arrays holds it: origin,
// direction, [tmin, tlim], three exclusion ids and the per-lane any-hit
// flag (ex row 3 > 0.5).
struct LaneRay {
  float wox, woy, woz, wdx, wdy, wdz, tmin, tlim, ex0, ex1, ex2;
  bool sh;
};

// One lane's best hit: t, global id (as float, -1 none), u, v.
struct LaneBest {
  float t, id, u, v;
};

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
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The whole block stages candidate ci: its C x 12 triangle row into s_tri
// and its 16-float world->local row into s_xf (identity when xf is null).
// The caller synchronises before (the previous reads end) and after.
__device__ __forceinline__ void stage_candidate(float* s_tri, float* s_xf,
                                                const float* __restrict__ tri,
                                                const float* __restrict__ xf, int64_t row,
                                                int64_t ci, int C) {
  const float* src = tri + row * C * 12;
  for (int i = threadIdx.x; i < C * 12; i += blockDim.x) s_tri[i] = src[i];
  if (threadIdx.x < 16) {
    const int i = threadIdx.x;
    s_xf[i] = xf ? xf[ci * 16 + i] : ((i == 0 || i == 5 || i == 10) ? 1.f : 0.f);
  }
}

// One lane against the staged candidate; folds an improvement into b.
__device__ __forceinline__ void candidate_test(const float* s_tri, const float* s_xf, int C,
                                               const LaneRay& r, LaneBest& b, int any_hit) {
  if (!(b.t > r.tmin)) return;  // t > tmin and t < b.t cannot both hold
  const float* x = s_xf;
  const float ox = x[0] * r.wox + x[1] * r.woy + x[2] * r.woz + x[3];
  const float oy = x[4] * r.wox + x[5] * r.woy + x[6] * r.woz + x[7];
  const float oz = x[8] * r.wox + x[9] * r.woy + x[10] * r.woz + x[11];
  const float dx = x[0] * r.wdx + x[1] * r.wdy + x[2] * r.wdz;
  const float dy = x[4] * r.wdx + x[5] * r.wdy + x[6] * r.wdz;
  const float dz = x[8] * r.wdx + x[9] * r.wdy + x[10] * r.wdz;
  const float id_off = x[12];
  float cur = b.t, su = 0.f, sv = 0.f, sg = 0.f;
  float gmin = kInf;
  for (int j = 0; j < C; ++j) {
    const float* t12 = s_tri + 12 * j;
    const float ax = t12[0], ay = t12[1], az = t12[2];
    const float e1x = t12[3], e1y = t12[4], e1z = t12[5];
    const float e2x = t12[6], e2y = t12[7], e2z = t12[8];
    const float gid = t12[9];
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
    const float gidw = gid + id_off;
    const bool base = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && t > r.tmin &&
                      gid >= 0.f && gidw != r.ex0 && gidw != r.ex1 && gidw != r.ex2;
    if (any_hit) {
      if (base && t < b.t) gmin = fminf(gmin, gidw);
    } else if (base && t < cur) {
      cur = t; su = u; sv = v; sg = gidw;
    }
  }
  if (any_hit) {
    if (gmin < kInf) b.id = gmin;
  } else if (cur < b.t) {
    b.t = r.sh ? kAnyHitRetired : cur;
    b.id = sg; b.u = su; b.v = sv;
  }
}

}  // namespace akr
