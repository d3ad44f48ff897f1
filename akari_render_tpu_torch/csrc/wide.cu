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
// - an internal node's 128-word row is staged in shared memory; each lane
//   slab-tests the 8 child boxes against its live [tmin, t-limit]; a
//   child's entry is the minimum over the lanes that pass (8 block-wide
//   min-reductions); the children with an entry are pushed far-to-near in
//   the block's octant order (the nibbles of the node's order word for the
//   octant of the block's first lane, near-first, pushed from the last);
// - a leaf stages its candidate's C x 12 triangles and world->local row
//   and runs the candidate test shared with K4 (candidate_test.cuh), then
//   the horizon is refreshed.
//
// It computes what the plain version (accel/wide.py::wide_walk_torch)
// computes: the push order is fixed at build time, so the depth-first leaf
// order does not depend on how fresh the limits are; a dropped pop or an
// unpushed child lies beyond every lane's limit; the slab and candidate
// arithmetic is the same op for op (-fmad=false, IEEE division). Child
// boxes are f32 bit patterns in the int32 table; an empty slot's 1e38
// bounds overflow to +-inf, never NaN (the rays are finite, the inverse
// directions finite and non-zero), so fminf/fmaxf agree with torch.
//
// Bound: FP32 ALU: 8 x 12 slab operations per lane and node expanded, and
// the candidate test's ~47 x C + 33 per lane and leaf tested; the node
// table and triangle rows come from L2. Design: simple and right first:
// three barriers a node and four a leaf; the stack pushes are serial in
// thread 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "candidate_test.cuh"

namespace {

using akr::kInf;

constexpr int kStackDepth = 192;  // accel/wide.py STACK_DEPTH; build_wide asserts the tree fits
constexpr int kMaxLanes = 512;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max of v, the same value in every thread. s_red holds a float
// per warp; the trailing barrier frees it for the next use.
__device__ __forceinline__ float block_max(float v, float* s_red, int nwarps) {
  v = akr::warp_max(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, s_red[w]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kMaxLanes)
wide_walk_kernel(const int32_t* __restrict__ nodes, const float* __restrict__ tri,
                 const float* __restrict__ xf, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ lim,
                 const float* __restrict__ ex, float* __restrict__ best, int C, int n,
                 int any_hit, int32_t* __restrict__ counts) {
  __shared__ int32_t s_sid[kStackDepth];
  __shared__ float s_se[kStackDepth];
  __shared__ int32_t s_srow[kStackDepth];
  __shared__ int32_t s_node[128];
  __shared__ float s_red[8 * (kMaxLanes / 32)];  // [8][nwarps] per-warp minima, or [nwarps] maxima
  __shared__ float s_entry[8];
  __shared__ int s_sp;
  extern __shared__ float smem[];
  float* s_tri = smem;          // [C * 12]
  float* s_xf = smem + C * 12;  // [16]

  const int b = blockIdx.x;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int64_t lane0 = int64_t(b) * blockDim.x;
  const int64_t lane = lane0 + threadIdx.x;
  const akr::LaneRay ray = akr::load_lane_ray(o, d, lim, ex, n, lane);
  akr::LaneBest hit = akr::load_lane_best(best, n, lane);
  const float dv[3] = {ray.wdx, ray.wdy, ray.wdz};
  const float ov[3] = {ray.wox, ray.woy, ray.woz};
  float invd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    invd[a] = 1.0f / (fabsf(dv[a]) < 1e-20f ? (dv[a] < 0.f ? -1e-20f : 1e-20f) : dv[a]);
  // the block's octant: that of its first lane
  const int oct = (d[lane0] < 0.f ? 4 : 0) + (d[int64_t(n) + lane0] < 0.f ? 2 : 0) +
                  (d[2 * int64_t(n) + lane0] < 0.f ? 1 : 0);

  if (threadIdx.x == 0) {  // the root, entry -3e38
    s_sid[0] = 0;
    s_se[0] = kNeg;
    s_srow[0] = 0;
  }
  float horizon = block_max(akr::lane_limit(ray, hit, any_hit), s_red, nwarps);
  int sp = 1, expanded = 0, tested = 0;
  while (sp > 0) {
    const int sp1 = sp - 1;
    const int32_t val = s_sid[sp1];
    const float ent = s_se[sp1];
    const int32_t row = s_srow[sp1];
    sp = sp1;
    if (!(ent <= horizon)) continue;  // beyond every lane's limit (block-uniform)
    if (val < -1) {                   // a leaf: candidate -val - 2, triangle row `row`
      ++tested;
      akr::stage_candidate(s_tri, s_xf, tri, xf, row, -val - 2, C);
      __syncthreads();
      akr::candidate_test(s_tri, s_xf, C, ray, hit, any_hit);
      // its barriers also end this leaf's reads of s_tri
      horizon = block_max(akr::lane_limit(ray, hit, any_hit), s_red, nwarps);
      continue;
    }
    if (val < 0) continue;  // an empty slot is never pushed
    ++expanded;
    __syncthreads();  // every thread has read the popped entry
    if (threadIdx.x < 128) s_node[threadIdx.x] = nodes[int64_t(val) * 128 + threadIdx.x];
    __syncthreads();
    const float t1 = akr::lane_limit(ray, hit, any_hit);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float near = kNeg, far = -kNeg;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float bmin = __int_as_float(s_node[8 * a + s]);
        const float bmax = __int_as_float(s_node[8 * (3 + a) + s]);
        const float ta = (bmin - ov[a]) * invd[a];
        const float tb = (bmax - ov[a]) * invd[a];
        near = fmaxf(near, fminf(ta, tb));
        far = fminf(far, fmaxf(ta, tb));
      }
      near = fmaxf(near, ray.tmin);
      far = fminf(far, t1);
      const float e = warp_min(near <= far ? near : kInf);
      if ((threadIdx.x & 31) == 0) s_red[s * nwarps + warp] = e;
    }
    __syncthreads();
    if (threadIdx.x < 8) {
      float e = s_red[threadIdx.x * nwarps];
      for (int w = 1; w < nwarps; ++w) e = fminf(e, s_red[threadIdx.x * nwarps + w]);
      s_entry[threadIdx.x] = e;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int32_t ow = s_node[56 + oct];
      int top = sp1;
      for (int s = 7; s >= 0; --s) {  // far-to-near: the nibbles are near-first
        const int slot = (ow >> (4 * s)) & 7;
        const float e_s = s_entry[slot];
        const int32_t c_s = s_node[48 + slot];
        if (e_s < 1e30f && c_s != -1) {
          s_sid[top] = c_s;
          s_se[top] = e_s;
          s_srow[top] = s_node[64 + slot];
          ++top;
        }
      }
      s_sp = top;
    }
    __syncthreads();
    sp = s_sp;
  }
  if (counts && threadIdx.x == 0) {
    counts[2 * b] = expanded;
    counts[2 * b + 1] = tested;
  }
  akr::store_lane_best(best, n, lane, hit);
}

}  // namespace

// K7: nodes [Nn, 128] int32, tri [R, C, 12], xf [K, 16] by candidate id
// (null: identity), o / d [3, n], lim [2, n], ex [4, n], best [4, n] in and
// out, counts [B, 2] int32 out (nodes expanded, leaves tested; or null);
// n = B * block_lanes, block_lanes a multiple of 32 up to 512. All pointers
// are device pointers; launches on `stream`, returns cudaGetLastError().
extern "C" int akr_wide_walk(const int32_t* nodes, const float* tri, const float* xf,
                             const float* o, const float* d, const float* lim, const float* ex,
                             float* best, int B, int C, int block_lanes, int any_hit,
                             int32_t* counts, void* stream) {
  if (B <= 0) return 0;
  if (block_lanes <= 0 || block_lanes > kMaxLanes || block_lanes % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t(C) * 12 + 16) * sizeof(float);
  if (smem > 40 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(wide_walk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wide_walk_kernel<<<B, block_lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      nodes, tri, xf, o, d, lim, ex, best, C, B * block_lanes, any_hit, counts);
  return static_cast<int>(cudaGetLastError());
}
