// The pair sweep's kernels for Hopper (sm_90a): K2 (conservative cull), K3
// (per-ray refine), K5 (the windowed walk's window refine) and K4 (the
// candidate walk and sweep, which also serves K6).
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
// the 36-op interval chain (origin box x inverse-direction interval against
// the cluster's slabs, per axis), clamps entry by the block's min tmin and
// exit by its max t-limit, and writes the entry or +inf.
//
// Bound: writing e_con, [B, K] f32 (75 MB at 1920x1080 with K = 4,633); the
// ~40 flops per element are far below the card's rate for that traffic.
// Design: one thread per element with neighbouring threads on neighbouring
// clusters, so the output store and the cb6 loads coalesce; a block's 16
// summary floats are the same for every thread of a row and come from L1.
constexpr int kCullThreads = 256;

__global__ void __launch_bounds__(kCullThreads)
cull_kernel(const float* __restrict__ summ, const float* __restrict__ cb6,
            float* __restrict__ out, int B, int K) {
  const int64_t idx = int64_t(blockIdx.x) * kCullThreads + threadIdx.x;
  if (idx >= int64_t(B) * K) return;
  const int b = int(idx / K);
  const int k = int(idx - int64_t(b) * K);
  const float* s = summ + int64_t(b) * 16;
  float entry = -kInf, exit_ = kInf;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float bmin = cb6[int64_t(a) * K + k];
    const float bmax = cb6[int64_t(3 + a) * K + k];
    const float olo = s[a], ohi = s[3 + a], il = s[6 + a], ih = s[9 + a];
    const float n0lo = bmin - ohi, n0hi = bmin - olo;
    const float n1lo = bmax - ohi, n1hi = bmax - olo;
    float p1 = n0lo * il, p2 = n0lo * ih, p3 = n0hi * il, p4 = n0hi * ih;
    const float t0lo = fminf(fminf(p1, p2), fminf(p3, p4));
    const float t0hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    p1 = n1lo * il; p2 = n1lo * ih; p3 = n1hi * il; p4 = n1hi * ih;
    const float t1lo = fminf(fminf(p1, p2), fminf(p3, p4));
    const float t1hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    entry = fmaxf(entry, fminf(t0lo, t1lo));
    exit_ = fminf(exit_, fmaxf(t0hi, t1hi));
  }
  entry = fmaxf(entry, s[12]);  // block min tmin
  exit_ = fminf(exit_, s[13]);  // block max t-limit (the initial horizon)
  out[idx] = entry <= exit_ ? entry : kInf;
}

// ---------------------------------------------------------------------- K3
// Replaces akari_render_tpu/accel/pairs.py::_refine_all_kernel (via
// _refine_all). For one (ray block, tile of kRefineTile clusters): every
// cluster's minimum entry over the block's lanes whose own [tmin, t-limit]
// slab interval overlaps it, +inf if none. A tile whose e_con (K2) is all
// +inf is +inf without slab math: the per-ray pass set is a subset of the
// conservative one, and coherent blocks reject most tiles.
//
// Bound: FP32 ALU on the tiles that survive the predication (~20 flops per
// lane x cluster, BLOCK x K per surviving block), and the [B, K] e_con
// read and e_init write for the rest. Design: one CUDA block per (ray
// block, tile); the ray block's 512 lanes of origin, inverse direction and
// limits are staged once in shared memory (16 KB) and every thread, owning
// one cluster, loops over them in order, reading each lane as a broadcast.
// The tile vote is __syncthreads_or. `min` is exact, so the result does not
// depend on the lane order.
constexpr int kRefineTile = 256;

__global__ void __launch_bounds__(kRefineTile)
refine_all_kernel(const float* __restrict__ cb6, const float* __restrict__ o,
                  const float* __restrict__ inv, const float* __restrict__ lim,
                  const float* __restrict__ e_con, float* __restrict__ out, int K,
                  int n, int block_lanes) {
  extern __shared__ float s_lane[];  // [8][block_lanes]: o xyz, inv xyz, tmin, t1
  const int b = blockIdx.y;
  const int k = blockIdx.x * kRefineTile + threadIdx.x;
  const bool in_range = k < K;
  const int64_t row = int64_t(b) * K + k;
  const bool con = in_range && e_con[row] < kInf;
  if (!__syncthreads_or(con)) {
    if (in_range) out[row] = kInf;
    return;
  }
  const int64_t lane0 = int64_t(b) * block_lanes;
  for (int i = threadIdx.x; i < block_lanes; i += kRefineTile) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_lane[a * block_lanes + i] = o[a * int64_t(n) + lane0 + i];
      s_lane[(3 + a) * block_lanes + i] = inv[a * int64_t(n) + lane0 + i];
    }
    s_lane[6 * block_lanes + i] = lim[lane0 + i];
    s_lane[7 * block_lanes + i] = lim[int64_t(n) + lane0 + i];
  }
  __syncthreads();
  if (!in_range) return;
  float bmin[3], bmax[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = cb6[int64_t(a) * K + k];
    bmax[a] = cb6[int64_t(3 + a) * K + k];
  }
  float best = kInf;
  for (int l = 0; l < block_lanes; ++l) {
    float near = -kInf, far = kInf;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float oa = s_lane[a * block_lanes + l];
      const float ia = s_lane[(3 + a) * block_lanes + l];
      const float t0 = (bmin[a] - oa) * ia;
      const float t1 = (bmax[a] - oa) * ia;
      near = fmaxf(near, fminf(t0, t1));
      far = fminf(far, fmaxf(t0, t1));
    }
    near = fmaxf(near, s_lane[6 * block_lanes + l]);
    far = fminf(far, s_lane[7 * block_lanes + l]);
    best = fminf(best, near <= far ? near : kInf);
  }
  out[row] = best;
}

// ---------------------------------------------------------------------- K5
// Replaces akari_render_tpu/accel/pairs.py::_refine_kernel (via _refine).
// For one (ray block, tile of kRefineTile window members): 1 where any lane
// of the block has a [tmin, t1] slab interval that overlaps the member's
// box, else 0. wb is [B, 6, W] (min xyz | max xyz rows, W minor); lim row 1
// is the lane's current limit (its best t, -inf once occluded).
//
// Bound: FP32 ALU, 12 operations per lane x member until a lane passes
// (the output is 0 or 1, so a member's loop ends at its first passing
// lane), and the [B, 6, W] read. Design: K3's, with an OR over the lanes
// where K3 takes a min: the block's 512 lanes staged once in shared memory
// (16 KB), one thread per window member reading each lane as a broadcast.
__global__ void __launch_bounds__(kRefineTile)
window_refine_kernel(const float* __restrict__ wb, const float* __restrict__ o,
                     const float* __restrict__ inv, const float* __restrict__ lim,
                     int32_t* __restrict__ out, int W, int n, int block_lanes) {
  extern __shared__ float s_lane[];  // [8][block_lanes]: o xyz, inv xyz, tmin, t1
  const int b = blockIdx.y;
  const int w = blockIdx.x * kRefineTile + threadIdx.x;
  const int64_t lane0 = int64_t(b) * block_lanes;
  for (int i = threadIdx.x; i < block_lanes; i += kRefineTile) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_lane[a * block_lanes + i] = o[a * int64_t(n) + lane0 + i];
      s_lane[(3 + a) * block_lanes + i] = inv[a * int64_t(n) + lane0 + i];
    }
    s_lane[6 * block_lanes + i] = lim[lane0 + i];
    s_lane[7 * block_lanes + i] = lim[int64_t(n) + lane0 + i];
  }
  __syncthreads();
  if (w >= W) return;
  float bmin[3], bmax[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bmin[a] = wb[(int64_t(b) * 6 + a) * W + w];
    bmax[a] = wb[(int64_t(b) * 6 + 3 + a) * W + w];
  }
  int pass = 0;
  for (int l = 0; l < block_lanes && !pass; ++l) {
    float near = -kInf, far = kInf;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float oa = s_lane[a * block_lanes + l];
      const float ia = s_lane[(3 + a) * block_lanes + l];
      const float t0 = (bmin[a] - oa) * ia;
      const float t1 = (bmax[a] - oa) * ia;
      near = fmaxf(near, fminf(t0, t1));
      far = fminf(far, fmaxf(t0, t1));
    }
    near = fmaxf(near, s_lane[6 * block_lanes + l]);
    far = fminf(far, s_lane[7 * block_lanes + l]);
    pass = near <= far;
  }
  out[int64_t(b) * W + w] = pass;
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
// horizon only shrinks); else it stages the candidate's C x 12 triangle row
// and its 16-float world->local row in shared memory, and each thread (one
// lane) transforms its ray with the unnormalised local direction (t stays
// the world parameter) and tests the C slots in order.
//
// The candidate test itself (candidate_test.cuh) is shared with K7.
//
// Bound: FP32 ALU, ~30 flops per ray x triangle test, C tests per lane and
// candidate, plus a block-wide max per candidate. Design: triangles and
// transform in shared memory (6 KB, read as broadcasts), the ray and its
// best hit in registers; a lane that cannot hit (t-limit <= tmin) skips
// the slot loop.
//
// With early_out 0 the same kernel serves K6 (_sweep_kernel): every
// candidate of the list is tested (no horizon, no block reduction), except
// those whose entry is +inf, which mark JAX's dummy rows. `walked` (or
// null) receives each block's count of candidates tested.
__global__ void sweep_kernel(const int32_t* __restrict__ worder, const float* __restrict__ went,
                             const int32_t* __restrict__ kcnt, const int32_t* __restrict__ tri_row,
                             const float* __restrict__ tri, const float* __restrict__ xf,
                             const float* __restrict__ o, const float* __restrict__ d,
                             const float* __restrict__ lim, const float* __restrict__ ex,
                             float* __restrict__ best, int K, int C, int n, int any_hit,
                             int early_out, int32_t* __restrict__ walked) {
  extern __shared__ float smem[];
  float* s_tri = smem;              // [C * 12]
  float* s_xf = smem + C * 12;      // [16]
  float* s_red = s_xf + 16;         // [32] per-warp maxima
  const int b = blockIdx.x;
  const int nwarps = blockDim.x >> 5;
  const int64_t lane = int64_t(b) * blockDim.x + threadIdx.x;
  const akr::LaneRay ray = akr::load_lane_ray(o, d, lim, ex, n, lane);
  akr::LaneBest hit = akr::load_lane_best(best, n, lane);

  const int cnt = kcnt[b];
  const int64_t wrow = int64_t(b) * K;
  int steps = 0;
  for (int k = 0; k < cnt; ++k) {
    const float e = went[wrow + k];
    if (early_out) {
      // block horizon; the first barrier also ends the previous step's reads
      const float h = akr::warp_max(akr::lane_limit(ray, hit, any_hit));
      __syncthreads();
      if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = h;
      __syncthreads();
      float horizon = s_red[0];
      for (int w = 1; w < nwarps; ++w) horizon = fmaxf(horizon, s_red[w]);
      if (!(e <= horizon)) break;  // ascending entries, shrinking horizon: done
    } else {
      if (!(e < kInf)) continue;  // a dummy candidate (the same for the whole block)
      __syncthreads();            // the previous step's reads end
    }
    ++steps;
    const int ci = worder[wrow + k];
    akr::stage_candidate(s_tri, s_xf, tri, xf, tri_row ? tri_row[ci] : ci, ci, C);
    __syncthreads();
    akr::candidate_test(s_tri, s_xf, C, ray, hit, any_hit);
  }
  if (walked && threadIdx.x == 0) walked[b] = steps;
  akr::store_lane_best(best, n, lane, hit);
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; each launches on `stream` and returns cudaGetLastError().

// K2: summ [B, 16], cb6 [6, K] -> out [B, K].
extern "C" int akr_cull(const float* summ, const float* cb6, float* out, int B, int K,
                        void* stream) {
  const int64_t total = int64_t(B) * K;
  if (total <= 0) return 0;
  const unsigned grid = unsigned((total + kCullThreads - 1) / kCullThreads);
  cull_kernel<<<grid, kCullThreads, 0, static_cast<cudaStream_t>(stream)>>>(summ, cb6, out,
                                                                              B, K);
  return static_cast<int>(cudaGetLastError());
}

// K3: cb6 [6, K], o / inv [3, n], lim [2, n], e_con [B, K] -> out [B, K],
// n = B * block_lanes.
extern "C" int akr_refine_all(const float* cb6, const float* o, const float* inv,
                              const float* lim, const float* e_con, float* out, int B, int K,
                              int block_lanes, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const dim3 grid((K + kRefineTile - 1) / kRefineTile, B);
  const size_t smem = size_t(8) * block_lanes * sizeof(float);
  refine_all_kernel<<<grid, kRefineTile, smem, static_cast<cudaStream_t>(stream)>>>(
      cb6, o, inv, lim, e_con, out, K, B * block_lanes, block_lanes);
  return static_cast<int>(cudaGetLastError());
}

// K5: wb [B, 6, W], o / inv [3, n], lim [2, n] -> out [B, W] int32,
// n = B * block_lanes.
extern "C" int akr_refine_window(const float* wb, const float* o, const float* inv,
                                 const float* lim, int32_t* out, int B, int W, int block_lanes,
                                 void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const dim3 grid((W + kRefineTile - 1) / kRefineTile, B);
  const size_t smem = size_t(8) * block_lanes * sizeof(float);
  window_refine_kernel<<<grid, kRefineTile, smem, static_cast<cudaStream_t>(stream)>>>(
      wb, o, inv, lim, out, W, B * block_lanes, block_lanes);
  return static_cast<int>(cudaGetLastError());
}

// K4 (early_out 1) and K6 (early_out 0): worder [B, K] int32 candidate
// ids, went [B, K], kcnt [B] int32, tri_row (null: row = candidate id)
// and xf (null: identity) indexed by candidate id, tri [R, C, 12],
// o / d [3, n], lim [2, n], ex [4, n], best [4, n] in and out, walked [B]
// int32 out (or null); n = B * block_lanes, block_lanes a multiple of 32
// up to 1024.
extern "C" int akr_sweep(const int32_t* worder, const float* went, const int32_t* kcnt,
                         const int32_t* tri_row, const float* tri, const float* xf,
                         const float* o, const float* d, const float* lim, const float* ex,
                         float* best, int B, int K, int C, int block_lanes, int any_hit,
                         int early_out, int32_t* walked, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t(C) * 12 + 16 + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sweep_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_kernel<<<B, block_lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      worder, went, kcnt, tri_row, tri, xf, o, d, lim, ex, best, K, C, B * block_lanes,
      any_hit, early_out, walked);
  return static_cast<int>(cudaGetLastError());
}
