// Brute-force Möller-Trumbore ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel akari_render_tpu/accel/pallas_intersect.py::_kernel
// (K1): every ray against every triangle, closest hit or any hit, with three
// per-ray excluded triangle ids.
//
// Bound: FP32 ALU. One ray-triangle test is about 30 flops against the
// 40 bytes a ray reads once (origin, direction, tmin, tmax, three ids), so
// at thousands of triangles per ray the kernel is compute-bound. The design
// keeps the triangle list in shared memory (each block stages TILE triangles
// of 9 floats at a time, every thread helping to load) and the running best
// hit in registers; the TPU kernel's sequential triangle-chunk grid axis
// becomes the in-block tile loop. One thread per ray.
//
// Semantics (held against the plain torch version, accel/trace.py):
//   - best_t starts at min(tmax, RAY_TMAX); a hit needs t > tmin and
//     t < best_t (strict), so with ascending triangle ids the first
//     triangle wins ties;
//   - |det| > 1e-12, u >= 0, v >= 0, u + v <= 1;
//   - exclusion ids are int32, -1 for none (a null pointer means all -1);
//   - a miss returns t = RAY_TMAX, id -1, u = v = 0;
//   - any hit: a ray stops at its first hit; only the flag is written.
// Build with -fmad=false: every product and sum then rounds on its own, as
// torch's elementwise ops do, so ids and hit flags match the plain version
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr float kRayTmax = 1e20f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
mt_kernel(const float* __restrict__ o, const float* __restrict__ d,
          const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
          const int32_t* __restrict__ ex0_in, const int32_t* __restrict__ ex1_in,
          const int32_t* __restrict__ ex2_in, const float* __restrict__ v0,
          const float* __restrict__ e1, const float* __restrict__ e2, int n,
          int num_tris, float* __restrict__ out_t, int32_t* __restrict__ out_id,
          float* __restrict__ out_u, float* __restrict__ out_v,
          uint8_t* __restrict__ out_occ) {
  __shared__ float tri[kTile * 9];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, best_t = -1.f;
  int32_t ex0 = -1, ex1 = -1, ex2 = -1;
  if (in_range) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tmin = tmin_in[i];
    best_t = fminf(tmax_in[i], kRayTmax);
    if (ex0_in) ex0 = ex0_in[i];
    if (ex1_in) ex1 = ex1_in[i];
    if (ex2_in) ex2 = ex2_in[i];
  }
  int32_t best_id = -1;
  float best_u = 0.f, best_v = 0.f;
  // a lane is done when its interval is empty or (any hit) it found a hit
  bool done = !in_range || !(best_t > tmin);

  for (int base = 0; base < num_tris; base += kTile) {
    if (__syncthreads_and(done)) break;  // also fences the previous tile
    const int count = min(kTile, num_tris - base);
    for (int k = threadIdx.x; k < count * 9; k += kThreads) {
      const int j = k / 9, c = k - 9 * j;
      const int src = 3 * (base + j) + (c % 3);
      tri[k] = c < 3 ? v0[src] : (c < 6 ? e1[src] : e2[src]);
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < count; ++j) {
      const float* t9 = tri + 9 * j;
      const float ax = t9[0], ay = t9[1], az = t9[2];
      const float e1x = t9[3], e1y = t9[4], e1z = t9[5];
      const float e2x = t9[6], e2y = t9[7], e2z = t9[8];
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
      const int32_t id = base + j;
      const bool hit = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f &&
                       t > tmin && t < best_t && id != ex0 && id != ex1 &&
                       id != ex2;
      if (hit) {
        best_id = id;
        if (kAnyHit) {
          done = true;
          break;
        }
        best_t = t;
        best_u = u;
        best_v = v;
      }
    }
  }
  if (!in_range) return;
  if (kAnyHit) {
    out_occ[i] = best_id >= 0 ? 1 : 0;
  } else {
    const bool hit = best_id >= 0;
    out_t[i] = hit ? best_t : kRayTmax;
    out_id[i] = best_id;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers; ex0..ex2 may be null. Launches on `stream` and returns
// cudaGetLastError() (0 on success). Closest hit writes out_t/out_id/out_u/
// out_v; any hit writes out_occ (one byte per ray).
extern "C" int akr_intersect(const float* o, const float* d, const float* tmin,
                             const float* tmax, const int32_t* ex0,
                             const int32_t* ex1, const int32_t* ex2,
                             const float* v0, const float* e1, const float* e2,
                             int n, int num_tris, int any_hit, float* out_t,
                             int32_t* out_id, float* out_u, float* out_v,
                             uint8_t* out_occ, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    mt_kernel<true><<<grid, kThreads, 0, s>>>(o, d, tmin, tmax, ex0, ex1, ex2,
                                              v0, e1, e2, n, num_tris, out_t,
                                              out_id, out_u, out_v, out_occ);
  } else {
    mt_kernel<false><<<grid, kThreads, 0, s>>>(o, d, tmin, tmax, ex0, ex1, ex2,
                                               v0, e1, e2, n, num_tris, out_t,
                                               out_id, out_u, out_v, out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}
