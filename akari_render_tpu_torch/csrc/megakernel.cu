// K8, the path megakernel, for Hopper (sm_90a).
//
// Replaces akari_render_tpu/integrators/megakernel.py::kernel (built by
// _make_kernel, launched by run_pass): one pass of whole paths. One thread
// per pixel runs `spp` samples, each: the hash-stream camera sample with a
// Gaussian (Box-Muller) or box filter jitter, a pinhole ray from r2c / c2w,
// then the bounce loop to max_depth (each lane leaves it when its path
// dies): closest hit by Möller-Trumbore over every triangle, emission with
// the MIS weight, an alias pick of a light and of its triangle, NEE with an
// any-hit shadow sweep that excludes the hit and the light triangle, the
// reduced principled closure from the baked material table in the ONB(ns)
// frame (reduced_closure.cuh), Russian roulette; then the final emission
// tap, clamp_indirect and the NaN guard. The plain version is
// integrators/megakernel.py::megakernel_pass_torch, op for op.
//
// Bound: FP32 operations. Each traced ray runs 46 FP32 operations per
// triangle (the shading adds a few hundred per bounce), and the work
// depends on the data, since paths end early: chip_smoke.py counts it
// from the rays this run traced (`rays` below). Design: every table the
// path reads (the [T, 41] attributes, T <= 512 so at most 84 KB, the
// emission, light and material tables and the camera) is staged once per
// block in dynamic shared memory, where the triangle loop reads each
// triangle as a broadcast; all path state stays in registers, and the only
// device-memory traffic is that staging and the [4, npix] result. Threads
// whose paths end early idle while their warp finishes; regrouping live
// paths is work for a later version.

#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include "reduced_closure.cuh"

namespace {

using akr::V3;

constexpr float kRayTmax = 1e20f;
constexpr int kThreads = 128;
constexpr int kAttr = 41;

struct Tables {
  const float *attr, *ce, *lsel, *loff, *ltab, *mat, *cam;
  int T, M, L, S;
};

__device__ __forceinline__ uint32_t hash_u64(uint32_t hi, uint32_t lo) {
  uint32_t x = lo ^ (hi * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float draw(uint32_t key, uint32_t& ctr) {
  uint32_t x = key ^ (ctr * 0x9E3779B9u);
  ctr += 1u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return float(x >> 8) * (1.0f / 16777216.0f);
}

// Möller-Trumbore over every triangle (tmin 0). Closest hit: ties keep the
// first triangle (strict <). Any hit: true at the first hit.
template <bool ANY>
__device__ __forceinline__ bool mt_sweep(const float* attr, int T, V3 o, V3 d, float tmax,
                                         int ex0, int ex1, float& best_t, int& best_row,
                                         float& bu, float& bv) {
  best_t = kRayTmax;
  best_row = -1;
  bu = 0.f;
  bv = 0.f;
  for (int j = 0; j < T; ++j) {
    const float* r = attr + j * kAttr;
    const float ax = r[0], ay = r[1], az = r[2];
    const float e1x = r[3], e1y = r[4], e1z = r[5];
    const float e2x = r[6], e2y = r[7], e2z = r[8];
    const float px = d.y * e2z - d.z * e2y;
    const float py = d.z * e2x - d.x * e2z;
    const float pz = d.x * e2y - d.y * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok_det = fabsf(det) > 1e-12f;
    const float inv_det = ok_det ? 1.0f / det : 0.0f;
    const float tx = o.x - ax, ty = o.y - ay, tz = o.z - az;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (qx * d.x + qy * d.y + qz * d.z) * inv_det;
    const float t = (qx * e2x + qy * e2y + qz * e2z) * inv_det;
    const bool hit = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < tmax &&
                     j != ex0 && j != ex1;
    if (ANY) {
      if (hit) return true;
    } else if (hit && t < best_t) {
      best_t = t;
      best_row = j;
      bu = u;
      bv = v;
    }
  }
  return best_row >= 0;
}

struct Si {
  V3 p, ng, ns;
  float area, prim_pdf;
  int mat, light_id;
};

__device__ __forceinline__ Si fetch_si(const float* attr, int tri, float b0, float b1) {
  const float* r = attr + (tri < 0 ? 0 : tri) * kAttr;
  const float w0 = 1.0f - b0 - b1;
  Si s;
  s.p = {r[0] + r[3] * b0 + r[6] * b1, r[1] + r[4] * b0 + r[7] * b1,
         r[2] + r[5] * b0 + r[8] * b1};
  s.ng = {r[9], r[10], r[11]};
  s.area = r[12];
  s.ns = akr::normalize3({w0 * r[13] + b0 * r[16] + b1 * r[19], w0 * r[14] + b0 * r[17] + b1 * r[20],
                          w0 * r[15] + b0 * r[18] + b1 * r[21]});
  s.mat = int(r[38]);
  s.light_id = int(r[39]);
  s.prim_pdf = r[40];
  return s;
}

// surface emission with the MIS weight against light sampling
__device__ __forceinline__ void add_emission(const Tables& tb, int depth, const Si& s, V3 o, V3 d,
                                             float prev_pdf, const float* beta, float* rad) {
  if (!(s.light_id >= 0 && akr::dot3(s.ng, d) < 0.f)) return;
  const float* le = tb.ce + 3 * s.mat;
  const float choice = tb.lsel[2 * tb.L + s.light_id];
  const V3 wi = {s.p.x - o.x, s.p.y - o.y, s.p.z - o.z};
  const float d2 = wi.x * wi.x + wi.y * wi.y + wi.z * wi.z;
  const float inv = 1.0f / sqrtf(akr::cmax(d2, 1e-30f));
  const float c = fabsf(akr::dot3(s.ng, {wi.x * inv, wi.y * inv, wi.z * inv}));
  const float lpdf =
      s.prim_pdf / akr::cmax(s.area, 1e-20f) * d2 / akr::cmax(c, 1e-6f) * choice;
  const float w = depth == 0 ? 1.0f : prev_pdf / akr::cmax(prev_pdf + lpdf, 1e-30f);
#pragma unroll
  for (int k = 0; k < 3; ++k) rad[k] = rad[k] + beta[k] * le[k] * w;
}

template <bool SPEC, bool METAL>
__global__ void __launch_bounds__(kThreads)
megakernel(Tables g, int width, int npix, int s0, int spp, uint32_t scramble, int max_depth,
           int rr_depth, float clamp_ind, int gaussian, float radius, float sigma,
           float* __restrict__ out, unsigned long long* __restrict__ rays) {
  extern __shared__ float smem[];
  // stage every table in shared memory
  Tables tb = g;
  {
    float* dst = smem;
    const float* src[7] = {g.attr, g.ce, g.lsel, g.loff, g.ltab, g.mat, g.cam};
    const int len[7] = {g.T * kAttr, g.M * 3, 3 * g.L, 2 * g.L, 4 * g.S, g.M * akr::kMatCols, 24};
    const float** slot[7] = {&tb.attr, &tb.ce, &tb.lsel, &tb.loff, &tb.ltab, &tb.mat, &tb.cam};
    for (int a = 0; a < 7; ++a) {
      for (int i = threadIdx.x; i < len[a]; i += blockDim.x) dst[i] = src[a][i];
      *slot[a] = dst;
      dst += len[a];
    }
  }
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const float* cam = tb.cam;  // r2c rows 0-2 (12), c2w 3x3 (9), origin (3)
  const float pix_x = float(pix % width), pix_y = float(pix / width);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned long long n_closest = 0, n_shadow = 0;

  for (int s = 0; s < spp; ++s) {
    const uint32_t key = hash_u64(uint32_t(s0 + s) ^ scramble, uint32_t(pix));
    uint32_t ctr = 0;
    const float u0 = draw(key, ctr), u1 = draw(key, ctr);
    float offx, offy;
    if (gaussian) {
      const float r = sqrtf(-2.0f * logf(akr::cmax(u0, 1e-10f)));
      const float th = akr::kTwoPi * u1;
      offx = akr::clampf(r * cosf(th) * sigma, -radius, radius);
      offy = akr::clampf(r * sinf(th) * sigma, -radius, radius);
    } else {
      offx = (u0 - 0.5f) * radius;
      offy = (u1 - 0.5f) * radius;
    }
    const float fx = pix_x + 0.5f + offx, fy = pix_y + 0.5f + offy;
    const V3 c = akr::normalize3({cam[0] * fx + cam[1] * fy + cam[3], cam[4] * fx + cam[5] * fy + cam[7],
                                  cam[8] * fx + cam[9] * fy + cam[11]});
    V3 d = {cam[12] * c.x + cam[13] * c.y + cam[14] * c.z,
            cam[15] * c.x + cam[16] * c.y + cam[17] * c.z,
            cam[18] * c.x + cam[19] * c.y + cam[20] * c.z};
    V3 o = {cam[21], cam[22], cam[23]};
    int excl = -1;
    float rad[3] = {0.f, 0.f, 0.f}, beta[3] = {1.f, 1.f, 1.f}, base[3] = {0.f, 0.f, 0.f};
    float prev_pdf = 0.f;
    bool active = true;
    int depth = 0;
    for (; depth < max_depth && active; ++depth) {
      float t, b0, b1;
      int tri;
      ++n_closest;
      const bool got = mt_sweep<false>(tb.attr, tb.T, o, d, kRayTmax, excl, -1, t, tri, b0, b1);
      Si si;
      if (got) {
        si = fetch_si(tb.attr, tri, b0, b1);
        add_emission(tb, depth, si, o, d, prev_pdf, beta, rad);
      }
      if (depth == 0) {
        base[0] = rad[0];
        base[1] = rad[1];
        base[2] = rad[2];
      }
      active = got;
      if (!active) break;
      const V3 wo = {-d.x, -d.y, -d.z};

      // NEE: alias pick of a light, then of its triangle
      const float ul0 = draw(key, ctr), ul1 = draw(key, ctr), ul2 = draw(key, ctr);
      const int L = tb.L, S = tb.S;
      const float scaled = ul0 * float(L);
      int li0 = int(scaled);
      li0 = li0 < 0 ? 0 : (li0 > L - 1 ? L - 1 : li0);
      const float frac = scaled - float(li0);
      const float p_own = tb.lsel[li0];
      const bool take = frac < p_own;
      const int light = take ? li0 : int(tb.lsel[L + li0]);
      const float u_rem = take ? frac / akr::cmax(p_own, 1e-20f)
                               : (frac - p_own) / akr::cmax(1.0f - p_own, 1e-20f);
      const float choice_pdf = tb.lsel[2 * L + light];
      const int lbase = int(tb.loff[light]);
      const int cnt = int(tb.loff[L + light]);
      const float scaled2 = akr::clampf(u_rem, 0.f, 0.9999999f) * float(cnt);
      int i2 = int(scaled2);
      i2 = i2 < 0 ? 0 : i2;
      i2 = i2 < cnt - 1 ? i2 : cnt - 1;
      const float frac2 = scaled2 - float(i2);
      const bool take2 = frac2 < tb.ltab[lbase + i2];
      const int local = take2 ? i2 : int(tb.ltab[S + lbase + i2]);
      const float lprim_pdf = tb.ltab[2 * S + lbase + local];
      const int ltri = int(tb.ltab[3 * S + lbase + local]);
      const bool lt = ul1 < ul2;
      const float lb0 = lt ? ul1 * 0.5f : ul1 - ul2 * 0.5f;
      const float lb1 = lt ? ul2 - ul1 * 0.5f : ul2 * 0.5f;
      const Si ls = fetch_si(tb.attr, ltri, lb0, lb1);
      V3 wi = {ls.p.x - si.p.x, ls.p.y - si.p.y, ls.p.z - si.p.z};
      const float d2 = wi.x * wi.x + wi.y * wi.y + wi.z * wi.z;
      const float dist = sqrtf(akr::cmax(d2, 1e-30f));
      wi = {wi.x / dist, wi.y / dist, wi.z / dist};
      const bool front_l = akr::dot3(wi, ls.ng) < 0.f;
      const float* le = tb.ce + 3 * ls.mat;
      const V3 li = front_l ? V3{le[0], le[1], le[2]} : V3{0.f, 0.f, 0.f};
      const float cos_l = fabsf(akr::dot3(ls.ng, wi));
      const float ls_pdf = lprim_pdf / akr::cmax(ls.area, 1e-20f) * d2 /
                           akr::cmax(cos_l, 1e-20f) * choice_pdf;
      const bool light_valid = isfinite(ls_pdf) && d2 > 0.f;

      // shade: the reduced closure in the ONB(ns) frame
      const float ub0 = draw(key, ctr), ub1 = draw(key, ctr), ub2 = draw(key, ctr);
      V3 ft, fb;
      akr::onb(si.ns, ft, fb);
      const akr::ShadeOut sh = akr::reduced_shade<SPEC, METAL, false>(
          tb.mat + si.mat * akr::kMatCols, ft, fb, si.ns, si.ng, wo, wi, li, ls_pdf, ub0, ub1,
          ub2);

      // shadow ray, excluding the hit and the light triangle
      if (light_valid) {
        ++n_shadow;
        const bool back = akr::dot3(si.ng, wi) < 0.f;
        const V3 sro = {akr::offset1(si.p.x, back ? -si.ng.x : si.ng.x),
                        akr::offset1(si.p.y, back ? -si.ng.y : si.ng.y),
                        akr::offset1(si.p.z, back ? -si.ng.z : si.ng.z)};
        float t_, b0_, b1_;
        int r_;
        const bool occ = mt_sweep<true>(tb.attr, tb.T, sro, wi, dist * 0.999f, tri, ltri, t_, r_,
                                        b0_, b1_);
        if (!occ) {
          rad[0] = rad[0] + beta[0] * sh.direct.x;
          rad[1] = rad[1] + beta[1] * sh.direct.y;
          rad[2] = rad[2] + beta[2] * sh.direct.z;
        }
      }

      // continue, then Russian roulette
      active = sh.valid;
      const float thr = active ? 1.0f / akr::cmax(sh.pdf, 1e-20f) : 0.f;
      if (active) {
        beta[0] = beta[0] * (sh.f.x * thr);
        beta[1] = beta[1] * (sh.f.y * thr);
        beta[2] = beta[2] * (sh.f.z * thr);
      }
      const float urr = draw(key, ctr);
      const float bmax = akr::tmaximum(beta[0], akr::tmaximum(beta[1], beta[2]));
      const float cont = depth + 1 > rr_depth ? akr::clampf(bmax, 0.f, 1.f) * 0.95f : 1.0f;
      active = active && urr < cont;
      const float inv_c = 1.0f / akr::cmax(cont, 1e-20f);
      beta[0] = beta[0] * inv_c;
      beta[1] = beta[1] * inv_c;
      beta[2] = beta[2] * inv_c;
      prev_pdf = sh.pdf;
      const bool back = akr::dot3(si.ng, sh.wi) < 0.f;
      o = {akr::offset1(si.p.x, back ? -si.ng.x : si.ng.x),
           akr::offset1(si.p.y, back ? -si.ng.y : si.ng.y),
           akr::offset1(si.p.z, back ? -si.ng.z : si.ng.z)};
      d = sh.wi;
      excl = tri;
    }
    // the final emission tap
    if (active) {
      float t, b0, b1;
      int tri;
      ++n_closest;
      if (mt_sweep<false>(tb.attr, tb.T, o, d, kRayTmax, excl, -1, t, tri, b0, b1))
        add_emission(tb, max_depth, fetch_si(tb.attr, tri, b0, b1), o, d, prev_pdf, beta, rad);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float v = rad[k];
      if (clamp_ind > 0.f) v = base[k] + akr::cmin(v - base[k], clamp_ind);
      acc[k] = acc[k] + (isfinite(v) ? v : 0.f);
    }
    acc[3] = acc[3] + 1.0f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[int64_t(k) * npix + pix] = acc[k];
  if (rays) {
    atomicAdd(rays, n_closest);
    atomicAdd(rays + 1, n_shadow);
  }
}

// Dynamic shared memory of a pass: every table it reads.
size_t megakernel_smem(int T, int M, int L, int S) {
  return (size_t(T) * kAttr + size_t(M) * 3 + 5 * size_t(L) + 4 * size_t(S) +
          size_t(M) * akr::kMatCols + 24) * sizeof(float);
}

auto megakernel_for(int has_spec, int has_metal) {
  if (has_spec && has_metal) return megakernel<true, true>;
  if (has_spec) return megakernel<true, false>;
  if (has_metal) return megakernel<false, true>;
  return megakernel<false, false>;
}

}  // namespace

// One pass. attr [T, 41], ce [M, 3], lsel [3, L], loff [2, L], ltab [4, S],
// mat [M, 32], cam [24] (all float32 device pointers) -> out [4, npix]
// (RGB sums, weight sums); rays (int64 [2], or null) gains the closest-hit
// and shadow rays traced. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue when the tables exceed shared
// memory).
extern "C" int akr_megakernel(const float* attr, int T, const float* ce, int M, const float* lsel,
                              const float* loff, int L, const float* ltab, int S,
                              const float* mat, const float* cam, int width, int npix, int s0,
                              int spp, unsigned scramble, int max_depth, int rr_depth,
                              float clamp_ind, int gaussian, float radius, float sigma,
                              int has_spec, int has_metal, float* out, long long* rays,
                              void* stream) {
  if (npix <= 0) return 0;
  const Tables g = {attr, ce, lsel, loff, ltab, mat, cam, T, M, L, S};
  const size_t smem = megakernel_smem(T, M, L, S);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = megakernel_for(has_spec, has_metal);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = unsigned((npix + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, width, npix, s0, spp, scramble, max_depth, rr_depth, clamp_ind, gaussian, radius, sigma,
      out, reinterpret_cast<unsigned long long*>(rays));
  return static_cast<int>(cudaGetLastError());
}

// K8's resources at a pass's table sizes (they set its shared memory) and
// lobes: out is a host array [6] (akr::kernel_info's layout).
extern "C" int akr_megakernel_kernel_info(int32_t* out, int T, int M, int L, int S, int has_spec,
                                          int has_metal) {
  return static_cast<int>(akr::kernel_info(megakernel_for(has_spec, has_metal), kThreads,
                                           megakernel_smem(T, M, L, S), out));
}
