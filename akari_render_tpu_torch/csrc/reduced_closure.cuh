// The reduced principled closure (diffuse + metal + specular layer, from
// the baked [M, 32] material table) for one lane, shared by K8
// (megakernel.cu) and K9 with its roughness and evaluation entries
// (fused_shade.cu).
//
// Each function repeats its plain torch counterpart in
// svm/reduced.py op for op (the sources are built with
// -fmad=false and IEEE sqrt and division), and the clamps propagate NaN as
// torch.clamp, torch.minimum and torch.maximum do.
#pragma once

#include <math.h>
#include <stdint.h>

namespace akr {

constexpr int kMatCols = 32;
constexpr int kMtRefl = 0, kMtAlpha = 3, kMtMetal = 4, kMtSpecEta = 5, kMtSpecCol = 6;
constexpr int kMtN = 9, kMtK = 12, kMtRough = 15, kMtLut = 16, kNcAlbedo = 16;
constexpr float kPi = float(3.14159265358979323846);
constexpr float kInvPi = float(1.0 / 3.14159265358979323846);
constexpr float kTwoPi = float(2.0 * 3.14159265358979323846);
constexpr float kThird = float(1.0 / 3.0);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float cmax(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmin(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return cmin(cmax(x, lo), hi); }
__device__ __forceinline__ float tminimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float tmaximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : -1.f; }
__device__ __forceinline__ float tsign(float x) { return float((0.f < x) - (x < 0.f)); }

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 normalize3(V3 v) {
  const float inv = 1.0f / sqrtf(cmax(v.x * v.x + v.y * v.y + v.z * v.z, 1e-30f));
  return {v.x * inv, v.y * inv, v.z * inv};
}

// orthonormal_basis of a unit normal: (t, b)
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.f ? 1.f : -1.f;
  const float a = -1.0f / (sign + n.z);
  const float bb = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = {bb, sign + n.y * n.y * a, -n.y};
}

__device__ __forceinline__ float offset1(float p, float n) {
  const int of_i = int(256.0f * n);
  const float p_i = __int_as_float(__float_as_int(p) + (p < 0.f ? -of_i : of_i));
  return fabsf(p) < (1.0f / 32.0f) ? p + (1.0f / 65536.0f) * n : p_i;
}

__device__ __forceinline__ float fr_dielectric1(float ci, float eta) {
  ci = clampf(ci, -1.f, 1.f);
  eta = ci > 0.f ? eta : 1.0f / eta;
  ci = fabsf(ci);
  const float sin2_t = (1.0f - ci * ci) / cmax(eta * eta, 1e-12f);
  const float cos_t = sqrtf(cmax(1.0f - sin2_t, 0.f));
  const float r_parl = (eta * ci - cos_t) / cmax(eta * ci + cos_t, 1e-12f);
  const float r_perp = (ci - eta * cos_t) / cmax(ci + eta * cos_t, 1e-12f);
  const float fr = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return sin2_t >= 1.0f ? 1.0f : clampf(fr, 0.f, 1.f);
}

__device__ __forceinline__ float fr_complex1(float ci, float n, float k) {
  ci = clampf(ci, 0.f, 0.999f);
  const float sin2 = 1.0f - ci * ci;
  const float e2r = n * n - k * k;
  const float e2i = 2.0f * n * k;
  const float den = cmax(e2r * e2r + e2i * e2i, 1e-30f);
  const float s2tr = sin2 * e2r / den;
  const float s2ti = -sin2 * e2i / den;
  const float ar = 1.0f - s2tr, ai = -s2ti;
  const float r = sqrtf(cmax(ar * ar + ai * ai, 0.f));
  const float ctr = sqrtf(cmax((r + ar) * 0.5f, 0.f));
  const float cti = tsign(ai) * sqrtf(cmax((r - ar) * 0.5f, 0.f));
  const float ecr = n * ci, eci = k * ci;
  float nr = ecr - ctr, ni = eci - cti, dr = ecr + ctr, di = eci + cti;
  const float rp2 = (nr * nr + ni * ni) / cmax(dr * dr + di * di, 1e-30f);
  const float ect_r = n * ctr - k * cti;
  const float ect_i = n * cti + k * ctr;
  nr = ci - ect_r;
  ni = -ect_i;
  dr = ci + ect_r;
  di = ect_i;
  const float rs2 = (nr * nr + ni * ni) / cmax(dr * dr + di * di, 1e-30f);
  return 0.5f * (rp2 + rs2);
}

__device__ __forceinline__ float ggx_d1(float a, float whz) {
  const float cos2 = whz * whz;
  const float cos4 = cos2 * cos2;
  const float sin2 = cmax(1.0f - cos2, 0.f);
  const bool zero_c = cos2 <= 0.f;
  const float tan2 = sin2 / (zero_c ? 1.0f : cos2);
  const float e = tan2 / (a * a);
  const float q = 1.0f + e;
  const float inv_d = kPi * a * a * cos4 * (q * q);
  const bool bad = zero_c || inv_d == 0.f || !isfinite(inv_d);
  return bad ? 0.f : 1.0f / inv_d;
}

__device__ __forceinline__ float ggx_lambda1(float a, float wz) {
  const float cos2 = wz * wz;
  const float sin2 = cmax(1.0f - cos2, 0.f);
  const bool zero_c = cos2 <= 0.f;
  const float tan2 = sin2 / (zero_c ? 1.0f : cos2);
  const float lam = (-1.0f + sqrtf(1.0f + a * a * tan2)) * 0.5f;
  return zero_c ? 0.f : lam;
}

// (B, pdf, fcos) of the GGX reflection base, local frame
__device__ __forceinline__ void ggx_refl_base1(float a, V3 o, V3 i, float& B, float& pdf,
                                               float& fcos) {
  V3 wh = {o.x + i.x, o.y + i.y, o.z + i.z};
  const float dwho = dot3(wh, o);
  const float dwhi = dot3(i, wh);
  const bool degen = dwho * dwhi < 0.f || (wh.x == 0.f && wh.y == 0.f && wh.z == 0.f) ||
                     i.z == 0.f || o.z == 0.f || o.z * i.z <= 0.f;
  wh = normalize3(wh);
  fcos = dot3(i, wh) * (wh.z < 0.f ? -1.f : 1.f);
  const float d = ggx_d1(a, wh.z);
  const float g = 1.0f / (1.0f + ggx_lambda1(a, o.z) + ggx_lambda1(a, i.z));
  const float denom = i.z * o.z;
  const float b = fabsf(0.25f * d * g / (denom == 0.f ? 1.0f : denom)) * fabsf(i.z);
  const float dwo_wh = dot3(o, wh);
  const float g1o = 1.0f / (1.0f + ggx_lambda1(a, o.z));
  const float pdf_wh = d * g1o * fabsf(dwo_wh) / cmax(fabsf(o.z), 1e-12f);
  const float p = pdf_wh / cmax(4.0f * fabsf(dwo_wh), 1e-12f);
  B = degen ? 0.f : b;
  pdf = degen ? 0.f : p;
}

// visible-normal sample (Heitz 2018), isotropic, local frame
__device__ __forceinline__ V3 ggx_sample_wh1(float a, V3 o, float u0, float u1) {
  V3 h = normalize3({a * o.x, a * o.y, o.z});
  if (h.z < 0.f) h = {-h.x, -h.y, -h.z};
  const bool big = h.z >= 0.99999f;
  const float inv = 1.0f / sqrtf(cmax(h.x * h.x + h.y * h.y, 1e-30f));
  const V3 t1 = {big ? 1.0f : -h.y * inv, big ? 0.0f : h.x * inv, 0.0f};
  const V3 t2 = normalize3(
      {h.y * t1.z - h.z * t1.y, h.z * t1.x - h.x * t1.z, h.x * t1.y - h.y * t1.x});
  const float r = sqrtf(cmax(u0, 0.f));
  const float phi = u1 * kTwoPi;
  const float px = r * cosf(phi);
  const float py0 = r * sinf(phi);
  const float hh = sqrtf(cmax(1.0f - px * px, 0.f));
  const float py = hh + (py0 - hh) * ((1.0f + h.z) * 0.5f);
  const float pz = sqrtf(cmax(1.0f - px * px - py * py, 0.f));
  const float nx = px * t1.x + py * t2.x + pz * h.x;
  const float ny = px * t1.y + py * t2.y + pz * h.y;
  const float nz = px * t1.z + py * t2.z + pz * h.z;
  return normalize3({a * nx, a * ny, cmax(nz, 1e-6f)});
}

__device__ __forceinline__ float lut1(const float* lut, float cos) {
  const float c = fabsf(clampf(cos, -0.999f, 0.999f)) * float(kNcAlbedo - 1);
  int i0 = int(floorf(c));
  i0 = i0 < 0 ? 0 : (i0 > kNcAlbedo - 2 ? kNcAlbedo - 2 : i0);
  const float t = c - float(i0);
  const float v0 = lut[i0], v1 = lut[i0 + 1];
  return v0 + (v1 - v0) * t;
}

struct ShadeOut {
  V3 direct, wi, f, albedo;
  float pdf, roughness;
  bool valid;
};

struct Closure {
  const float* row;  // [kMatCols]
  V3 t, b, n, ng, lwo;
  float flip, alb_o;
  bool wo_ok;
};

__device__ __forceinline__ V3 to_local(const Closure& c, V3 v) {
  return {dot3(v, c.t), dot3(v, c.b), dot3(v, c.n)};
}

__device__ __forceinline__ bool side_ok(const Closure& c, V3 v) {
  return sgn(c.flip * dot3(v, c.n)) * sgn(dot3(v, c.ng)) > 0.f;
}

// The closure of a material row in the frame (t, b, n) with ng, for wo
// (the setup of svm/reduced.py::_Closure)
template <bool SPEC>
__device__ __forceinline__ Closure make_closure(const float* row, V3 t, V3 b, V3 n, V3 ng,
                                                V3 wo) {
  Closure c;
  c.row = row;
  c.t = t;
  c.b = b;
  c.n = n;
  c.ng = ng;
  c.flip = sgn(dot3(ng, n));
  c.lwo = to_local(c, wo);
  c.wo_ok = side_ok(c, wo);
  c.alb_o = SPEC ? lut1(row + kMtLut, c.lwo.z) : 0.f;
  return c;
}

// FusedPrincipled.evaluate, reduced: f (includes |cos_i|) and pdf
template <bool SPEC, bool METAL>
__device__ __forceinline__ void bsdf_eval(const Closure& c, V3 li, V3& f, float& pdf) {
  const float* row = c.row;
  const float alpha = row[kMtAlpha];
  float B_r, pdf_r, fcos;
  ggx_refl_base1(alpha, c.lwo, li, B_r, pdf_r, fcos);
  const bool same = c.lwo.z * li.z > 0.f;
  const float cos_i = fabsf(li.z);
  float fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) fr[k] = same ? row[kMtRefl + k] * cos_i : 0.f;
  float p = same ? cos_i * kInvPi : 0.f;
  if (SPEC) {
    const float alb_i = lut1(row + kMtLut, li.z);
    float eo[3], ei[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      eo[k] = row[kMtSpecCol + k] * c.alb_o;
      ei[k] = row[kMtSpecCol + k] * alb_i;
    }
    const float p_s = (eo[0] + eo[1] + eo[2]) * kThird;
    const float frd = fr_dielectric1(fcos, row[kMtSpecEta]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      fr[k] = B_r * frd * row[kMtSpecCol + k] + fr[k] * tminimum(1.0f - eo[k], 1.0f - ei[k]);
    p = pdf_r * p_s + p * (1.0f - p_s);
  }
  if (METAL) {
    const float afc = fabsf(fcos);
    const float met = row[kMtMetal];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float fm = B_r * fr_complex1(afc, row[kMtN + k], row[kMtK + k]);
      fr[k] = fr[k] + (fm - fr[k]) * met;
    }
    p = p + (pdf_r - p) * met;
  }
  f = {fr[0], fr[1], fr[2]};
  pdf = p;
}

// SurfaceClosure.evaluate (svm/reduced.py::_Closure.evaluate): f and pdf
// at the world direction wi, zeros where the leak check fails
template <bool SPEC, bool METAL>
__device__ __forceinline__ void reduced_eval(const Closure& c, V3 wi, V3& f, float& pdf) {
  bsdf_eval<SPEC, METAL>(c, to_local(c, wi), f, pdf);
  const bool ok = c.wo_ok && side_ok(c, wi);
  f = ok ? f : V3{0.f, 0.f, 0.f};
  pdf = ok ? pdf : 0.f;
}

// One bounce's shade (svm/reduced.py::reduced_shade): NEE evaluate with the
// MIS weight, sample_wi with evaluate, (ALBEDO) the directional albedo and
// (ROUGH) the roughness of the lobe the sample picked (the table's, else
// 1: the diffuse lobe).
template <bool SPEC, bool METAL, bool ALBEDO, bool ROUGH = false>
__device__ __forceinline__ ShadeOut reduced_shade(const float* row, V3 t, V3 b, V3 n, V3 ng,
                                                  V3 wo, V3 ls_wi, V3 ls_li, float ls_pdf,
                                                  float u_sel, float u0, float u1) {
  const Closure c = make_closure<SPEC>(row, t, b, n, ng, wo);
  const float met = row[kMtMetal];
  ShadeOut out;

  // NEE
  V3 el;
  float pdf_l;
  bsdf_eval<SPEC, METAL>(c, to_local(c, ls_wi), el, pdf_l);
  const bool ok_nee = c.wo_ok && side_ok(c, ls_wi);
  pdf_l = ok_nee ? pdf_l : 0.f;
  const float w_nee = ls_pdf / cmax(ls_pdf + pdf_l, 1e-30f);
  const float scale = w_nee / cmax(ls_pdf, 1e-20f);
  out.direct = {ls_li.x * (ok_nee ? el.x : 0.f) * scale, ls_li.y * (ok_nee ? el.y : 0.f) * scale,
                ls_li.z * (ok_nee ? el.z : 0.f) * scale};

  // sample_wi cascade
  bool pick_metal = false;
  if (METAL) {
    pick_metal = u_sel < met;
    u_sel = clampf(pick_metal ? u_sel / cmax(met, 1e-20f) : (u_sel - met) / cmax(1.0f - met, 1e-20f),
                   0.f, 1.f);
  }
  bool pick_spec = false;
  if (SPEC) {
    pick_spec = u_sel < (row[kMtSpecCol] + row[kMtSpecCol + 1] + row[kMtSpecCol + 2]) * kThird *
                            c.alb_o;
  }
  const bool use_refl = pick_metal || pick_spec;
  const V3 lwo = c.lwo;
  const V3 wh = ggx_sample_wh1(row[kMtAlpha], lwo, u0, u1);
  const float dwh = dot3(lwo, wh);
  const V3 r = {-lwo.x + 2.0f * dwh * wh.x, -lwo.y + 2.0f * dwh * wh.y, -lwo.z + 2.0f * dwh * wh.z};
  const float rdisk = sqrtf(cmax(u0, 0.f));
  const float phi = u1 * kTwoPi;
  float sx = rdisk * cosf(phi);
  float sy = rdisk * sinf(phi);
  float sz = sqrtf(cmax(1.0f - sx * sx - sy * sy, 0.f));
  const float flip_wi = lwo.z * sz > 0.f ? 1.f : -1.f;
  sx = sx * flip_wi;
  sy = sy * flip_wi;
  sz = sz * flip_wi;
  const V3 li = use_refl ? r : V3{sx, sy, sz};
  const bool valid_s = !use_refl || lwo.z * r.z > 0.f;
  out.wi = {li.x * t.x + li.y * b.x + li.z * n.x, li.x * t.y + li.y * b.y + li.z * n.y,
            li.x * t.z + li.y * b.z + li.z * n.z};
  V3 es;
  float pdf_s;
  bsdf_eval<SPEC, METAL>(c, li, es, pdf_s);
  const bool ok_s = c.wo_ok && side_ok(c, out.wi);
  pdf_s = ok_s ? pdf_s : 0.f;
  out.f = ok_s ? es : V3{0.f, 0.f, 0.f};
  out.pdf = pdf_s;
  out.valid = valid_s && ok_s && pdf_s > 0.f;

  if (ALBEDO) {
    float al[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float base = row[kMtRefl + k] * kPi;
      if (SPEC) {
        const float s = row[kMtSpecCol + k];
        al[k] = s * (s * c.alb_o) + base * (1.0f - s * c.alb_o);
      } else {
        al[k] = base;
      }
      if (METAL) al[k] = al[k] + (1.0f - al[k]) * met;
    }
    out.albedo = {al[0], al[1], al[2]};
  }
  if (ROUGH) out.roughness = use_refl ? row[kMtRough] : 1.0f;
  return out;
}

}  // namespace akr
