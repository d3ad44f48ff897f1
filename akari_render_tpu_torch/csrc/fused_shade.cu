// K9, the fused shade, for Hopper (sm_90a).
//
// Replaces akari_render_tpu/integrators/pallas_shade.py::_kernel (via
// _run): one bounce's whole shade for the reduced principled closure, per
// lane: the closure evaluated at the NEE direction with the MIS weight, a
// sampled direction with the closure evaluated there, and the directional
// albedo (reduced_closure.cuh; the plain version is
// integrators/fused_shade.py::fused_shade_torch).
//
// Bound: bytes. A live lane reads 26 values (frame t/b/n, ng, wo, the
// light direction and radiance as [N, 3] rows, the light pdf, three
// uniforms and a material id: 104 B) and writes 13 floats and a bool
// (53 B); a dead lane writes its 53 B of zeros; each lane's live flag is
// 1 B. The closure is ~690 FP32 operations a live lane (chip_smoke.py's
// K9_LIVE_FLOPS), under the bytes at the card's 67 TFLOP/s : 3.35 TB/s.
// A bounce's wavefront is 2^16 lanes, 2,048 warps, all resident at once,
// so a launch costs its own latency and one pass over those bytes. What the
// design does:
// 1. One masked launch over the whole wavefront. The bounce loop hands
//    the kernel its rows as they lie, with the live mask: no compaction,
//    no gathers and no scatters around the kernel (the TPU kernel, too,
//    ran over every lane). A warp with no live lane only writes its zeros.
//    Each [N, 3] input is read where it lies, with its row stride (the
//    flat tier's ng is a strided view of the attribute rows): the wrapper
//    copies nothing.
// 2. One thread a lane in blocks of kThreads, several an SM; the [M, 32]
//    material table read through the read-only cache, with no per-block
//    copy or barrier.
// Measured and dropped (PERF.md §6): staging each warp's [32, 3] spans
// through shared memory with 16-byte loads and stores (slower: it adds a
// round trip before the closure and after it), the table in shared
// memory, blocks of 64 or 256 lanes (no faster), 8 resident blocks by
// __launch_bounds__ (64 registers, but it spills: slower), and two warps a
// group of 32 lanes, one for the NEE part of the closure and one for the
// sample part (no faster: the chain through one lane's closure is not what
// sets the time).
// The arithmetic is reduced_closure.cuh's, op for op (-fmad=false), as in
// K8; has_spec / has_metal are template parameters, so a scene without a
// specular layer or metal compiles those lobes out.
//
// Two more entries serve GPT's reconnection shift
// (integrators/gpt_reconnect.py), each one masked launch over the
// wavefront's rows as they lie, as K9's design 1 (no compaction, no
// gathers, no host read; zeros on the dead lanes), with the plain versions
// fused_shade_torch(roughness=True) and fused_eval_torch:
// - K9r, a bounce's shade with roughness (fused_shade_rough_kernel): K9's
//   closure, and in place of the albedo the roughness of the lobe that the
//   sample's pick chose (the table's column kMtRough, else 1), which the
//   shift's eligibility test reads. Bound: bytes. A live lane reads K9's
//   104 B and writes 12 floats and a bool (49 B); a dead lane writes its
//   49 B of zeros; a flag a lane.
// - K9e, the closure evaluated at given directions (fused_eval_kernel<.., D>):
//   at a connection the shifted vertex's f and pdf toward V (D = 1), and
//   V's at the light's and the base path's directions (D = 2), one launch
//   each: the two read different surfaces and different lanes (V's only
//   where the base path recorded a vertex), and a launch of one generic
//   kernel a surface keeps each lane's inputs to one frame and one
//   material. Bound: bytes. A live lane reads the frame, ng and wo (60 B),
//   D directions (12 B each) and a material id (4 B), and writes D x 16 B;
//   a dead lane writes its D x 16 B of zeros; a flag a lane. The closure is
//   ~240 FP32 operations a direction (chip_smoke.py's K9E_DIR_FLOPS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "reduced_closure.cuh"

namespace {

using akr::V3;

constexpr int kThreads = 128;  // lanes a block
constexpr int kIn3 = 8;   // t, b, n, ng, wo, ls_wi, ls_li, u_bsdf
constexpr int kOut3 = 4;  // direct, wi, f, albedo

struct Args {
  const float* tab;
  const float* in3[kIn3];  // [N, 3] rows, row stride in3_stride floats, inner stride 1
  int64_t in3_stride[kIn3];
  const float* ls_pdf;
  const int32_t* mat;  // [N]
  const bool* live;  // [N], or null: every lane
  float* out3[kOut3];  // [N, 3] contiguous
  float* pdf;
  bool* valid;
  int N;
};

template <class A>
__device__ __forceinline__ V3 ld3(const A& a, int q, int64_t i) {
  const float* p = a.in3[q] + i * a.in3_stride[q];
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ void st3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

template <bool SPEC, bool METAL>
__global__ void __launch_bounds__(kThreads) fused_shade_kernel(const Args a) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.N) return;
  akr::ShadeOut o{};
  if (a.live == nullptr || a.live[i]) {
    const int64_t m = a.mat[i];
    const V3 u = ld3(a, 7, i);
    o = akr::reduced_shade<SPEC, METAL, true>(a.tab + m * akr::kMatCols, ld3(a, 0, i),
                                              ld3(a, 1, i), ld3(a, 2, i), ld3(a, 3, i),
                                              ld3(a, 4, i), ld3(a, 5, i), ld3(a, 6, i),
                                              __ldg(a.ls_pdf + i), u.x, u.y, u.z);
  }
  st3(a.out3[0], i, o.direct);
  st3(a.out3[1], i, o.wi);
  st3(a.out3[2], i, o.f);
  st3(a.out3[3], i, o.albedo);
  a.pdf[i] = o.pdf;
  a.valid[i] = o.valid;
}

struct RoughArgs {
  const float* tab;
  const float* in3[kIn3];  // as Args
  int64_t in3_stride[kIn3];
  const float* ls_pdf;
  const int32_t* mat;
  const bool* live;
  float* out3[3];  // direct, wi, f: [N, 3] contiguous
  float* pdf;
  bool* valid;
  float* roughness;
  int N;
};

template <bool SPEC, bool METAL>
__global__ void __launch_bounds__(kThreads) fused_shade_rough_kernel(const RoughArgs a) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.N) return;
  akr::ShadeOut o{};
  if (a.live == nullptr || a.live[i]) {
    const int64_t m = a.mat[i];
    const V3 u = ld3(a, 7, i);
    o = akr::reduced_shade<SPEC, METAL, false, true>(
        a.tab + m * akr::kMatCols, ld3(a, 0, i), ld3(a, 1, i), ld3(a, 2, i), ld3(a, 3, i),
        ld3(a, 4, i), ld3(a, 5, i), ld3(a, 6, i), __ldg(a.ls_pdf + i), u.x, u.y, u.z);
  }
  st3(a.out3[0], i, o.direct);
  st3(a.out3[1], i, o.wi);
  st3(a.out3[2], i, o.f);
  a.pdf[i] = o.pdf;
  a.valid[i] = o.valid;
  a.roughness[i] = o.roughness;
}

constexpr int kMaxDirs = 2;

struct EvalArgs {
  const float* tab;
  const float* in3[5 + kMaxDirs];  // t, b, n, ng, wo, then the D directions
  int64_t in3_stride[5 + kMaxDirs];
  const int32_t* mat;
  const bool* live;
  float* f[kMaxDirs];  // [N, 3] contiguous
  float* pdf[kMaxDirs];
  int N;
};

template <bool SPEC, bool METAL, int D>
__global__ void __launch_bounds__(kThreads) fused_eval_kernel(const EvalArgs a) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.N) return;
  V3 f[D];
  float pdf[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    f[d] = {0.f, 0.f, 0.f};
    pdf[d] = 0.f;
  }
  if (a.live == nullptr || a.live[i]) {
    const int64_t m = a.mat[i];
    const akr::Closure c = akr::make_closure<SPEC>(a.tab + m * akr::kMatCols, ld3(a, 0, i),
                                                   ld3(a, 1, i), ld3(a, 2, i), ld3(a, 3, i),
                                                   ld3(a, 4, i));
#pragma unroll
    for (int d = 0; d < D; ++d) akr::reduced_eval<SPEC, METAL>(c, ld3(a, 5 + d, i), f[d], pdf[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    st3(a.f[d], i, f[d]);
    a.pdf[d][i] = pdf[d];
  }
}

template <class A, class K>
int launch_on(K kernel, const A& a, cudaStream_t stream) {
  const unsigned grid = unsigned((int64_t(a.N) + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPEC, bool METAL>
int launch_eval(const EvalArgs& a, int dirs, cudaStream_t s) {
  return dirs == 1 ? launch_on(fused_eval_kernel<SPEC, METAL, 1>, a, s)
                   : launch_on(fused_eval_kernel<SPEC, METAL, 2>, a, s);
}

}  // namespace

// tab [M, 32]; in3: t, b, n, ng, wo, ls_wi, ls_li, u_bsdf, each [N, 3]
// with row stride in3_stride[q] floats (>= 3, inner stride 1); ls_pdf
// [N]; mat [N] int32; live [N] bool or null (every
// lane live) -> direct, wi, f, albedo [N, 3], pdf [N], valid [N] bool,
// zeros on the lanes that are not live. All device pointers; launches on
// `stream` and returns cudaGetLastError().
extern "C" int akr_fused_shade(const float* tab, int M, int has_spec, int has_metal,
                               const float* const* in3, const int64_t* in3_stride,
                               const float* ls_pdf, const int32_t* mat, const bool* live,
                               float* const* out3, float* pdf, bool* valid, int N, void* stream) {
  if (N <= 0) return 0;
  Args a;
  a.tab = tab;
  for (int q = 0; q < kIn3; ++q) {
    a.in3[q] = in3[q];
    a.in3_stride[q] = in3_stride[q];
  }
  a.ls_pdf = ls_pdf;
  a.mat = mat;
  a.live = live;
  for (int q = 0; q < kOut3; ++q) a.out3[q] = out3[q];
  a.pdf = pdf;
  a.valid = valid;
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_spec && has_metal) return launch_on(fused_shade_kernel<true, true>, a, s);
  if (has_spec) return launch_on(fused_shade_kernel<true, false>, a, s);
  if (has_metal) return launch_on(fused_shade_kernel<false, true>, a, s);
  return launch_on(fused_shade_kernel<false, false>, a, s);
}

// K9's resources for its lobes: out is a host array [6] (akr::kernel_info's
// layout; M, the table's rows, sets no shared memory).
extern "C" int akr_fused_shade_kernel_info(int32_t* out, int M, int has_spec, int has_metal) {
  const size_t smem = 0;
  cudaError_t err;
  if (has_spec && has_metal)
    err = akr::kernel_info(fused_shade_kernel<true, true>, kThreads, smem, out);
  else if (has_spec)
    err = akr::kernel_info(fused_shade_kernel<true, false>, kThreads, smem, out);
  else if (has_metal)
    err = akr::kernel_info(fused_shade_kernel<false, true>, kThreads, smem, out);
  else
    err = akr::kernel_info(fused_shade_kernel<false, false>, kThreads, smem, out);
  return static_cast<int>(err);
}

// K9r: akr_fused_shade's arguments, with out3 = direct, wi, f [N, 3] and the
// roughness [N] in place of the albedo.
extern "C" int akr_fused_shade_rough(const float* tab, int M, int has_spec, int has_metal,
                                     const float* const* in3, const int64_t* in3_stride,
                                     const float* ls_pdf, const int32_t* mat, const bool* live,
                                     float* const* out3, float* pdf, bool* valid,
                                     float* roughness, int N, void* stream) {
  if (N <= 0) return 0;
  RoughArgs a;
  a.tab = tab;
  for (int q = 0; q < kIn3; ++q) {
    a.in3[q] = in3[q];
    a.in3_stride[q] = in3_stride[q];
  }
  a.ls_pdf = ls_pdf;
  a.mat = mat;
  a.live = live;
  for (int q = 0; q < 3; ++q) a.out3[q] = out3[q];
  a.pdf = pdf;
  a.valid = valid;
  a.roughness = roughness;
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_spec && has_metal) return launch_on(fused_shade_rough_kernel<true, true>, a, s);
  if (has_spec) return launch_on(fused_shade_rough_kernel<true, false>, a, s);
  if (has_metal) return launch_on(fused_shade_rough_kernel<false, true>, a, s);
  return launch_on(fused_shade_rough_kernel<false, false>, a, s);
}

// K9e: tab [M, 32]; in3: t, b, n, ng, wo and `dirs` (1 or 2) directions wi,
// each [N, 3] with row stride in3_stride[q] floats (>= 3, inner stride 1);
// mat [N] int32; live [N] bool or null -> f[d] [N, 3] and pdf[d] [N] for
// each direction, zeros on the lanes that are not live. All device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int akr_fused_eval(const float* tab, int M, int has_spec, int has_metal,
                              const float* const* in3, const int64_t* in3_stride,
                              const int32_t* mat, const bool* live, float* const* f,
                              float* const* pdf, int dirs, int N, void* stream) {
  if (N <= 0) return 0;
  if (dirs < 1 || dirs > kMaxDirs) return static_cast<int>(cudaErrorInvalidValue);
  EvalArgs a{};
  a.tab = tab;
  for (int q = 0; q < 5 + dirs; ++q) {
    a.in3[q] = in3[q];
    a.in3_stride[q] = in3_stride[q];
  }
  a.mat = mat;
  a.live = live;
  for (int d = 0; d < dirs; ++d) {
    a.f[d] = f[d];
    a.pdf[d] = pdf[d];
  }
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_spec && has_metal) return launch_eval<true, true>(a, dirs, s);
  if (has_spec) return launch_eval<true, false>(a, dirs, s);
  if (has_metal) return launch_eval<false, true>(a, dirs, s);
  return launch_eval<false, false>(a, dirs, s);
}

// K9r's resources for its lobes (akr_fused_shade_kernel_info's layout).
extern "C" int akr_fused_shade_rough_kernel_info(int32_t* out, int M, int has_spec,
                                                 int has_metal) {
  cudaError_t err;
  if (has_spec && has_metal)
    err = akr::kernel_info(fused_shade_rough_kernel<true, true>, kThreads, 0, out);
  else if (has_spec)
    err = akr::kernel_info(fused_shade_rough_kernel<true, false>, kThreads, 0, out);
  else if (has_metal)
    err = akr::kernel_info(fused_shade_rough_kernel<false, true>, kThreads, 0, out);
  else
    err = akr::kernel_info(fused_shade_rough_kernel<false, false>, kThreads, 0, out);
  return static_cast<int>(err);
}

// K9e's resources for its lobes at `dirs` directions (1 or 2).
extern "C" int akr_fused_eval_kernel_info(int32_t* out, int dirs, int has_spec, int has_metal) {
  cudaError_t err;
#define AKR_EVAL_INFO(S, MT)                                                           \
  err = dirs == 1 ? akr::kernel_info(fused_eval_kernel<S, MT, 1>, kThreads, 0, out) \
                  : akr::kernel_info(fused_eval_kernel<S, MT, 2>, kThreads, 0, out)
  if (has_spec && has_metal)
    AKR_EVAL_INFO(true, true);
  else if (has_spec)
    AKR_EVAL_INFO(true, false);
  else if (has_metal)
    AKR_EVAL_INFO(false, true);
  else
    AKR_EVAL_INFO(false, false);
#undef AKR_EVAL_INFO
  return static_cast<int>(err);
}
