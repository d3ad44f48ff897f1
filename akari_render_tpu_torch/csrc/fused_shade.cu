// K9, the fused shade, for Hopper (sm_90a).
//
// Replaces akari_render_tpu/integrators/pallas_shade.py::_kernel (via
// _run): one bounce's whole shade for the reduced principled closure, per
// lane: the closure evaluated at the NEE direction with the MIS weight, a
// sampled direction with the closure evaluated there, and the directional
// albedo (reduced_closure.cuh; the plain version is
// integrators/fused_shade.py::fused_shade_torch).
//
// Bound: bytes. Each lane reads 26 values (frame t/b/n, ng, wo, the light
// direction and radiance as [N, 3] rows, the light pdf, three uniforms and
// an int32 material id: 104 B) and writes 13 floats and a bool (53 B), for
// a few hundred FP32 operations: far below the card's 67 TFLOP/s at
// 3.35 TB/s. Design: one thread per lane reads its inputs where the bounce
// loop left them (no staging copy into a row-stacked array, which would
// move more bytes than the kernel itself), the [M, 32] material table sits
// in shared memory, and has_spec / has_metal are template parameters, so a
// scene without a specular layer or metal compiles those lobes out.

#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include "reduced_closure.cuh"

namespace {

using akr::V3;

__device__ __forceinline__ V3 ld3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void st3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

template <bool SPEC, bool METAL>
__global__ void fused_shade_kernel(const float* __restrict__ tab, int M,
                                   const float* __restrict__ t, const float* __restrict__ b,
                                   const float* __restrict__ n, const float* __restrict__ ng,
                                   const float* __restrict__ wo, const float* __restrict__ ls_wi,
                                   const float* __restrict__ ls_li,
                                   const float* __restrict__ ls_pdf,
                                   const float* __restrict__ u_bsdf,
                                   const int32_t* __restrict__ mat, float* __restrict__ direct,
                                   float* __restrict__ wi, float* __restrict__ f,
                                   float* __restrict__ pdf, bool* __restrict__ valid,
                                   float* __restrict__ albedo, int N) {
  extern __shared__ float s_tab[];
  for (int i = threadIdx.x; i < M * akr::kMatCols; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float* row = s_tab + int64_t(mat[i]) * akr::kMatCols;
  const float* u = u_bsdf + 3 * i;
  const akr::ShadeOut o = akr::reduced_shade<SPEC, METAL, true>(
      row, ld3(t, i), ld3(b, i), ld3(n, i), ld3(ng, i), ld3(wo, i), ld3(ls_wi, i), ld3(ls_li, i),
      ls_pdf[i], u[0], u[1], u[2]);
  st3(direct, i, o.direct);
  st3(wi, i, o.wi);
  st3(f, i, o.f);
  pdf[i] = o.pdf;
  valid[i] = o.valid;
  st3(albedo, i, o.albedo);
}

constexpr int kThreads = 256;

template <bool SPEC, bool METAL>
int launch(const float* tab, int M, const float* const* in, const int32_t* mat, float* direct,
           float* wi, float* f, float* pdf, bool* valid, float* albedo, int N,
           cudaStream_t stream) {
  const size_t smem = size_t(M) * akr::kMatCols * sizeof(float);
  auto kernel = fused_shade_kernel<SPEC, METAL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = unsigned((int64_t(N) + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, stream>>>(tab, M, in[0], in[1], in[2], in[3], in[4], in[5],
                                            in[6], in[7], in[8], mat, direct, wi, f, pdf, valid,
                                            albedo, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab [M, 32]; t, b, n, ng, wo, ls_wi, ls_li [N, 3]; ls_pdf [N]; u_bsdf
// [N, 3]; mat [N] int32 -> direct, wi, f [N, 3], pdf [N], valid [N] bool,
// albedo [N, 3]. All device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int akr_fused_shade(const float* tab, int M, int has_spec, int has_metal,
                               const float* t, const float* b, const float* n, const float* ng,
                               const float* wo, const float* ls_wi, const float* ls_li,
                               const float* ls_pdf, const float* u_bsdf, const int32_t* mat,
                               float* direct, float* wi, float* f, float* pdf, bool* valid,
                               float* albedo, int N, void* stream) {
  if (N <= 0) return 0;
  const float* in[9] = {t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_spec && has_metal)
    return launch<true, true>(tab, M, in, mat, direct, wi, f, pdf, valid, albedo, N, s);
  if (has_spec)
    return launch<true, false>(tab, M, in, mat, direct, wi, f, pdf, valid, albedo, N, s);
  if (has_metal)
    return launch<false, true>(tab, M, in, mat, direct, wi, f, pdf, valid, albedo, N, s);
  return launch<false, false>(tab, M, in, mat, direct, wi, f, pdf, valid, albedo, N, s);
}

// K9's resources at M materials (its shared memory) and its lobes: out is
// a host array [6] (akr::kernel_info's layout).
extern "C" int akr_fused_shade_kernel_info(int32_t* out, int M, int has_spec, int has_metal) {
  const size_t smem = size_t(M) * akr::kMatCols * sizeof(float);
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
