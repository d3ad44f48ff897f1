// What the compiler gave a kernel and how many of its blocks an SM keeps
// resident: the kernel-info entry points of every kernel library
// (read by accel/nvcc.py::read_kernel_info).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace akr {

// One kernel's resources into the host array out[6]: registers a thread,
// static and dynamic shared memory and local memory in bytes, threads a
// block, and the blocks of that shape an SM keeps resident. A dynamic
// shared memory above 48 KB is first allowed, as the launch allows it.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t dyn_smem, int32_t* out) {
  cudaError_t err = cudaSuccess;
  if (dyn_smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dyn_smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, dyn_smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int32_t(attr.sharedSizeBytes);
  out[2] = int32_t(dyn_smem);
  out[3] = int32_t(attr.localSizeBytes);
  out[4] = threads;
  out[5] = resident;
  return cudaSuccess;
}

}  // namespace akr
