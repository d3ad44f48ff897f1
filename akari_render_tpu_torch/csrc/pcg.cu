// pcg32_draws: d PCG32 (XSH-RR 64/32) draws a lane over a batch of
// streams, each a float32 uniform in [0, 1) with 24 bits, bit for bit
// core/pcg.py's pcg32_next_f32 repeated d times (core/pcg.py::pcg32_draws).
//
// Replaces no Pallas kernel: the JAX package writes PCG32 as int64 array
// arithmetic that XLA fuses inside the jitted step. The port runs eagerly,
// where one draw of the plain version is 16 elementwise launches; a call of
// this kernel is one launch for all d draws of every lane.
//
// Bound: bytes. N * d * 4 B of u out, 24 B a lane of state and inc in and
// state out: 17.5 MB (5.2 us at 3.35 TB/s) at 65,536 lanes x 61 draws,
// 35.1 MB (10.5 us) at the bootstrap's 131,072 x 61. The arithmetic, one
// 64-bit multiply-add and ~10 integer operations a draw, is serial in d
// along a lane's stream and independent across lanes.
//
// Design: one thread a lane keeps its stream in registers across the d
// draws. A block's rows of u are one contiguous span of the output (128
// lanes x 61 x 4 B = 31 KB): each thread writes its draws into shared
// memory, row by row, and the block then stores the span with consecutive
// threads on consecutive words, not each thread its own row at a 4d-byte
// stride. The shared rows are padded to an odd pitch, so a warp's 32 row
// writes fall in 32 banks. More than kCols draws go in chunks of kCols
// columns, each chunk's rows stored the same way. Nothing is updated in
// place: the state goes out to its own array (older states stay in use).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kLanes = 128;  // threads (lanes) a block
constexpr int kCols = 64;    // draws staged in shared memory at once
constexpr uint64_t kMult = 6364136223846793005ULL;

// shared memory of a launch with d draws: kLanes rows at an odd pitch
size_t smem_bytes(int d) {
  const int cols = d < kCols ? d : kCols;
  return size_t(kLanes) * size_t(cols | 1) * sizeof(float);
}

__global__ void __launch_bounds__(kLanes)
    pcg32_draws_kernel(const uint64_t* __restrict__ state, const uint64_t* __restrict__ inc,
                       uint64_t* __restrict__ state_out, float* __restrict__ u, int64_t n, int d) {
  extern __shared__ float tile[];  // [kLanes][pitch]
  const int64_t row0 = int64_t(blockIdx.x) * kLanes;
  const int64_t lane = row0 + threadIdx.x;
  const int rows = int(n - row0 < kLanes ? n - row0 : kLanes);
  uint64_t s = 0, c = 0;
  if (lane < n) {
    s = state[lane];
    c = inc[lane];
  }
  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int cols = d - c0 < kCols ? d - c0 : kCols;
    const int pitch = cols | 1;
    if (lane < n) {
      for (int j = 0; j < cols; ++j) {
        const uint64_t old = s;
        s = old * kMult + c;
        const uint32_t xs = uint32_t(((old >> 18) ^ old) >> 27);
        const uint32_t rot = uint32_t(old >> 59);
        const uint32_t bits = (xs >> rot) | (xs << ((32u - rot) & 31u));
        tile[threadIdx.x * pitch + j] = float(bits >> 8) * (1.0f / 16777216.0f);
      }
    }
    __syncthreads();
    // the chunk's rows; one contiguous span of u when the chunk is the row
    for (int i = threadIdx.x; i < rows * cols; i += kLanes) {
      const int r = i / cols, k = i - r * cols;
      u[(row0 + r) * d + c0 + k] = tile[r * pitch + k];
    }
    __syncthreads();
  }
  if (lane < n) state_out[lane] = s;
}

}  // namespace

// state, inc [n] (uint64 bits; inc odd) -> state_out [n] (the state after
// d steps), u [n, d] row-major float32. All device pointers; state_out
// must not alias state. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int akr_pcg32_draws(const uint64_t* state, const uint64_t* inc, uint64_t* state_out,
                               float* u, int64_t n, int d, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const unsigned grid = unsigned((n + kLanes - 1) / kLanes);
  pcg32_draws_kernel<<<grid, kLanes, smem_bytes(d), static_cast<cudaStream_t>(stream)>>>(
      state, inc, state_out, u, n, d);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources at d draws a call: out is a host array [6]
// (akr::kernel_info's layout).
extern "C" int akr_pcg32_draws_kernel_info(int32_t* out, int d) {
  return static_cast<int>(akr::kernel_info(pcg32_draws_kernel, kLanes, smem_bytes(d), out));
}
