// K1, the flat tier's brute-force Möller-Trumbore, for Hopper (sm_90a).
//
// Replaces the TPU kernel akari_render_tpu/accel/pallas_intersect.py::_kernel
// (K1): every ray against every triangle, closest hit or any hit, with three
// per-ray excluded triangle ids.
//
// Semantics (held against the plain torch version, accel/trace.py):
//   - a ray is live when tmax > tmin; its best t starts at min(tmax,
//     RAY_TMAX); a hit needs t > tmin and t < best t (strict), so with
//     ascending triangle ids the first triangle wins ties;
//   - |det| > 1e-12, u >= 0, v >= 0, u + v <= 1;
//   - exclusion ids are int32, -1 for none (a null pointer means all -1);
//   - a miss returns t = RAY_TMAX, id -1, u = v = 0;
//   - any hit: only the flag is written.
//
// What bounds it on this card. Run in full, each ray tests each triangle:
// ~75 issued instructions a test (46 FP32 operations under -fmad=false, an
// IEEE division, the compares, the loads), 1.2e9 tests at 2^18 rays x 4,620
// triangles, so instruction issue alone took ~3 of the 4.15 ms of the
// earlier one-thread-a-ray kernel. The lever left is the tests that cannot
// hit. So the soup is cut into tiles of consecutive ids
// (accel/intersect.py::flat_tiles: at most kTile triangles, each tile with
// its world box and sliver flag) and the tiles go through the cluster tier's
// candidate test (candidate_test.cuh) with the identity transform: 512-lane
// blocks, each lane box-testing the tile, the lanes that pass queued and
// their slots shared out over the block's warps, and a tile that holds
// hittable sliver triangles testing those for every lane that can still be
// hit. On matbox's rays about one live (lane, tile) pair in twenty passes
// (tools/cull_shares.py, PERF.md). Tiles go in ascending id order; within a tile the fold is (t,
// slot), slots in id order, and across tiles a strict `<`: K1's rule, least
// t and the first id among equals.
//
// The box test's limit is the lane's best t widened by kBoxTRel of itself.
// When a ray nearly grazes a triangle's plane, Möller-Trumbore's t, u and v
// are the true ones divided by (1 + delta), delta the relative rounding of
// the determinant (the numerators are well conditioned), so a hit reported
// at t < best can lie at (1 + delta) t beyond it: behind a neighbour in an
// earlier tile whose hit set best, and past the box's entry. Against the
// best t alone a ray within ~1e-5 rad of a sphere's surface, crossing a
// tile border, lost such a hit (tests/test_torch_flat_cull.py's aimed rays);
// the widened limit covers |delta| up to a quarter and costs ~1/8 more box
// passes (4.4 -> 5.0 % of live (lane, tile) pairs).
//
// A tile's staged slots are its triangles rounded up to 32, so a short
// tile (blinds' 28 triangles, a sliver run) spends one unit of work a
// queued lane, not four. flat_tiles gives each sliver run (slivers at most
// two ids apart) tiles of its own, so the lanes queued for slivers alone
// walk those runs and not the triangles around them.
//
// The rays are read in the caller's order: a block's lanes are consecutive
// rays. Sorting them (the pair sweep's Morton order) would leave each
// lane's box tests as they are and only let more blocks skip a tile outright
// (87 -> 53 % of (block, tile) pairs with a passing lane on matbox's rays,
// tools/cull_shares.py), not worth a sort and an unsort. Tiles ride a two-buffer cp.async ring as
// K4's candidates do, one barrier a tile, which also ends the block's walk
// once none of its lanes can be hit (any hit: a lane retires at its first
// hit, as the per-lane any-hit flag of the pair sweep does).
//
// Build with -fmad=false: every product and sum then rounds on its own, as
// torch's elementwise ops do, so ids, t, u, v and hit flags match the plain
// version exactly. The identity transform of the candidate test changes
// no value but the sign of a zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_test.cuh"

namespace {

constexpr float kRayTmax = 1e20f;
constexpr int kTile = 128;  // triangles a tile holds at most (accel/intersect.py TILE)
constexpr float kBoxTRel = 0.25f;  // the box test's limit: best t + kBoxTRel |best t| (BOX_T_REL)

template <bool kStats>
__global__ void __launch_bounds__(akr::kMaxLanes, 2)
flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
            const int32_t* __restrict__ ex0_in, const int32_t* __restrict__ ex1_in,
            const int32_t* __restrict__ ex2_in, const float* __restrict__ tri,
            const float* __restrict__ boxes, const int32_t* __restrict__ slots, int ntiles,
            int n, int any_hit, float* __restrict__ out_t, int32_t* __restrict__ out_id,
            float* __restrict__ out_u, float* __restrict__ out_v, uint8_t* __restrict__ out_occ,
            int32_t* __restrict__ walked, int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int sf = akr::stage_floats(kTile);  // two stage buffers, then the test's scratch
  const akr::CullScratch scratch = akr::cull_scratch(smem + 2 * sf, blockDim.x);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n < 2^31 (the wrapper checks)
  akr::LaneRay r = {};
  akr::LaneBest b = {-akr::kInf, -1.f, 0.f, 0.f};
  if (i < n) {
    const int64_t i3 = 3 * int64_t(i);
    r.wox = o[i3]; r.woy = o[i3 + 1]; r.woz = o[i3 + 2];
    r.wdx = d[i3]; r.wdy = d[i3 + 1]; r.wdz = d[i3 + 2];
    r.tmin = tmin_in[i];
    const float tmax = tmax_in[i];
    r.tlim = tmax > r.tmin ? fminf(tmax, kRayTmax) : -akr::kInf;
    r.ex0 = ex0_in ? float(ex0_in[i]) : -1.f;
    r.ex1 = ex1_in ? float(ex1_in[i]) : -1.f;
    r.ex2 = ex2_in ? float(ex2_in[i]) : -1.f;
    r.ivx = akr::slab_inverse(r.wdx); r.ivy = akr::slab_inverse(r.wdy);
    r.ivz = akr::slab_inverse(r.wdz);
    r.sh = any_hit;  // retire at the first hit
    b.t = r.tlim;
  }
  akr::CullStats st;
  if (threadIdx.x == 0) *scratch.count = 0;  // visible, as the next, after the first barrier

  // tile k: its slots[k] first slots in buffer k & 1, with the identity row
  int steps = 0;
  akr::stage_identity(smem, slots[0]);
  akr::stage_candidate(smem, tri, nullptr, boxes, ntiles, 0, 0, slots[0]);
  for (int k = 0; k < ntiles; ++k) {
    akr::stage_wait();
    // the barrier: tile k's copy is visible, every warp has left tile k - 1
    // (whose buffer the next copy overwrites), and the walk ends once no
    // lane of the block can be hit
    if (!__syncthreads_or(b.t > r.tmin)) break;
    if (k + 1 < ntiles) {
      float* next = smem + ((k + 1) & 1) * sf;
      akr::stage_identity(next, slots[k + 1]);
      akr::stage_candidate(next, tri + int64_t(k + 1) * kTile * 12, nullptr, boxes, ntiles, 0,
                           k + 1, slots[k + 1]);
    }
    ++steps;
    akr::candidate_test<kStats>(smem + (k & 1) * sf, slots[k], r, b,
                                b.t + kBoxTRel * fabsf(b.t), 0, scratch, st);
  }
  akr::stage_wait();  // a walk that ended early leaves no copy behind
  if (walked && threadIdx.x == 0) walked[blockIdx.x] = steps;
  if (kStats) akr::add_cull_stats(stats, blockIdx.x, st);
  if (i >= n) return;
  if (any_hit) {
    out_occ[i] = b.id >= 0.f ? 1 : 0;
  } else {
    const bool hit = b.id >= 0.f;
    out_t[i] = hit ? b.t : kRayTmax;
    out_id[i] = int32_t(b.id);
    out_u[i] = b.u;
    out_v[i] = b.v;
  }
}

size_t flat_smem(int lanes) {
  return (size_t(2) * akr::stage_floats(kTile) + akr::scratch_floats(lanes)) * sizeof(float);
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; each launches on `stream` and returns cudaGetLastError() (0 on
// success).
//
// K1: rays o / d [n, 3], tmin / tmax [n], ex0..ex2 [n] int32 (or null);
// tiles tri [ntiles, 128, 12] (v0 | e1 | e2 | id | 0 | 0, id -1 padding),
// boxes [7, ntiles] (world box, sliver flag), slots [ntiles] int32 (the
// staged slots of each tile: a multiple of 32, at most 128), ntiles >= 1.
// Closest hit writes out_t / out_id / out_u / out_v, any hit out_occ (one
// byte a ray). walked [ceil(n / 512)] int32 (or null) receives each block's
// tiles tested; stats [ceil(n / 512), 4] int32, zeroed (or null: the kernel
// without counters), the candidate test's counters (candidate_test.cuh).
// tri must be 16-byte aligned.
extern "C" int akr_intersect(const float* o, const float* d, const float* tmin,
                             const float* tmax, const int32_t* ex0, const int32_t* ex1,
                             const int32_t* ex2, const float* tri, const float* boxes,
                             const int32_t* slots, int ntiles, int n, int any_hit, float* out_t,
                             int32_t* out_id, float* out_u, float* out_v, uint8_t* out_occ,
                             int32_t* walked, int32_t* stats, void* stream) {
  if (n <= 0) return 0;
  if (ntiles <= 0 || !boxes || !slots) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = stats ? flat_kernel<true> : flat_kernel<false>;
  const int lanes = akr::kMaxLanes;
  const size_t smem = flat_smem(lanes);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = unsigned((int64_t(n) + lanes - 1) / lanes);
  kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, ex0, ex1, ex2, tri, boxes, slots, ntiles, n, any_hit, out_t, out_id, out_u,
      out_v, out_occ, walked, stats);
  return static_cast<int>(cudaGetLastError());
}

// K1's resources: out is a host array [6] (akr::kernel_info's layout); C
// and block_lanes must be the kernel's own (kTile, akr::kMaxLanes).
extern "C" int akr_intersect_kernel_info(int32_t* out, int C, int block_lanes) {
  if (C != kTile || block_lanes != akr::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      akr::kernel_info(flat_kernel<false>, block_lanes, flat_smem(block_lanes), out));
}
