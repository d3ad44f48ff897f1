"""On-card smoke run of the PyTorch/CUDA port (akari_render_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. environment: the card's name and power limit; CUDA must be present;
2. build: compile the K1 intersect kernel from csrc/ and time the build
   (in parallel with phase 6's build: one nvcc per source);
3. K1 parity: matbox's tiles against 2^18 rays (camera rays plus seeded
   random rays from inside the box, some with exclusion ids, and as many
   shadow segments), against rays aimed at the triangles that define every
   tile's box (down to 1e-6 rad from a triangle's plane) and through the
   sliver triangles (tests/torch_cull_rays.py), and blinds' 28 triangles
   against 2^18 rays: kernel against its plain torch version, closest and
   any hit, every id, t, u, v and flag bit-equal; its counters, the
   recounted bound and CUDA event timings; and the PCG32 sampler on the
   card against the CPU;
4. slice correctness: matbox 64x64, 16 spp, d12 through the port's CLI,
   held against the committed JAX images (testdata/matbox64_spp*.npy);
5. the flat-tier path at full width: matbox 512x512 through the CLI with
   scenes/matbox/pt.json, with K1's launches counted and each timed (CUDA
   events) beside its bound;
6. build: compile the pair-sweep kernels K2, K3 and K4 (csrc/pairs.cu);
7. K2/K3/K4 parity at classroom's shapes: the unified candidate list
   (4,633 clusters) against 2^18 rays (1080p camera rays, rays from
   interior points, shadow segments, dead and NaN lanes, exclusion ids),
   each kernel against its plain version, bit-equal (K2 equal, with the
   count of bit patterns that differ, which may only be zeros of the other
   sign, and its twin's cases; K3 with the walk order: e_init, kcnt and
   each walk's prefix), with counters and CUDA event timings (K2 by device
   time); K3 in one 1080p sample of the main path, every launch timed
   beside the PyTorch chain of its sort half (walk_order) and the first two
   held against the plain version, and every K2 launch of that sample held
   against its plain chain and timed by its device record with its bound;
   and the pair sweep against K1 over the fully flattened world soup, an
   independent check;
8. cluster-tier correctness: classroom 96x96, 16 spp, d12 through the CLI,
   held against the committed JAX image (testdata/classroom96_spp16.npy)
   and the committed 512-spp ground truth (BENCH_MSE_CLASSROOM.gt.exr);
9. the cluster-tier path at full width: classroom 1920x1080, 1 spp, d12
   through the CLI with scenes/classroom/pt.json, with K2/K3/K4's launches
   counted and every K3 and K4 launch timed;
10. build: the path megakernel K8 (csrc/megakernel.cu), the fused shade
   K9 (csrc/fused_shade.cu) and the PCG32 draws (csrc/pcg.cu), in the same
   parallel build as phases 2 and 6;
11. K9 parity: the first bounce of a path-B sample of blinds 256x256 (the
   main path's inputs): the masked kernel over the whole 65,536-lane
   wavefront against the masked plain version, and the unmasked kernel on
   its live lanes compacted; 2^18 lanes of seeded blinds shade inputs;
   each with the lanes bit-equal on every output, CUDA event timings and
   the profiler's device time; the bounce loop's shade call on that
   wavefront as exactly one device event (torch.profiler); and every K9
   launch of one path-B sample with its lanes, live lanes, device time and
   bound;
12. K8 parity: blinds 256x256, 16 spp, d12 (one pass of the main path),
   the kernel pass against its plain version, bit-equal per pixel and on
   the rays each traced, with the time of each, and its warps' SIMT efficiency with
   path regeneration and with the samples in lockstep (its counters, held
   against the plain version's count);
13. fused-tier correctness: blinds 64x64, 16 spp, d12 through the CLI with
   AKR_MEGAKERNEL=1 (path A) and with AKR_PALLAS_SHADE=1 (path B), each
   held against the committed JAX image of its tier
   (testdata/blinds64{_mk,}_spp16.npy) and the JAX 256-spp image;
14. the fused tiers at full width: blinds 256x256, d12 through the CLI
   three times, path B and path A with scenes/blinds/pt.json (64 spp;
   path B: K9 at most once per bounce and no lane through the per-kind
   dispatch; path A: K8 once per pass) and, as the baseline, the
   wavefront with the per-kind dispatch at one 16-spp pass, with every
   kernel's launches counted per path, and the device events of one sample
   of each (path B's printed) read from torch.profiler;
15. build: the wide-BVH walk K7 (csrc/wide.cu), in the same parallel build
   (K5, the window refine, is part of csrc/pairs.cu);
16. K7 and K5 parity on phase 7's classroom rays: the wide walk's kernel
   against its plain version (closest hit with exclusion ids and cut tmax
   against the plain rounds; any hit against the plain version at one leaf
   a round, which is the kernel step for step, with the nodes expanded and
   leaves tested of each block, on every fourth block by walk length, the
   longest among them, and against the static sweep's any hit on every ray),
   bit-equal; the wide walk and the windowed
   walk against the static pair sweep (valid and t bit-equal; ids equal
   except on exact t ties, counted); K5 on the first round's window of that
   windowed traversal and on every round of the first three windowed
   traversals of a classroom 1080p sample (camera rays, their shadow rays,
   the first bounce) against its plain version, bit-equal, with
   its counters; CUDA event timings (and the profiler's device time for
   K5) and bounds, K7's counters and its time split between node steps
   and leaves (clock cycles inside the kernel, and a walk with the leaf
   test off);
17. the other traversals' correctness: classroom 96x96, 16 spp, d12 through
   the CLI with AKR_WIDE=1 and with AKR_PAIRS_STATIC=0, each held to phase
   8's gates and against phase 8's image;
18. the other traversals at full width: classroom 1920x1080, 1 spp, d12
   through the CLI under each switch, with every kernel's launches counted,
   every K5 and K7 launch timed and the windowed walk's rounds, beside
   phase 9's default route;
19. sampler parity: make_sampler for pmj02bn, sobol, hash and independent
   on the card against the CPU, 2^20 lanes x 24 dimensions, bit-equal, at
   sample index 4,100 (pmj02's epoch 1) and at per-lane indices;
20. cbox correctness: the cbox fixture at 64x64, 16 spp, pmj02bn, d12
   through the CLI on the dispatch route and on path B (K9), each held to
   phase 4's gates against testdata/cbox64_spp{16,256}.npy, and the first
   hit's aux albedo from K9 against the dispatch route's;
21. cbox at full width: 1024x1024, scenes/cbox/pt.json's configuration
   (pmj02bn, d12) at 4 spp after a warm-up, on the card's default shade
   route (K9 on cbox, AKR_PALLAS_SHADE unset) and on the dispatch
   (AKR_PALLAS_SHADE=0), and with the independent sampler on K9:
   Mpaths/s, launches, K1's launches and mean time, peak device bytes a
   lane, and one sample's device launches and idle share
   (torch.profiler); on the first bounce of a sample (2^20 lanes), K9
   against its plain version (bit-equal lanes, device time and bound) and
   against the dispatch on the same inputs (valid, direct, albedo);
22. AOV: the aov method through the CLI, matbox 64x64, 2 spp, against the
   committed JAX set (testdata/matbox64_aov_spp2.npz), then cbox
   1024x1024 at 1 spp: seven finite images, the depth above 5 where a ray
   hit;
23. GPT correctness: cbox 64x64, 4 spp through the CLI with
   scenes/cbox/gpt.json (the reconnection shift, on the dispatch route),
   the reconstruction and the primal held to phase 4's gates against the
   committed JAX render (testdata/cbox64_gpt_spp4.npz) and
   testdata/cbox64_spp256.npy, the gradients correlated with JAX's; then
   the pss shift on the dispatch route and with AKR_PALLAS_SHADE=1 (K9),
   their means within 1 % of each other;
24. MCMC correctness: cbox 64x64 through the CLI with scenes/cbox/mcmc.json
   at 256 chains and 16 spp-equivalents, on the dispatch route and with
   AKR_PALLAS_SHADE=1 (K9), each with means within 2 % of the committed
   JAX render (testdata/cbox64_mcmc.npy) and MSE against
   testdata/cbox64_spp256.npy within 1.25x JAX's, with b and the
   acceptance beside JAX's;
25. GPT and MCMC at full width: cbox 1024x1024 through the CLI with
   gpt.json (2 spp) and mcmc.json (65,536 chains, 1 spp-equivalent: 16
   steps a chain): GPT paths a second (5 a pixel a sample), MCMC mutations
   a second, K1's launches and mean time, peak device bytes a pixel, and
   the device events and idle share of one GPT sample and one mutation
   step (torch.profiler);
26. the PT pass shapes: cbox 64x64, 16 spp, pmj02bn, d12 through the CLI
   on the pass and the split pass at d = 6, each held to phase 4's gates
   against testdata/cbox64_spp{16,256}.npy, the split bit-equal to the
   pass; classroom 96x96 with the split, held to phase 17's gates and
   bit-equal to phase 8's image; the alpha fixture
   (tests/torch_alpha_scene.py) on the card, its alpha-tested hits and
   staged occlusion equal to the CPU's through K1 and through the pair
   sweep;
27. the split at full width (render_pt, SHAPE_RENDERS renders after a
   warm-up): classroom 1920x1080 at 1 spp with the split at d = 6:
   Mpaths/s (median and spread), K1's and K4's launches a sample, peak
   device bytes a lane, and one sample by torch.profiler (device events,
   idle share);
28. spectral correctness: the cbox fixture at 64x64, 16 spp, pmj02bn, d12
   (scenes/cbox/pt.json with "color": "spectral") and the dispersive prism
   at 64x64, 16 spp, d12 (scenes/prism/spectral.json) through the CLI, each
   held to phase 4's gates against the committed JAX spectral images
   (testdata/{cbox,prism}64_spectral_spp{16,256}.npy); blinds 64^2 spectral
   under AKR_PALLAS_SHADE=1 and AKR_MEGAKERNEL=1 takes the pass (no K8 or
   K9 launch; the image bit-equal to the pass's) where the RGB render takes
   each switch's route; the spectral functions
   (wavelengths, the uplift, the reflectance, the CIE sensor, D65) on the
   card against the CPU on 2^18 seeded inputs; the shader-ops fixture
   (tests/torch_shader_scene.py: Perlin noise, plastic, metal, a
   principled panel with every lobe, fused and combinator) at 64x64 on the
   card against the CPU;
29. spectral at full width: cbox 1024x1024, pmj02bn, d12, 4 spp, three
   renders after a warm-up (Mpaths/s median and range, K1's launches a
   sample, peak device bytes a lane), beside phase 21's RGB pmj02bn row on
   the dispatch (the shade spectral renders take) of the same call; classroom 1920x1080, 1 spp, d12 through the static pair sweep,
   one render (K2-K4's launches, peak bytes a lane); prism 256x256, 16
   spp, d12, one render; one sample each of cbox and classroom by
   torch.profiler (device events, busy time, idle share);
30. the PCG32 draws kernel (csrc/pcg.cu, core/pcg.py::pcg32_draws) at
   PCG_SHAPES against its plain version on the same streams (stream ids
   over all 64 bits), u and the new state bit-equal, one launch a call,
   the old state untouched; at the 61-draw shapes its device time
   (profiler) and CUDA-event time beside its bound (bytes) and the plain
   version's time; its resources at 61 draws and at 1; then a job of the
   benchmark's MCMC configuration (MCMC_JOB) after a warm-up: the
   kernel's launches and its share of the draws (1.0: no plain draw on
   the card), the job's phases, and one mutation step's launches and
   device events (torch.profiler).

31. K9's roughness and evaluation entries (GPT's reconnection shift,
   integrators/gpt_reconnect.py) at the shapes of the benchmark's cell
   cbox-gpt-final (cbox 1024^2, 2^20 lanes): the first base bounce's
   shade (K9r) and the first shift connection's two evaluations (K9e at
   x'_{k-1}, one direction; at V, two), captured from a GPT sample on the
   card's default route, each against its plain version (every lane
   bit-equal, zeros on the dead ones), its device time (profiler) beside
   its bound (bytes) and the plain version's time; their resources; and
   the launches of one sample (a shade a bounce of the base path and the
   shifts, two evaluations a shifted bounce; no dispatch group).

`python3 chip_smoke.py --only 26,27` runs the build and the listed phases
alone (26 after phase 8's image; likewise 11, 14, 21, 23, 28, 29, 30 and
31, 29 with phase 21's RGB row where 21 is named too) and prints no result
line (phases 30 and 31 print their kernels' JSON entries): a quick check
of them on the card.

Each phase prints the seconds since the start when it ends. After the
build it prints what the compiler gave every kernel (registers a thread,
shared memory; K3 at classroom's 4,633 clusters, K8 and K9 at blinds'
tables) and the blocks an SM keeps resident. Phases 5, 9 and 18 time
every K1, K3, K4, K5 and K7 launch of their renders with CUDA events and
compute a bound of each from its own work (K3 and K5 from their counters;
no other counters run in a render: bytes, node steps and box tests). A
kernel whose CUDA-event time a call is under SHORT_MS (K2, K9, K5 at
2^18 rays, K1 on blinds) is also timed by the profiler's device records
(device_ms): events around such a call measure how fast the host issues
it, and the JSON line's `ms` is then the device time, `event_ms` the
events'.

Phase 7 also runs K6 (the K4 kernel with the early-out off, `pairs.sweep`)
at classroom's shapes against its plain version; no main path calls it.

It prints a JSON line of kernel results (with each kernel's bound: the
bytes it must move over 3.35 TB/s or the FP32 operations this run's data
needs over 67 TFLOP/s, whichever is longer; the operations of each test
counted from the sources (MT_FLOPS and the constants beside it); for K1,
K4, K6 and K7 the operations are those the candidate test needs lane by
lane with its box test, from its counters, for K3 and K5 those their
counters show (summary tests and units of slab tests), for K2 those of
each row's case (dead, sign case, full chain), and `full_count_ms` beside
them is the time of the count before the skips: every live lane against
every triangle, slot or cluster of a live tile, every K2 element through
the full chain;
each kernel's registers and resident blocks), the card's name and power
limit, and last a JSON line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "matbox" / "scene.json"
METHOD = ROOT / "scenes" / "matbox" / "pt.json"
CLASSROOM = ROOT / "scenes" / "classroom" / "scene.json"
CLASSROOM_METHOD = ROOT / "scenes" / "classroom" / "pt.json"
CLASSROOM_GT = ROOT / "BENCH_MSE_CLASSROOM.gt.exr"  # 96x96, 512 spp
OUT = ROOT / "build" / "chip_smoke"
N_RAYS = 1 << 18
FULL_SPP = 8

# phase-4 tolerances: channel means within 1 % of the JAX 16-spp image, and
# MSE against the JAX 256-spp image within 1.1x of the JAX 16-spp image's
MEAN_TOL = 0.01
MSE_RATIO = 1.1
# phase-7 independent check, the pair sweep against K1 over the flattened
# soup. Where their t differ by more than PAIRS_T_REL (relative) or their
# hit flags differ, either both hit the same triangle and t differs by at
# most PAIRS_T_ABS metres (instanced hits compute t from a transformed ray,
# which rounds to ~1e-6 m at classroom's coordinates, and a ray that starts
# millimetres from a surface has a tiny t), or the two hit different
# surfaces: on at most PAIRS_K1_MAX rays (measured: 1 of 2^18), each passing
# within GRAZE_M metres of an edge of the nearer triangle (float64), where
# Moller-Trumbore, not watertight, lets a ray through the crack between two
# triangles in one form of the geometry and not in the other
PAIRS_T_REL = 1e-4
PAIRS_T_ABS = 1e-5
PAIRS_K1_MAX = 1
GRAZE_M = 1e-5
# the fused tiers on blinds
BLINDS = ROOT / "scenes" / "blinds" / "scene.json"
BLINDS_METHOD = ROOT / "scenes" / "blinds" / "pt.json"
# phase-11 tolerances: K9 against its plain version, relative per output,
# and the fraction of lanes whose valid flag may differ
K9_REL = 1e-5
K9_VALID_FRAC = 1e-5
# the reference's own PT configuration (phases 19-22)
CBOX = ROOT / "scenes" / "cbox" / "scene.json"
CBOX_METHOD = ROOT / "scenes" / "cbox" / "pt.json"
# phase 19: lanes and dimensions a sampler draws, on the card and the CPU
SAMPLER_LANES = 1 << 20
SAMPLER_DIMS = 24
# phase 20: the first hit's albedo from K9 against the dispatch route's
# closures (K9's plain version is within 5e-6 of them on the CPU)
AUX_ALBEDO_TOL = 1e-5
# phase 21: samples of the timed cbox render; its rows (sampler, shade
# route) in turns, since the host's clock moves between renders; the
# routes' AKR_PALLAS_SHADE (None: unset, the card's default) and the shade
# the stats report
CBOX_SPP = 4
CBOX_ROWS = (("pmj02bn", "K9"), ("pmj02bn", "dispatch"), ("independent", "K9"),
             ("independent", "K9"), ("pmj02bn", "dispatch"), ("pmj02bn", "K9"))
SHADE_ROUTES = {"K9": (None, "fused (K9)"), "dispatch": ("0", "dispatch")}
# phase 21: K9 against the dispatch on the first bounce of a cbox 1024^2
# sample, with the tolerances of tests/test_pallas_shade.py: valid equal on
# all but this fraction of live lanes, direct and albedo within these
K9_DISPATCH_VALID_FRAC = 1e-3
K9_DISPATCH_ATOL = 5e-5
K9_DISPATCH_RTOL = 5e-4
# phase 22: the AOVs of matbox 64^2, 2 spp, against the JAX set. Every
# pixel but AOV_PIX_FRAC of them within AOV_ABS (the roughness: within
# AOV_ABS on all but AOV_ROUGH_FRAC, since the lobe a sample picks reads
# the GGX albedo table, which the card draws itself), and every image's
# channel means within AOV_MEAN_REL (the roughness's AOV_ROUGH_MEAN_REL)
AOV_ABS = 1e-4
AOV_PIX_FRAC = 1e-3
AOV_ROUGH_FRAC = 0.01
AOV_MEAN_REL = 1e-3
AOV_ROUGH_MEAN_REL = 0.01
# the gradient-domain path tracer and Kelemen PSSMLT (phases 23-25)
CBOX_GPT = ROOT / "scenes" / "cbox" / "gpt.json"
CBOX_MCMC = ROOT / "scenes" / "cbox" / "mcmc.json"
# phase 23: GPT's gradients against JAX's at the pixels where JAX's film
# holds one pair's two ends (their mean; the port's holds their sum), by
# correlation (the gradients' means are near zero) and by the slope of the
# port's on JAX's, within GRAD_SLOPE_TOL of 2 (the card's paths are JAX's
# samples, which GRAD_CORR holds)
GRAD_CORR = 0.99
GRAD_SLOPE = 2.0
GRAD_SLOPE_TOL = 0.05
# phase 24: the chains on the card drift from JAX's as float sums differ,
# so the image is held statistically: means within 2 %, MSE against the JAX
# 256-spp PT image within 1.25x the JAX MCMC image's own
MCMC_MEAN_TOL = 0.02
MCMC_MSE_RATIO = 1.25
MCMC_CHAINS_64 = 256  # the 1024^2 configuration's chains a pixel, 1/16
# phase 25: samples of the GPT render and spp-equivalents of the MCMC one
GPT_SPP = 2
MCMC_SPP = 1
# phase 30: the pcg32_draws kernel's shapes (lanes, draws a call): the
# mutation step's PSS of 65,536 chains, a bootstrap chunk's 131,072 lanes,
# one draw, a ragged block
PCG_SHAPES = ((65536, 61), (131072, 61), (1000, 1), (33, 7))
# phase 30: a job of the benchmark's MCMC configuration (cbox-1024-mcmc-gpu:
# mcmc.json's 65,536 chains, cut to 2 spp-equivalents, 2^20 bootstrap
# samples and a 1-spp direct pass)
MCMC_JOB = {"spp": 2, "n_bootstrap": 1 << 20, "direct_spp": 1}
# spectral transport and the last shader ops (phases 28-29)
PRISM = ROOT / "scenes" / "prism" / "scene.json"
PRISM_SPECTRAL = ROOT / "scenes" / "prism" / "spectral.json"
# phase 28: seeded inputs of the spectral functions on the card and the
# CPU: the wavelengths and the uplift's scale equal, the rest within
# SPECTRAL_TOL of each quantity's scale (tests/test_torch_spectral.py's
# tolerance) but the reflectance and D65 within SPECTRAL_TOL_DIV: the
# card divides a tensor by a Python constant as a product with its rounded
# reciprocal (the wavelength's normalised position, D65's knot index), an
# ulp that the reflectance's polynomial slope amplifies (measured 1.19e-6)
SPECTRAL_LANES = 1 << 18
SPECTRAL_TOL = 1e-6
SPECTRAL_TOL_DIV = 1e-5
# phase 28: the shader-ops fixture on the card against the CPU: its size,
# samples and depth, and the gate: channel means within FIXTURE_MEAN_REL,
# all but FIXTURE_PIX_FRAC of the pixels within 1e-3 of max(1, value) (a
# lane whose float decision flips moves its pixel)
FIXTURE_RES = 64
FIXTURE_SPP = 1
FIXTURE_DEPTH = 5
FIXTURE_MEAN_REL = 1e-3
FIXTURE_PIX_FRAC = 0.01
# phase 28: samples of each blinds 64^2 render under the fused tiers' switches
SWITCH_SPP = 2
# phase 29: timed renders of spectral cbox 1024^2 (CBOX_SPP samples each)
SPECTRAL_RENDERS = 3
PRISM_SPP = 16
# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32 outside
# the tensor cores, and HBM bandwidth
FP32_PEAK = 67e12
HBM_BPS = 3.35e12
# FP32 operations, counted from the sources: every add, subtract,
# multiply, division, square root, min, max, compare and select is one (an
# abs is an operand modifier, a library call such as sinf one). Built with
# -fmad=false, each instruction carries one, so the card issues them at
# half the 67 TFLOP/s of FMAs: the bounds below are half what an issue
# bound would give.
# one Möller-Trumbore ray-triangle test (csrc/candidate_test.cuh:265-285,
# mt_slot: 45 adds and multiplies, the division, 4 compares and inv_det's
# select), as K1, K4, K6 and K8 (csrc/megakernel.cu:104-117) write it
MT_FLOPS = 51
# what the candidate test adds a slot tested (candidate_test.cuh:385-387:
# the id offset, t against [tmin, best t], three exclusion compares)
SLOT_FLOPS = 6
# K8's a (ray, triangle): t > 0, t < tmax and t < best t
# (megakernel.cu:118-122)
K8_TRI_FLOPS = MT_FLOPS + 3
# a ray's world->local transform (candidate_test.cuh:356-361)
XF_FLOPS = 33
# the candidate test's widened box test (candidate_test.cuh:234-246,
# box_pass: the margin 10, the widened bounds, subtractions and products
# 18, near and far 12, the compare)
BOX_FLOPS = 41
# K2's interval chain on one summary and box (csrc/pairs.cu::interval_entry:
# per axis 4 subtractions, 8 products, 12 min/max, 4 for entry and exit;
# two clamps, the compare and the select), and K2's sign case of it
# (pairs.cu::cased_entry: per axis 2 subtractions, 4 products, 6 min/max,
# 2 zero tests, entry and exit; the clamps, compare and select)
CHAIN_FLOPS = 88
CASED_FLOPS = 52
# one lane's slab test of a box (pairs.cu::lane_slab, K3 and K5: per axis
# 2 subtractions, 2 products, 4 min/max; two clamps and the compare); K7's
# node step tests 8 children with it and selects each entry
SLAB_FLOPS = 27
K7_NODE_FLOPS = 8 * (SLAB_FLOPS + 1)
# K9, a live lane of blinds' closure (csrc/reduced_closure.cuh::
# reduced_shade<SPEC, no METAL, ALBEDO>): the closure 47 (the frame's flip
# and wo's side test 24, wo in the frame 15, the albedo table 8); NEE 249
# (to_local 15, bsdf_eval 202 of which ggx_refl_base1 112 and
# fr_dielectric1 31, the side test 17, the MIS weight and scale 15); the
# sample 369 (the lobe pick 5, ggx_sample_wh1 97, the reflection 7, the
# cosine sample 16, the pick and valid 5, the world direction 15, bsdf_eval
# 202, the side test and the selects 22); the albedo 18
K9_LIVE_FLOPS = 47 + 249 + 369 + 18
# K9r, a live lane: K9's closure without the albedo, and the roughness's
# select
K9R_LIVE_FLOPS = K9_LIVE_FLOPS - 18 + 1
# K9e: the closure at wo (47, as K9's) and a direction (to_local 15,
# bsdf_eval 202, the side test 17, the leak check's four selects)
K9E_SETUP_FLOPS = 47
K9E_DIR_FLOPS = 15 + 202 + 17 + 4


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what sets it): ops FP32 operations at the
    FP32 peak against nbytes of device memory traffic at HBM_BPS."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a kernel whose CUDA-event time a call is below this is also timed by the
# profiler's device records (device_ms): events around such a call measure
# how fast the host issues it
SHORT_MS = 0.1


# the kernels pad_profiler_window launches
PAD_LAUNCHES = 1024


def pad_profiler_window():
    """Launch PAD_LAUNCHES tiny kernels and wait: the first (and, in
    device_events_per_call, the last) work of a profiler window. This torch
    build loses a window's first and last device records (measured on the
    card, phase 14's windows: 11-15 of the first in every window after the
    earlier phases' windows, 17-203 of the last in some; before the pads 13
    of 20 launches once, and a marker kernel), so the records that matter
    lie between such pads."""
    import torch

    x = torch.empty(1, device="cuda")  # no kernel: only the adds are recorded
    for _ in range(PAD_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize()


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of one launch of the kernel whose name holds
    `kernel`, from torch.profiler's device records of runs of `reps` calls
    of fn (one launch each): the kernel's own time. CUDA events around a
    call of a short kernel measure the host instead (the wrapper's checks,
    allocations and ctypes call). Each window starts padded
    (pad_profiler_window); should records still be lost, windows are
    repeated, up to five, until `reps` launches are recorded, and the mean
    is over the launches recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profiler_window()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs += [e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA and kernel in e.name()]
        if len(durs) >= reps:
            break
    check(len(durs) >= reps // 2,
          f"the profiler recorded {len(durs)} launches of {kernel} in up to {5 * reps} calls")
    return sum(durs) / len(durs) / 1e6


def event_and_device_ms(fn, reps: int, kernel: str) -> dict:
    """{"event_ms": CUDA events around `reps` calls, a call; "device_ms":
    device_ms where the event time is below SHORT_MS, else None; "ms": the
    device time where measured, else the event time}."""
    ev = cuda_ms(fn, reps)
    dev = device_ms(fn, reps, kernel) if ev < SHORT_MS else None
    return {"ms": dev if dev is not None else ev, "event_ms": ev, "device_ms": dev}


def times_text(t: dict) -> str:
    """An event_and_device_ms result in words."""
    if t["device_ms"] is None:
        return f"{t['event_ms']:.4f} ms (CUDA events)"
    return (f"{t['device_ms']:.4f} ms device time (profiler; CUDA events around the calls, the "
            f"host's issue rate: {t['event_ms']:.4f} ms)")


def timed(fn):
    """(fn's result, milliseconds of that one call by CUDA events): for a
    plain version whose result is also the one compared."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def full_count_ops(reached, lanes, C: int) -> float:
    """The candidate test run in full: every live lane of a block against
    every slot of every candidate its walk must reach (the bound's count
    before the box test; kept so that times stay comparable with it).
    reached, lanes: per block [B]."""
    return float((reached.double() * lanes.double()).sum()) * (XF_FLOPS + C * (MT_FLOPS + SLOT_FLOPS))


def box_test_ops(reached, lanes) -> float:
    """One box test for every live lane of a block and candidate reached."""
    return float((reached.double() * lanes.double()).sum()) * BOX_FLOPS


def needed_ops(reached, lanes, stats, C: int) -> float:
    """The FP32 operations the candidate test needs on this run's data, lane
    by lane: a box test per live lane and candidate reached, a ray
    transform per lane queued for a candidate (stats' units over the 32-slot
    chunks of a candidate) and a Moller-Trumbore test per (lane, slot) pair
    tested: inside the box, or a sliver slot."""
    st = stats.double().sum(0)
    return (box_test_ops(reached, lanes) + float(st[0]) / -(-C // 32) * XF_FLOPS
            + float(st[2]) * (MT_FLOPS + SLOT_FLOPS))


def issued_ops(reached, stats, warps: int) -> float:
    """The FP32 operations the candidate test issued, from its counters
    (stats [B, 4]: units of a queued lane x 32 slots run, lanes that passed
    the box test, slots tested, slots that hit): a warp issues for its 32
    lanes. Every warp of a block box-tests every candidate reached; a
    passing lane's transform is counted as a warp's."""
    st = stats.double().sum(0)
    per_warp = (float(reached.double().sum()) * warps * BOX_FLOPS + float(st[1]) * XF_FLOPS
                + float(st[0]) * (MT_FLOPS + SLOT_FLOPS))
    return 32.0 * per_warp


def counters_text(reached, stats, lanes, C: int, warps: int) -> str:
    """One sentence on where a walk's candidate tests went."""
    st = stats.double().sum(0)
    n_reached = float(reached.double().sum())
    lane_cands = float((reached.double() * lanes.double()).sum())
    return (f"{int(n_reached)} candidates reached; lanes that passed the box test {int(st[1])} of "
            f"{int(lane_cands)} live ({st[1] / max(lane_cands, 1):.4f}; "
            f"{st[1] / max(n_reached, 1):.2f} a candidate); units of a passing lane x 32 slots "
            f"run {int(st[0])}; slots tested (each with its division) {int(st[2])} of the "
            f"{int(lane_cands * C)} of every live lane ({st[2] / max(lane_cands * C, 1):.4f}), "
            f"{int(st[3])} of them hit; FP32 operations needed lane by lane "
            f"{needed_ops(reached, lanes, stats, C):.4g}, issued warp by warp "
            f"{issued_ops(reached, stats, warps):.4g}, of the full count's "
            f"{full_count_ops(reached, lanes, C):.4g}")


T0 = time.perf_counter()


def lap(phase: str):
    print(f"[{time.perf_counter() - T0:.1f} s] {phase} done", flush=True)


def make_rays(scene, device):
    """2^17 jittered camera rays (pixels drawn without replacement where the
    film has enough) plus 2^17 rays from inside the box."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.camera import generate_rays

    rng = np.random.default_rng(7)
    cam = scene.camera
    half = N_RAYS // 2
    pix = rng.choice(cam.width * cam.height, size=half, replace=cam.width * cam.height < half)
    p_film = np.stack([pix % cam.width, pix // cam.width], -1) + rng.random((half, 2))
    o_c, d_c = generate_rays(cam, torch.as_tensor(p_film, dtype=torch.float32, device=device))
    v0 = scene.arrays.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((half, 3)))
    d_r = rng.normal(size=(half, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c.contiguous(), torch.as_tensor(o_r, dtype=torch.float32, device=device)])
    d = torch.cat([d_c, torch.as_tensor(d_r, dtype=torch.float32, device=device)])
    return o.contiguous(), d.contiguous(), rng


def k1_check(label, args, tiles, plain=None):
    """K1 on `tiles` against its plain version on args (o, d, tmin, tmax,
    v0, e1, e2, ex0..ex2), closest and any hit: every id, t, u, v and flag
    bit-equal. Returns (closest hits, occlusion, plain closest hits)."""
    import torch

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.core.math import RAY_TMAX

    hk = k1.intersect_tris(*args, tiles=tiles)
    hp = plain if plain is not None else k1.intersect_tris_torch(*args)
    ok_k = k1.intersect_tris(*args, any_hit=True, tiles=tiles)
    ok_p = k1.intersect_tris_torch(*args, any_hit=True)
    torch.cuda.synchronize()
    id_mis = int((hk.tri_id != hp.tri_id).sum())
    occ_mis = int((ok_k != ok_p).sum())
    err = max(max_abs_diff(hk.t, hp.t), max_abs_diff(hk.bary, hp.bary))
    print(f"K1 parity, {label}: {args[0].shape[0]} rays x {args[4].shape[0]} tris; hits "
          f"{int(hp.valid.sum())}, occluded {int(ok_p.sum())}; id mismatches {id_mis}, occlusion "
          f"mismatches {occ_mis}; max abs err (t, u, v) {err}", flush=True)
    check(id_mis == 0 and occ_mis == 0 and torch.equal(hk.t, hp.t)
          and torch.equal(hk.bary, hp.bary) and torch.equal(hk.valid, hp.valid),
          f"K1 differs from its plain version ({label})")
    check(bool(torch.all(hk.t[~hk.valid] == RAY_TMAX)), "K1 misses must report t = RAY_TMAX")
    return hk, ok_k, hp


def k1_bound(n_live, walked, stats, tiles, n: int, T: int):
    """(bound ms, by, full-count ms) of one K1 launch: a widened box test
    per live lane and tile reached (walked: tiles per block, n_live: live
    lanes per block) and, with the counters (stats [B, 4], or None in a
    render), a Moller-Trumbore test per (lane, slot) tested; against the
    bytes (each ray's 44 B read and 16 B written, the tiles once). The full
    count is every live lane against every triangle (the earlier bound)."""
    ops = box_test_ops(walked, n_live)
    if stats is not None:
        ops += float(stats.double().sum(0)[2]) * (MT_FLOPS + SLOT_FLOPS)
    nbytes = 60.0 * n + 4.0 * (tiles.tri.numel() + tiles.boxes.numel() + tiles.slots.numel())
    b_ms, b_by = bound(ops, nbytes)
    return b_ms, b_by, bound(float(n_live.double().sum()) * T * (MT_FLOPS + SLOT_FLOPS), 0.0)[0]


def k1_parity(scene, device):
    """Phase 3: K1 against its plain version on 2^18 rays, on rays aimed at
    the triangles that define its tiles' boxes and through its sliver
    triangles, and on blinds' soup, with its counters, the recounted bound
    and CUDA event timings. Returns the kernel's JSON entry."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cull_rays import aimed_rays, sliver_rays, tile_clusters

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.core.math import RAY_TMAX
    from akari_render_tpu_torch.scene import load_scene

    a, tiles = scene.arrays, scene.tiles
    tris = (a.v0, a.e1, a.e2)
    o, d, rng = make_rays(scene, device)
    n, t_count = o.shape[0], a.v0.shape[0]
    tmin = torch.zeros(n, device=device)
    tmax = torch.full((n,), RAY_TMAX, device=device)
    # exclusion ids: a quarter of the rays exclude the surface they hit
    # first, others carry random ids in the second and third slots
    first = k1.intersect_tris_torch(o, d, tmin, tmax, *tris)
    ex0 = torch.where(torch.as_tensor(rng.random(n) < 0.25, device=device), first.tri_id, -1)
    ex1 = torch.as_tensor(np.where(rng.random(n) < 0.25, rng.integers(0, t_count, n), -1),
                          dtype=torch.int32, device=device)
    ex2 = torch.as_tensor(np.where(rng.random(n) < 0.1, rng.integers(0, t_count, n), -1),
                          dtype=torch.int32, device=device)
    ex0 = ex0.to(torch.int32)
    # any-hit rays: shadow-like segments, half cut before the first hit
    seg = torch.where(first.valid, first.t, 10.0)
    cut = torch.as_tensor(rng.random(n) < 0.5, device=device)
    tmax_any = torch.where(cut, seg * 0.5, seg * 1.5)
    args = (o, d, tmin, tmax, *tris, ex0, ex1, ex2)
    args_any = (o, d, tmin, tmax_any, *tris, ex0, ex1, ex2)
    plain_closest, plain_ms = timed(lambda: k1.intersect_tris_torch(*args))
    k1_check("2^18 camera and interior rays", args, tiles, plain_closest)
    k1_check("2^18 shadow segments", args_any, tiles)

    # rays aimed at the triangles that define every tile's box (1e-6 to
    # 1e-4 rad from a triangle's plane among them), cut and open, and rays
    # through the hittable sliver triangles
    view = tile_clusters(tiles)
    oa, da, ta = [], [], []
    for i, how in enumerate(("head_on", "grazing", "plane_grazing", "random")):
        o_h, d_h, dist = aimed_rays(view, np.arange(tiles.slots.shape[0]), how, seed=30 + i)
        oa.append(o_h)
        da.append(d_h)
        ta.append(np.where(np.arange(len(o_h)) % 2 == 0, dist * np.float32(1.0 - 1e-5), RAY_TMAX))
    ids = torch.nonzero(k1.hittable_slivers(*tris)).squeeze(1).cpu().numpy()
    o_s, d_s = sliver_rays(*(x.cpu().numpy() for x in tris), ids, 64, seed=34)
    oa.append(o_s)
    da.append(d_s)
    ta.append(np.full(len(o_s), RAY_TMAX))
    o_a, d_a = (torch.as_tensor(np.concatenate(x), device=device) for x in (oa, da))
    t_a = torch.as_tensor(np.concatenate(ta), dtype=torch.float32, device=device)
    hk, _, _ = k1_check("aimed at the tiles' box-defining triangles and through slivers",
                        (o_a, d_a, torch.zeros_like(t_a), t_a, *tris), tiles)
    on_sliver = hk.valid & k1.hittable_slivers(*tris)[hk.tri_id.clamp(min=0).long()]
    print(f"  of those, hits on sliver triangles: {int(on_sliver.sum())}", flush=True)

    # blinds: 28 triangles, one tile
    blinds = load_scene(str(BLINDS), device=device)
    o_b, d_b, _ = make_rays(blinds, device)
    b_args = (o_b, d_b, tmin, tmax, blinds.arrays.v0, blinds.arrays.e1, blinds.arrays.e2)
    blinds_plain, blinds_plain_ms = timed(lambda: k1.intersect_tris_torch(*b_args))
    k1_check("blinds", b_args, blinds.tiles, blinds_plain)

    # counters of the closest-hit call, and times
    B = -(-n // k1.BLOCK)
    walked = torch.zeros(B, dtype=torch.int32, device=device)
    stats = torch.zeros((B, 4), dtype=torch.int32, device=device)
    counted = k1.intersect_tris(*args, tiles=tiles, walked=walked, stats=stats)
    check(torch.equal(counted.tri_id, plain_closest.tri_id), "K1 with its counters differs")
    live = torch.nn.functional.pad((tmax > tmin).int(), (0, B * k1.BLOCK - n)).reshape(B, -1).sum(1)
    st = stats.double().sum(0)
    lane_tiles = float((walked.double() * live.double()).sum())
    ms = cuda_ms(lambda: k1.intersect_tris(*args, tiles=tiles), 20)
    ms_any = cuda_ms(lambda: k1.intersect_tris(*args_any, any_hit=True, tiles=tiles), 20)
    plain_ms_any = cuda_ms(lambda: k1.intersect_tris_torch(*args_any, any_hit=True), 3)
    blinds_t = event_and_device_ms(lambda: k1.intersect_tris(*b_args, tiles=blinds.tiles), 20,
                                   "flat_kernel")
    bound_ms, bound_by, full_ms = k1_bound(live, walked, stats, tiles, n, t_count)
    b_live = torch.full((B,), k1.BLOCK, device=device)
    blinds_bound = k1_bound(b_live, torch.ones(B, device=device), None, blinds.tiles, n,
                            blinds.num_tris)
    print(f"K1 counters, closest hit: {tiles.slots.shape[0]} tiles; live (lane, tile) pairs "
          f"{int(lane_tiles)}, passed the box test {int(st[1])} ({st[1] / lane_tiles:.4f}); units "
          f"of a queued lane x 32 slots {int(st[0])}; slots tested {int(st[2])} of the "
          f"{int(live.sum()) * t_count} of the full count ({st[2] / (int(live.sum()) * t_count):.4f}),"
          f" {int(st[3])} hit", flush=True)
    print(f"K1 times at {n} rays x {t_count} tris: closest {ms:.4f} ms (plain {plain_ms:.4f} ms), "
          f"any hit {ms_any:.4f} ms (plain {plain_ms_any:.4f} ms); bound {bound_ms:.4f} ms by "
          f"{bound_by}; the full count (every lane x every triangle) would take {full_ms:.4f} ms; "
          f"blinds ({blinds.num_tris} tris) {times_text(blinds_t)} (plain {blinds_plain_ms:.4f} "
          f"ms, bound {blinds_bound[0]:.4f} ms by {blinds_bound[1]})", flush=True)
    return {
        "name": "K1 flat-tier Moller-Trumbore over box-tested tiles (closest hit)",
        "route": "cuda",
        "source": "akari_render_tpu_torch/csrc/intersect.cu",
        "replaces": "akari_render_tpu/accel/pallas_intersect.py:37",
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "full_count_ms": full_ms,
        "any_hit_ms": ms_any,
        "blinds_ms": blinds_t["ms"],
        "blinds_event_ms": blinds_t["event_ms"],
    }


def pcg_parity(device):
    """The PCG32 sampler's int64 wraparound on the card equals the CPU's."""
    import torch

    from akari_render_tpu_torch.core.lds import make_sampler

    pix = torch.arange(N_RAYS, dtype=torch.int64)
    draws = []
    for dev in ("cpu", device):
        s = make_sampler({"type": "independent", "seed": 0}, pix.to(dev), 5, 0)
        s, u = s.next_3d()
        draws.append((u.cpu(), s.rng.state.cpu()))
    check(torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1]),
          "PCG32 draws on the card differ from the CPU's")
    print(f"PCG32 parity: {N_RAYS} lanes x 3 draws bit-equal on cpu and {device}", flush=True)


def slice_correctness(device):
    """Phase 4: matbox 64^2 16 spp against the committed JAX images."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "matbox64.exr"
    cli_main(["-s", str(SCENE), "-m", str(METHOD), "--res", "64", "--spp", "16",
              "-o", str(out), "--device", device])
    img = read_exr(out)
    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    jax16 = np.load(testdata / "matbox64_spp16.npy")
    gt = np.load(testdata / "matbox64_spp256.npy")
    check(img.shape == jax16.shape and bool(np.all(np.isfinite(img))), "64^2 image shape / finiteness")
    m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
    mse_port = float(np.mean((img - gt) ** 2))
    mse_jax = float(np.mean((jax16 - gt) ** 2))
    mse_pj = float(np.mean((img - jax16) ** 2))
    print(f"slice 64^2 16spp: means port {m_port} jax {m_jax} (max rel {mean_rel:.3g}); "
          f"MSE(port, gt) {mse_port:.6g}, MSE(jax16, gt) {mse_jax:.6g}, "
          f"MSE(port, jax16) {mse_pj:.6g}", flush=True)
    check(mean_rel <= MEAN_TOL, "64^2 channel means differ from the JAX image by more than 1%")
    check(mse_port <= MSE_RATIO * mse_jax, "64^2 MSE against the JAX ground truth too high")


class timed_k1:
    """For a block, time every K1 launch of the scene layer with CUDA
    events (around the wrapper) and keep each launch's tiles walked per
    block and live lanes, for its bound (no counters in a render: box tests
    and bytes). summary() as timed_walks'."""

    def __enter__(self):
        import torch

        from akari_render_tpu_torch import scene as scene_mod
        from akari_render_tpu_torch.accel import intersect as k1

        self.real, self.records = scene_mod.intersect_tris, []

        def wrapped(o, d, tmin, tmax, v0, e1, e2, *rest, tiles=None, **kw):
            n = o.shape[0]
            B = -(-n // k1.BLOCK)
            walked = torch.zeros(B, dtype=torch.int32, device=o.device)
            live = torch.nn.functional.pad((tmax > tmin).int(), (0, B * k1.BLOCK - n))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(o, d, tmin, tmax, v0, e1, e2, *rest, tiles=tiles, walked=walked, **kw)
            end.record()
            self.records.append((start, end, walked, live.reshape(B, -1).sum(1), tiles, n,
                                 v0.shape[0]))
            return out

        scene_mod.intersect_tris = wrapped
        return self

    def __exit__(self, *exc):
        from akari_render_tpu_torch import scene as scene_mod

        scene_mod.intersect_tris = self.real

    def summary(self) -> dict:
        import torch

        torch.cuda.synchronize()
        ms, bnd, full = [], [], []
        for start, end, walked, live, tiles, n, T in self.records:
            ms.append(start.elapsed_time(end))
            b_ms, _, f_ms = k1_bound(live, walked, None, tiles, n, T)
            bnd.append(b_ms)
            full.append(f_ms)
        return {"launches": len(ms), "ms": sum(ms) / len(ms), "ms_min": min(ms),
                "ms_max": max(ms), "bound_ms": sum(bnd) / len(bnd),
                "full_count_ms": sum(full) / len(full)}


def full_width(device):
    """Phase 5: matbox 512^2 through the CLI, launches counted and every K1
    launch timed. Returns (launches, the timings' summary)."""
    import numpy as np

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "matbox512.exr"
    stats_path = out.with_suffix(".stats.json")
    for p in (out, stats_path):
        p.unlink(missing_ok=True)
    with timed_k1() as timing:
        k1.launches = 0
        t0 = time.perf_counter()
        stats = cli_main(["-s", str(SCENE), "-m", str(METHOD), "--spp", str(FULL_SPP),
                          "-o", str(out), "--save-stats", "--device", device])
        wall = time.perf_counter() - t0
        launches = k1.launches
    check(launches > 0, "the main path launched K1 no time")
    check(out.exists() and stats_path.exists(), "EXR or stats JSON missing")
    img = read_exr(out)
    check(img.shape == (512, 512, 3) and bool(np.all(np.isfinite(img))), "512^2 image shape / finiteness")
    paths = 512 * 512 * FULL_SPP
    mpaths = paths / stats["total_time"] / 1e6
    print(f"slice 512^2 {FULL_SPP}spp d12: render {stats['total_time']:.3f} s "
          f"({mpaths:.4f} Mpaths/s), CLI wall {wall:.3f} s, K1 launches {launches}, "
          f"image mean {img.mean(axis=(0, 1))}", flush=True)
    summary = timing.summary()
    check(summary["launches"] == launches, f"K1: {summary['launches']} launches timed of {launches}")
    print(f"K1 at this render's own shapes (CUDA events around each of its {launches} launches): "
          f"mean {summary['ms']:.4f} ms, least {summary['ms_min']:.4f}, most "
          f"{summary['ms_max']:.4f}; mean bound (box tests and bytes) {summary['bound_ms']:.4f} ms;"
          f" the full count would take {summary['full_count_ms']:.4f} ms", flush=True)
    return launches, summary


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over entries that are not bit-equal (0.0 if all are;
    inf where only one side is infinite)."""
    import torch

    diff = torch.where(a == b, 0.0, torch.abs(a.double() - b.double()))
    diff = torch.nan_to_num(diff, nan=float("inf"))
    return float(diff.max()) if diff.numel() else 0.0


def mt64(o, d, v0, e1, e2):
    """Float64 Moller-Trumbore of ray i against triangle i: (t, signed
    distance in the triangle's plane from the hit point to its nearest
    edge, negative outside)."""
    import numpy as np

    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.cross(d, e2)
        inv = 1.0 / np.sum(e1 * p, -1)
        tv = o - v0
        q = np.cross(tv, e1)
        u = np.sum(tv * p, -1) * inv
        v = np.sum(d * q, -1) * inv
        t = np.sum(e2 * q, -1) * inv
        area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
        ln = [np.linalg.norm(e, axis=-1) for e in (e2 - e1, e2, e1)]
        dist = np.minimum.reduce([w * area2 / np.maximum(n, 1e-30)
                                  for w, n in zip((1.0 - u - v, u, v), ln)])
    return t, dist


def virtual_to_flat(scene, sg, info):
    """([n_ids] flattened-soup triangle of each global virtual id, the names
    of the instanced instances). Flat ids come first, in scene order
    without the instanced instances, then each instance's local triangles
    from its tri_base."""
    import numpy as np

    from akari_render_tpu_torch.scene import _partition_instances

    skip, _, _ = _partition_instances(sg)
    ia = scene.arrays.instanced
    base, count = ia.tri_base.cpu().numpy(), ia.tri_count.cpu().numpy()
    names = list(sg.instances)
    v2f = np.full(int(base[-1] + count[-1]), -1, np.int64)
    run = 0
    for i in info:
        if i["name"] not in skip:
            v2f[run:run + i["tri_count"]] = i["tri_start"] + np.arange(i["tri_count"])
            run += i["tri_count"]
    check(run == scene.num_tris, "flat triangles of the scene and the flattened soup differ")
    start = {i["name"]: i["tri_start"] for i in info}
    for b, c, k in zip(base, count, ia.inst_index.cpu().numpy()):
        v2f[b:b + c] = start[names[k]] + np.arange(c)
    return v2f, skip


def explain_disagreements(o, d, tmin, tmax, hk, hp, bad, scene, sg, soup, info):
    """For each ray on which the pair sweep (hp) and K1 over the flattened
    soup (hk) disagree, print both hits mapped back to their instances and
    either the gap in t (the same triangle on both sides) or, in float64,
    the distance from the ray to the nearest edge of the nearer triangle,
    which the farther side missed. The rays and hits go to
    pairs_vs_k1.npz. Returns (same triangle [m], |t gap| [m], that edge
    distance [m])."""
    import numpy as np

    idx = np.nonzero(bad.cpu().numpy())[0]
    v2f, skip = virtual_to_flat(scene, sg, info)
    names = list(sg.instances)
    kt, kid, kv = (x[idx].cpu().numpy() for x in (hk.t, hk.tri_id, hk.valid))
    pt, pid, pv = (x[idx].cpu().numpy() for x in (hp.t, hp.tri_id, hp.valid))
    pflat = np.where(pv, v2f[np.clip(pid, 0, len(v2f) - 1)], -1)
    same = kv & pv & (kid == pflat)
    gap = np.where(same, np.abs(kt.astype(np.float64) - pt), np.inf)
    k_near = kv & (~pv | (kt < pt))
    near_tri = np.where(k_near, kid, pflat)
    _, edge = mt64(o[idx].cpu().numpy(), d[idx].cpu().numpy(),
                   *(a[near_tri] for a in (soup.v0, soup.e1, soup.e2)))

    def who(flat):
        if flat < 0:
            return "miss"
        name = names[soup.inst_id[flat]]
        return f"{name} tri {flat} ({'instanced' if name in skip else 'flat'})"

    for j, r in enumerate(idx):
        why = (f"same triangle, t gap {gap[j]:.3g} m" if same[j] else
               f"different surfaces, nearer {'K1' if k_near[j] else 'pair sweep'}, whose "
               f"triangle's edge is {edge[j]:.3g} m from the ray (float64)")
        print(f"  ray {r}: K1 t {kt[j]:.7g} {who(kid[j] if kv[j] else -1)}; pair sweep t "
              f"{pt[j]:.7g} {who(pflat[j])}; {why}", flush=True)
    np.savez(OUT / "pairs_vs_k1.npz", idx=idx, o=o[idx].cpu().numpy(), d=d[idx].cpu().numpy(),
             tmin=tmin[idx].cpu().numpy(), tmax=tmax[idx].cpu().numpy(),
             k1_t=kt, k1_id=kid, k1_valid=kv, pairs_t=pt, pairs_id=pid, pairs_valid=pv,
             pairs_flat=pflat)
    return same, gap, edge


def k2_check(label, got, want, summ, cb6) -> dict:
    """K2 against its plain chain (cull_einit_torch): equal, and every bit
    pattern that differs (int32 views) a zero of the other sign; the count
    printed. Also the kernel's twin (cull_einit_cased_torch) against the
    chain, bit for bit. Returns the twin's tally of the rows' cases."""
    import torch

    from akari_render_tpu_torch.accel import pairs

    tally = {}
    twin = pairs.cull_einit_cased_torch(summ, cb6, tally)
    differ = got.view(torch.int32) != want.view(torch.int32)
    n_diff = int(differ.sum())
    zeros = bool((got[differ] == 0).all()) and bool((want[differ] == 0).all())
    print(f"K2 parity, {label}: {tuple(got.shape)}, equal {torch.equal(got, want)}, bit patterns "
          f"that differ {n_diff} (all +-0: {zeros}); the twin bit-equal "
          f"{torch.equal(twin.view(torch.int32), want.view(torch.int32))}; elements by the row's "
          f"case {tally}", flush=True)
    check(torch.equal(got, want), f"K2 e_con differs from its plain version ({label})")
    check(zeros, f"K2's bit patterns differ from its plain version's off +-0 ({label})")
    check(torch.equal(twin.view(torch.int32), want.view(torch.int32)),
          f"K2's twin differs from the chain ({label})")
    tally["B"], tally["K"] = summ.shape[0], cb6.shape[1]
    tally["bits_differ"] = n_diff
    return tally


def k2_bound(rows: dict):
    """(bound ms, by, full-count ms) of one K2 launch from k2_check's tally:
    the operations of each element's case (a dead row none, a sign case
    CASED_FLOPS, the chain CHAIN_FLOPS, a fallback both) against the bytes
    (e_con written, the summaries and boxes read once). The full count: the
    chain on every element."""
    B, K = rows["B"], rows["K"]
    ops = (CASED_FLOPS * (rows["cased"] - rows["fallback"])
           + (CASED_FLOPS + CHAIN_FLOPS) * rows["fallback"] + CHAIN_FLOPS * rows["full"])
    b_ms, b_by = bound(float(ops), 4.0 * (B * K + 16 * B + 6 * K))
    return b_ms, b_by, bound(float(CHAIN_FLOPS) * B * K, 0.0)[0]


def k3_check(label, got, want):
    """K3 with the walk order against its plain version (refine_all_torch,
    walk_order): e_init bit-equal, worder and went equal up to each block's
    kcnt, kcnt equal."""
    import torch

    (e_init, worder, went, kcnt), (e_p, worder_p, went_p, kcnt_p) = got, want
    live = torch.arange(e_init.shape[1], device=e_init.device)[None, :] < kcnt_p[:, None].long()
    ok = (torch.equal(e_init, e_p) and torch.equal(kcnt, kcnt_p)
          and torch.equal(worder[live], worder_p[live]) and torch.equal(went[live], went_p[live]))
    print(f"K3 parity, {label}: {e_init.shape[0]} blocks x {e_init.shape[1]} clusters, e_init "
          f"finite {float(torch.isfinite(e_p).float().mean()):.4f}, walk length mean "
          f"{float(kcnt_p.float().mean()):.1f} (max {int(kcnt_p.max())}); e_init, kcnt and the "
          f"walk's prefix bit-equal: {ok}", flush=True)
    check(ok, f"K3 differs from refine_all_torch + walk_order ({label})")


def k3_work(e_con, kcnt, counts):
    """What one K3 launch's bound needs, as device tensors (no host read):
    (B, K, its counters summed [2], the walk's length, the 256-cluster
    tiles K2 leaves)."""
    import torch

    from akari_render_tpu_torch.accel import pairs

    B, K = e_con.shape
    nt = -(-K // pairs.RALL_TILE)
    con = torch.nn.functional.pad(e_con, (0, nt * pairs.RALL_TILE - K), value=float("inf"))
    live_tiles = torch.any(con.reshape(B, nt, pairs.RALL_TILE) < float("inf"), 2).sum()
    return B, K, counts.double().sum(0), kcnt.double().sum(), live_tiles


def k3_bound(B, K, counts, walk, live_tiles):
    """(bound ms, by, full-count ms) of one K3 launch (k3_work's
    arguments): K2's chain (CHAIN_FLOPS) per (cluster, warp) summary test
    and a slab test (SLAB_FLOPS) per lane of a unit run, from its counters,
    against the bytes (e_con read, e_init written, the lanes' 8 floats, the
    boxes, the walk's prefix). The full count: a slab test per lane x
    cluster of the 256-cluster tiles K2 leaves (what the earlier kernel
    ran)."""
    from akari_render_tpu_torch.accel import pairs

    nbytes = 4.0 * (2 * B * K + 8 * B * pairs.BLOCK + 6 * K + B) + 8.0 * float(walk)
    b_ms, b_by = bound(CHAIN_FLOPS * float(counts[0]) + SLAB_FLOPS * 32.0 * float(counts[1]),
                       nbytes)
    full = SLAB_FLOPS * float(live_tiles) * pairs.BLOCK * pairs.RALL_TILE
    return b_ms, b_by, bound(full, 0.0)[0]


def k3_render_sample(scene, device):
    """One sample of classroom at 1920x1080 (phase 9's main path, outside
    the CLI) with every K3 launch timed by CUDA events and the sort half's
    PyTorch chain (walk_order on the launch's e_init) timed beside it, the
    first two launches (camera rays, then their shadow rays) held against
    the plain version, bit-equal; and every K2 launch held against its plain
    chain (k2_check) and timed by its device record (torch.profiler over
    the sample, padded at both ends). Returns K3's and K2's means."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_sample

    task = RenderTask.from_file(CLASSROOM_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    real, rec = pairs.refine_walk, []
    real_k2, k2_rec = pairs.cull_einit, []

    def wrapped(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        counts = torch.zeros((a[4].shape[0], 2), dtype=torch.int32, device=a[4].device)
        ev[0].record()
        out = real(*a, counts=counts, **kw)
        ev[1].record()
        pairs.walk_order(out[0])
        ev[2].record()
        if len(rec) < 2:
            k3_check(f"launch {len(rec)} of a 1080p sample", out, pairs.refine_walk_torch(*a))
        rec.append((ev, k3_work(a[4], out[3], counts)))
        return out

    def cull(summ, cb6):
        out = real_k2(summ, cb6)
        k2_rec.append(k2_check(f"launch {len(k2_rec)} of a 1080p sample", out,
                               pairs.cull_einit_torch(summ, cb6), summ, cb6))
        return out

    pairs.refine_walk, pairs.cull_einit = wrapped, cull
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profiler_window()
            render_sample(scene, settings, filter_from_config(task.filter_config), 0, task.seed,
                          task.sampler)
            torch.cuda.synchronize()
            pad_profiler_window()
    finally:
        pairs.refine_walk, pairs.cull_einit = real, real_k2
    torch.cuda.synchronize()
    k3 = [e[0].elapsed_time(e[1]) for e, _ in rec]
    chain = [e[1].elapsed_time(e[2]) for e, _ in rec]
    bounds = [k3_bound(*w)[0] for _, w in rec]
    out = {"launches": len(rec), "ms": sum(k3) / len(k3), "ms_min": min(k3), "ms_max": max(k3),
           "library_ms": sum(chain) / len(chain), "bound_ms": sum(bounds) / len(bounds)}
    per = "; ".join(f"{t:.3f} ({int(w[2][0])}, {int(w[2][1])}, {int(w[3]) / w[0]:.0f})"
                    for t, (_, w) in zip(k3, rec))
    print(f"K3 in one 1080p sample ({len(rec)} launches): mean {out['ms']:.4f} ms (least "
          f"{out['ms_min']:.4f}, most {out['ms_max']:.4f}; mean bound {out['bound_ms']:.4f}); "
          f"walk_order's argsort chain on the same e_init, mean {out['library_ms']:.4f} ms a "
          f"launch; each launch's ms (summary tests, units run, mean walk): {per}", flush=True)
    dev = [d / 1e6 for _, d in sorted(
        (e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA and "cull_kernel" in e.name())]
    check(len(dev) >= len(k2_rec) // 2,
          f"the profiler recorded {len(dev)} of the sample's {len(k2_rec)} K2 launches")
    b2 = [k2_bound(r) for r in k2_rec]
    k2 = {"launches": len(k2_rec), "recorded": len(dev), "device_ms": sum(dev) / len(dev),
          "device_ms_min": min(dev), "device_ms_max": max(dev),
          "bound_ms": sum(b[0] for b in b2) / len(b2),
          "full_count_ms": sum(b[2] for b in b2) / len(b2),
          "bits_differ": sum(r["bits_differ"] for r in k2_rec),
          "rows": {k: sum(r[k] for r in k2_rec) for k in ("dead", "cased", "fallback", "full")}}
    per = "; ".join(f"{t:.4f} ({r['B']} blocks: dead {r['dead'] // r['K']}, sign cases "
                    f"{r['cased'] // r['K']}, chain {r['full'] // r['K']}; bound {b[0]:.4f})"
                    for t, r, b in zip(dev, k2_rec, b2))
    print(f"K2 in one 1080p sample ({len(k2_rec)} launches, {len(dev)} device records), each equal "
          f"to its plain chain: device time mean {k2['device_ms']:.4f} ms (least "
          f"{k2['device_ms_min']:.4f}, most {k2['device_ms_max']:.4f}; mean bound "
          f"{k2['bound_ms']:.4f}, the chain on every element {k2['full_count_ms']:.4f}); bit "
          f"patterns that differ {k2['bits_differ']}; each launch's device ms (rows by case; "
          f"bound): {per}", flush=True)
    return out, k2


def k5_work(args, counts, passed):
    """What one K5 launch's bound needs, as device tensors (no host read):
    (B, W, its counters summed [3]: members set, (member, warp) summary
    tests, units run; the blocks with a member set; the full count's slab
    tests: one for a member a lane passes, one per live lane for a member
    set that none passes)."""
    from akari_render_tpu_torch.accel import pairs

    _, win_i, ok, _, _, lim = args
    B, W = win_i.shape
    live = (lim[0] <= lim[1]).reshape(B, pairs.BLOCK).sum(1).double()
    fails = (ok & (passed == 0)).sum(1).double()
    full = passed.double().sum() + (fails * live).sum()
    return B, W, counts.double().sum(0), (counts[:, 0] > 0).sum(), full


def k5_bound(B, W, counts, blocks, full):
    """(bound ms, by, full-count ms) of one K5 launch (k5_work's
    arguments): K2's chain (CHAIN_FLOPS) per (member, warp) summary test
    and a slab test (SLAB_FLOPS) per lane of a unit run, from its counters,
    against the bytes (every member's flag and result, 5 B; the id and box
    of each member set, 28 B; the 8 floats of the lanes of each block with
    a member set). The full count: a slab test per slab test of k5_work's
    (every live lane against every member set, each member's lanes in turn
    up to the first that passes: no summary skip)."""
    from akari_render_tpu_torch.accel import pairs

    nbytes = 5.0 * B * W + 28.0 * float(counts[0]) + 32.0 * pairs.BLOCK * float(blocks)
    b_ms, b_by = bound(CHAIN_FLOPS * float(counts[1]) + SLAB_FLOPS * 32.0 * float(counts[2]),
                       nbytes)
    return b_ms, b_by, bound(SLAB_FLOPS * float(full), 0.0)[0]


class _TraversalDone(Exception):
    """Ends a render after its first traversals (k5_render_traversal)."""


def k5_render_traversal(scene, device, traversals: int = 3):
    """Every round of the first `traversals` traversals of one classroom
    1080p sample by the windowed walk (phase 18's route, outside the CLI:
    the camera rays, their shadow rays by any hit, the first bounce's
    rays): K5 with its counters, timed by CUDA events, against its plain
    version on the same window, bit-equal. Returns the rounds' numbers."""
    import torch

    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_sample

    task = RenderTask.from_file(CLASSROOM_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    real_k5, real_walk, rec, walks = pairs.refine_window, pairs.windowed_walk, [], []

    def k5(*a):
        counts = torch.zeros((a[1].shape[0], 3), dtype=torch.int32, device=a[1].device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_k5(*a, counts=counts)
        ev[1].record()
        want = pairs.refine_window_torch(*a)
        check(torch.equal(out, want),
              f"K5 differs from its plain version in round {len(rec)} of a 1080p traversal")
        rec.append((ev, k5_work(a, counts, out), int(out.sum())))
        return out

    def walk(*a, **kw):
        out = real_walk(*a, **kw)
        walks.append(len(rec))
        if len(walks) == traversals:
            raise _TraversalDone
        return out

    pairs.refine_window, pairs.windowed_walk = k5, walk
    try:
        with env_switch(AKR_PAIRS_STATIC="0"):
            render_sample(scene, settings, filter_from_config(task.filter_config), 0, task.seed,
                          task.sampler)
        fail(f"the windowed 1080p sample made fewer than {traversals} traversals")
    except _TraversalDone:
        pass
    finally:
        pairs.refine_window, pairs.windowed_walk = real_k5, real_walk
    torch.cuda.synchronize()
    ms = [e[0].elapsed_time(e[1]) for e, _, _ in rec]
    bounds = [k5_bound(*w) for _, w, _ in rec]
    per = "; ".join(f"{t:.4f} ({int(w[3])} blocks, {int(w[2][0])} members set, {n} passed, "
                    f"{int(w[2][1])} summary tests, {int(w[2][2])} units; bound {b[0]:.4f})"
                    for t, (_, w, n), b in zip(ms, rec, bounds))
    out = {"rounds": len(rec), "ms": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
           "bound_ms": sum(b[0] for b in bounds) / len(bounds),
           "full_count_ms": sum(b[2] for b in bounds) / len(bounds)}
    print(f"K5 on every round of the first {traversals} windowed traversals of a 1080p sample "
          f"({len(rec)} rounds; the traversals end after rounds {walks}), bit-equal to its plain "
          f"version on each: mean {out['ms']:.4f} ms (least "
          f"{out['ms_min']:.4f}, most {out['ms_max']:.4f}; mean bound {out['bound_ms']:.4f}, "
          f"full count {out['full_count_ms']:.4f}); each round's ms (live blocks, members set, "
          f"passed, summary tests, units run; bound): {per}", flush=True)
    return out


def classroom_rays(scene, cl, device):
    """2^18 rays over classroom: a quarter 1080p camera rays, a quarter
    from interior points in random directions, half shadow segments between
    interior points (flagged any hit); 2 % dead (tmax -1), 8 NaN lanes.
    Returns (o, d, tmin, tmax, shadow mask)."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.camera import generate_rays
    from akari_render_tpu_torch.core.math import RAY_TMAX

    rng = np.random.default_rng(11)
    n, q = N_RAYS, N_RAYS // 4
    cam = scene.camera
    pix = rng.choice(cam.width * cam.height, size=q, replace=False)
    p_film = np.stack([pix % cam.width, pix // cam.width], -1) + rng.random((q, 2))
    o_c, d_c = generate_rays(cam, torch.as_tensor(p_film, dtype=torch.float32, device=device))
    lo = cl.cbmin.amin(0).cpu().numpy()
    hi = cl.cbmax.amax(0).cpu().numpy()

    def interior(m):
        return lo + (hi - lo) * (0.1 + 0.8 * rng.random((m, 3)))

    o_r = interior(q)
    d_r = rng.normal(size=(q, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o_s, p_s = interior(2 * q), interior(2 * q)
    seg = np.linalg.norm(p_s - o_s, axis=-1)
    d_s = (p_s - o_s) / seg[:, None]
    tmax = np.concatenate([np.full(2 * q, RAY_TMAX), seg])
    tmax[rng.random(n) < 0.02] = -1.0
    o = np.concatenate([o_c.cpu().numpy(), o_r, o_s])
    o[rng.choice(n, 8, replace=False)] = np.nan
    d = np.concatenate([d_c.cpu().numpy(), d_r, d_s])
    shadow = np.arange(n) >= 2 * q

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return t(o), t(d), t(np.full(n, 1e-4)), t(tmax), t(shadow, torch.bool)


def pairs_parity(device):
    """Phase 7: K2, K3 and K4 against their plain versions at classroom's
    shapes, and the pair sweep against K1 over the flattened world soup.
    Returns the kernels' JSON entries and, for phase 16, the scene, its
    candidate list, the rays with their exclusion ids, their sorted blocks
    and the static pair sweep's hits."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.accel.flatten import flatten_scene
    from akari_render_tpu_torch.scene import load_scene
    from akari_render_tpu_torch.scenegraph.model import load_scene_json

    scene = load_scene(str(CLASSROOM), device=device)
    cl = scene.arrays.unified
    o, d, tmin, tmax, shadow = classroom_rays(scene, cl, device)
    n, K = o.shape[0], cl.num_clusters
    # exclusion ids: a quarter of the rays exclude their first hit, others a
    # random global virtual id
    first = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    rng = np.random.default_rng(12)
    n_ids = int(scene.arrays.instanced.tri_base[-1] + scene.arrays.instanced.tri_count[-1])
    ex0 = torch.where(torch.as_tensor(rng.random(n) < 0.25, device=device), first.tri_id, -1)
    ex1 = torch.as_tensor(np.where(rng.random(n) < 0.25, rng.integers(0, n_ids, n), -1),
                          dtype=torch.int32, device=device)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1)
    s_mask = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1, any_hit_mask=shadow)
    cb6 = pairs.cluster_bounds(cl)
    boxes = pairs.candidate_test_boxes(cl, cb6)  # as intersect_pairs gives them to the walk
    B = s.summ.shape[0]

    e_con = pairs.cull_einit(s.summ, cb6)
    e_con_p, plain_k2 = timed(lambda: pairs.cull_einit_torch(s.summ, cb6))
    k2_rows = k2_check("phase 7's rays", e_con, e_con_p, s.summ, cb6)
    k3_args = (cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    k3_counts = torch.zeros((B, 2), dtype=torch.int32, device=device)
    e_init, *k3_order = pairs.refine_walk(*k3_args, counts=k3_counts)
    k3_plain, plain_ms = timed(lambda: pairs.refine_walk_torch(*k3_args))
    plain_ms = {"K3": plain_ms}
    k3_check("phase 7's rays", (e_init, *k3_order), k3_plain)
    check(torch.equal(pairs.refine_walk(*k3_args)[0], e_init), "K3 with its counters differs")
    order = k3_plain[1:]  # whole rows: the plain walks read past kcnt
    walks = {}
    for mode, sr, any_hit in (("any hit", s, True), ("any_hit_mask", s_mask, False),
                              ("closest", s, False)):
        args = (*order, cl.tri_row, cl.tri, cl.xf, sr.o_soa, sr.d_soa, sr.lim, sr.ex, sr.best0,
                any_hit)
        got = pairs.sweep_walk(*args, boxes=boxes)
        want, plain_ms["K4"] = timed(lambda: pairs.sweep_walk_torch(*args))
        walks[mode] = (got, want)  # closest last: K4's plain time is its walk's
    torch.cuda.synchronize()
    errs = {"K2": max_abs_diff(e_con, e_con_p), "K3": max_abs_diff(e_init, k3_plain[0]),
            "K4": max(max_abs_diff(*w) for w in walks.values())}
    kcnt = order[2].float()
    print(f"pair parity at {n} rays ({B} blocks) x {K} clusters: e_con finite "
          f"{float(torch.isfinite(e_con).float().mean()):.4f}, e_init finite "
          f"{float(torch.isfinite(e_init).float().mean()):.4f} (walk length mean "
          f"{float(kcnt.mean()):.1f}, max {int(kcnt.max())}); max abs err K2 {errs['K2']} "
          f"K3 {errs['K3']} K4 {errs['K4']}", flush=True)
    for mode, (wk, wp) in walks.items():
        check(torch.equal(wk, wp), f"K4 walk ({mode}) differs from its plain version")
    hits = {m: int((w[0][1] >= 0).sum()) for m, w in walks.items()}
    print(f"K4 lanes with a hit: {hits}", flush=True)

    walk_args = (*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, False)
    any_args = (*walk_args[:-1], True)
    live_lanes = (s.lim[1] > s.lim[0]).reshape(B, pairs.BLOCK).sum(1).double()
    warps = pairs.BLOCK // 32
    C = cl.tri.shape[1]
    # of the closest-hit walk, which the bound counts: candidates reached and counters
    walked = torch.zeros(B, dtype=torch.int32, device=device)
    k4_stats = torch.zeros((B, 4), dtype=torch.int32, device=device)
    for mode, a, reached, stats in (("closest", walk_args, walked, k4_stats),
                                    ("any hit", any_args, torch.zeros_like(walked),
                                     torch.zeros_like(k4_stats))):
        counted = pairs.sweep_walk(*a, walked=reached, boxes=boxes, stats=stats)
        check(torch.equal(counted, walks[mode][0]),
              f"K4 with its counters ({mode}) differs from K4 without")
        print(f"K4 counters, {mode}: {counters_text(reached, stats, live_lanes, C, warps)}",
              flush=True)

    # K6: the first K6_M candidates of each block's closest-hit walk, with
    # JAX's dummy row (index R) for the ends of short walks
    R = cl.tri.shape[0]
    k6_m = 64
    worder, _, kcnt = order
    cand = worder[:, :k6_m].long()
    valid = torch.arange(cand.shape[1], device=device)[None, :] < kcnt[:, None].long()
    rows = cl.tri_row.long()[cand] if cl.tri_row is not None else cand
    tri_k6 = torch.cat([cl.tri, torch.zeros((1, C, 12), device=device)])
    xf_k6 = cl.xf if cl.xf is not None else torch.eye(4, device=device).reshape(1, 16)[:, :16]
    k6_args = (torch.where(valid, rows, R), cand if cl.xf is not None else torch.zeros_like(cand),
               s.o_soa, s.d_soa, s.lim, s.ex, tri_k6, xf_k6, s.best0, False)
    k6 = pairs.sweep(*k6_args)
    k6_p, plain_ms["K6"] = timed(lambda: pairs.sweep_torch(*k6_args))
    k6_stats = torch.zeros((B, 4), dtype=torch.int32, device=device)
    check(torch.equal(pairs.sweep(*k6_args, stats=k6_stats), k6),
          "K6 with its counters differs from K6 without")
    errs["K6"] = max_abs_diff(k6, k6_p)
    print(f"K6 (K4 kernel, early-out off) at {n} rays x {int(valid.sum())} candidates (the first "
          f"{k6_m} of each walk): lanes with a hit {int((k6[1] >= 0).sum())}, max abs err "
          f"{errs['K6']}", flush=True)
    check(torch.equal(k6, k6_p), "K6 differs from its plain version")

    # the plain K3, K4 and K6 times are those of their parity calls above
    k2_t = event_and_device_ms(lambda: pairs.cull_einit(s.summ, cb6), 20, "cull_kernel")
    ms = {
        "K2": (k2_t["ms"], plain_k2),
        "K3": (cuda_ms(lambda: pairs.refine_walk(*k3_args), 20), plain_ms["K3"]),
        "K4": (cuda_ms(lambda: pairs.sweep_walk(*walk_args, boxes=boxes), 5), plain_ms["K4"]),
        "K6": (cuda_ms(lambda: pairs.sweep(*k6_args), 5), plain_ms["K6"]),
    }
    # bounds: K2 writes e_con, with each row's case's operations (k2_bound);
    # K3 (k3_bound) runs K2's chain per (cluster, warp) summary tested and a
    # slab test per lane of a unit run, from its counters (its full count: a
    # slab test per lane x cluster of the 256-cluster tiles K2 leaves); K4
    # and K6 box-test each live lane against each candidate tested
    # (BOX_FLOPS), transform the ray of a lane queued for it (XF_FLOPS) and
    # test it against the slots the box test leaves it (MT_FLOPS +
    # SLOT_FLOPS each): needed_ops, from the counters; they read each lane's
    # 16 floats and write its 4. full_ms: the same with every live lane
    # against every slot (the count before the box test)
    table_bytes = cl.tri.numel() * 4 + (cl.xf.numel() * 4 if cl.xf is not None else 0)
    k3_b = k3_bound(*k3_work(e_con, k3_order[2], k3_counts))
    k2_b = k2_bound(k2_rows)
    bounds = {
        "K2": k2_b[:2],
        "K3": k3_b[:2],
        "K4": bound(needed_ops(walked, live_lanes, k4_stats, C),
                    80.0 * n + table_bytes + 8.0 * float(walked.sum())),
        "K6": bound(needed_ops(valid.sum(1), live_lanes, k6_stats, C), 80.0 * n + table_bytes),
    }
    full_ms = {"K2": k2_b[2], "K3": k3_b[2], "K4": bound(full_count_ops(walked, live_lanes, C), 0.0)[0],
               "K6": bound(full_count_ops(valid.sum(1), live_lanes, C), 0.0)[0]}
    library_ms = {"K3": cuda_ms(lambda: pairs.walk_order(e_init), 20)}
    kc = k3_counts.double().sum(0)
    print(f"K3 counters: (cluster, warp) summary tests {int(kc[0])} ({kc[0] / (B * K * 16):.4f} "
          f"of every cluster x warp), units of 32 lanes' slab tests run {int(kc[1])} "
          f"({kc[1] / max(kc[0], 1):.4f} of the tests); walk length mean "
          f"{float(k3_order[2].float().mean()):.1f}; the sort half's PyTorch chain (walk_order: "
          f"stable argsort, gather, count) {library_ms['K3']:.4f} ms", flush=True)
    print(f"K2 at classroom's shapes ({B} blocks x {K} clusters): {times_text(k2_t)}; bound "
          f"{k2_b[0]:.4f} ms by {k2_b[1]} (the full chain on every element {k2_b[2]:.4f} ms)",
          flush=True)
    print("pair kernel times at classroom's shapes (closest-hit walk for K4): " + ", ".join(
        f"{k} {a:.4f} ms (plain {b:.4f} ms, bound {bounds[k][0]:.4f} ms by {bounds[k][1]})"
        for k, (a, b) in ms.items()) + f"; K4 tested {int(walked.sum())} candidates "
        f"(mean {float(walked.float().mean()):.1f} per block, longest {int(walked.max())}); the "
        f"full count (every live lane x every slot) would bound K4 at {full_ms['K4']:.4f} ms, K6 "
        f"at {full_ms['K6']:.4f} ms; K6's counters: "
        f"{counters_text(valid.sum(1), k6_stats, live_lanes, C, warps)}", flush=True)
    ms_any = cuda_ms(lambda: pairs.sweep_walk(*any_args, boxes=boxes), 5)
    print(f"K4 any-hit walk {ms_any:.4f} ms", flush=True)

    # independent check: K1 over the fully flattened world soup
    sg = load_scene_json(str(CLASSROOM))
    soup, _, info = flatten_scene(sg)
    tris = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (soup.v0, soup.e1, soup.e2)]
    hk = k1.intersect_tris(o, d, tmin, tmax, *tris)
    hp = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    both = hk.valid & hp.valid
    rel_t = torch.abs(hk.t - hp.t) / torch.clamp(torch.abs(hk.t), min=1e-30)
    flag_mis = int((hk.valid != hp.valid).sum())
    t_far = both & (rel_t > PAIRS_T_REL)
    t_mis = int(t_far.sum())
    t_mis_inst = int((t_far & (hp.tri_id >= scene.num_tris)).sum())
    print(f"pair sweep vs K1 over the flattened soup ({len(soup.v0)} triangles): hits "
          f"{int(hp.valid.sum())} / {int(hk.valid.sum())}, hit-flag mismatches {flag_mis}, "
          f"t beyond rel {PAIRS_T_REL} on {t_mis} ({t_mis_inst} of them instanced hits of the "
          f"pair sweep), max rel t "
          f"{float(rel_t[both].max()) if bool(both.any()) else 0.0:.3g}", flush=True)
    same, gap, edge = explain_disagreements(o, d, tmin, tmax, hk, hp,
                                            (hk.valid != hp.valid) | t_far, scene, sg, soup, info)
    cross = ~same
    print(f"of the {len(same)} disagreements, {int(same.sum())} hit the same triangle (t gap at "
          f"most {float(gap[same].max()) if same.any() else 0.0:.3g} m) and {int(cross.sum())} "
          f"different surfaces (nearer triangle's edge at most "
          f"{float(np.abs(edge[cross]).max()) if cross.any() else 0.0:.3g} m from the ray)",
          flush=True)
    check(bool(np.all(gap[same] <= PAIRS_T_ABS)), "the pair sweep's t on K1's triangle is off")
    check(int(cross.sum()) <= PAIRS_K1_MAX, "the pair sweep and K1 hit different surfaces too often")
    check(bool(np.all(np.abs(edge[cross]) <= GRAZE_M)),
          "the pair sweep and K1 hit different surfaces on a ray that grazes no edge")

    names = {"K2": ("K2 pair-sweep conservative cull", 195),
             "K3": ("K3 pair-sweep per-ray refine", 333),
             "K4": ("K4 pair-sweep candidate walk", 544),
             "K6": ("K6 one-candidate sweep (K4 kernel, early-out off; on no main path)", 430)}
    entries = {k: {"name": names[k][0], "route": "cuda",
                   "source": "akari_render_tpu_torch/csrc/pairs.cu",
                   "replaces": f"akari_render_tpu/accel/pairs.py:{names[k][1]}",
                   "launches": 0, "max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1],
                   "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                   "library_ms": library_ms.get(k)}
               for k in names}
    entries["K3"]["name"] = "K3 pair-sweep per-ray refine with the walk order"
    entries["K2"]["event_ms"] = k2_t["event_ms"]
    entries["K2"]["bits_differ"], entries["K2"]["rows"] = k2_rows["bits_differ"], {
        k: k2_rows[k] for k in ("dead", "cased", "fallback", "full")}
    entries["K3"]["render_sample"], entries["K2"]["render_sample"] = k3_render_sample(scene,
                                                                                    device)
    for k, v in full_ms.items():
        entries[k]["full_count_ms"] = v
    return entries, {"scene": scene, "cl": cl, "rays": (o, d, tmin, tmax), "ex": (ex0, ex1),
                     "sorted": s, "e_con": e_con, "static_hits": hp}


class windowed_rounds:
    """For a block, collect the windowed walk's rounds: the list it yields
    receives each round's count of live blocks."""

    def __enter__(self):
        from akari_render_tpu_torch.accel import pairs

        self.real, rounds = pairs.windowed_walk, []
        pairs.windowed_walk = lambda *a, **k: self.real(*a, rounds=rounds, **k)
        return rounds

    def __exit__(self, *exc):
        from akari_render_tpu_torch.accel import pairs

        pairs.windowed_walk = self.real


class timed_walks:
    """For a block, time every launch of the pair sweep's refine and walk
    order (K3), its walk (K4), the windowed walk's window refine (K5) and
    of the wide walk (K7) with CUDA events (around the wrapper: its argument
    checks and the copy of `best` are inside), and keep what each launch's
    bound needs: K3's and K5's counters, the candidates, or nodes and
    leaves, each block reached, and its live lanes. summary() gives, per
    kernel, the launches, the mean, least and most milliseconds, the mean
    bound and the mean time the full count would take. K3's and K5's
    counters cost a few stores a block; K4's and K7's do not
    run inside a render, so their bound counts the bytes, K7's node steps
    and the box tests (a box test per live lane and candidate reached) and
    leaves out the slots inside the boxes: it lies under the kernels'
    line's kind of bound by their share."""

    def __enter__(self):
        import torch

        from akari_render_tpu_torch.accel import pairs, wide

        self.real = (pairs.sweep_walk, wide.wide_walk, pairs.refine_walk, pairs.refine_window)
        self.records, self.k3, self.k5 = [], [], []

        def refine_walk(*a, **kw):
            counts = torch.zeros((a[4].shape[0], 2), dtype=torch.int32, device=a[4].device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real[2](*a, counts=counts, **kw)
            end.record()
            # keep the bound's inputs, not the [B, K] e_con (the render's peak memory)
            self.k3.append((start, end, k3_work(a[4], out[3], counts)))
            return out

        def refine_window(*a, **kw):
            counts = torch.zeros((a[1].shape[0], 3), dtype=torch.int32, device=a[1].device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real[3](*a, counts=counts, **kw)
            end.record()
            self.k5.append((start, end, k5_work(a, counts, out)))
            return out

        def run(kernel, fn, args, kw, reached, lim, tables):
            B = reached.shape[0]
            live = (lim[1] > lim[0]).reshape(B, pairs.BLOCK).sum(1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.records.append((kernel, start, end, reached, live, tables))
            return out

        def sweep_walk(*a, **kw):
            reached = torch.zeros(a[0].shape[0], dtype=torch.int32, device=a[0].device)
            return run("K4", self.real[0], a, {**kw, "walked": reached}, reached, a[8], (a[4], a[5]))

        def wide_walk(*a, **kw):
            counts = torch.zeros((a[3].shape[1] // pairs.BLOCK, 2), dtype=torch.int32,
                                 device=a[3].device)
            return run("K7", self.real[1], a, {**kw, "counts": counts}, counts, a[5],
                       (a[1], a[2], a[0]))

        pairs.sweep_walk, wide.wide_walk, pairs.refine_walk, pairs.refine_window = (
            sweep_walk, wide_walk, refine_walk, refine_window)
        return self

    def __exit__(self, *exc):
        from akari_render_tpu_torch.accel import pairs, wide

        pairs.sweep_walk, wide.wide_walk, pairs.refine_walk, pairs.refine_window = self.real

    def summary(self) -> dict:
        import torch

        from akari_render_tpu_torch.accel import pairs

        torch.cuda.synchronize()
        out = {}
        for kernel, start, end, reached, live, tables in self.records:
            C = tables[0].shape[1]
            n = live.shape[0] * pairs.BLOCK
            nbytes = 80.0 * n + 4.0 * sum(t.numel() for t in tables if t is not None)
            if kernel == "K4":
                ops, full = box_test_ops(reached, live), full_count_ops(reached, live, C)
                nbytes += 8.0 * float(reached.sum())
            else:
                nodes = float((live.double() * reached[:, 0].double()).sum()) * K7_NODE_FLOPS
                ops = nodes + box_test_ops(reached[:, 1], live)
                full = nodes + full_count_ops(reached[:, 1], live, C)
            rec = out.setdefault(kernel, {"ms": [], "bound_ms": [], "full_count_ms": []})
            rec["ms"].append(start.elapsed_time(end))
            rec["bound_ms"].append(bound(ops, nbytes)[0])
            rec["full_count_ms"].append(bound(full, 0.0)[0])
        for kernel, runs, bound_fn in (("K3", self.k3, k3_bound), ("K5", self.k5, k5_bound)):
            for start, end, work in runs:
                b_ms, _, f_ms = bound_fn(*work)
                rec = out.setdefault(kernel, {"ms": [], "bound_ms": [], "full_count_ms": []})
                rec["ms"].append(start.elapsed_time(end))
                rec["bound_ms"].append(b_ms)
                rec["full_count_ms"].append(f_ms)

        def mean(x):
            return sum(x) / len(x)

        return {k: {"launches": len(v["ms"]), "ms": mean(v["ms"]), "ms_min": min(v["ms"]),
                    "ms_max": max(v["ms"]), "bound_ms": mean(v["bound_ms"]),
                    "full_count_ms": mean(v["full_count_ms"])} for k, v in out.items()}


# the cluster tier's traversals: the name the stats report -> its switch
TRAVERSALS = {"pairs-static": {}, "wide": {"AKR_WIDE": "1"},
              "pairs-windowed": {"AKR_PAIRS_STATIC": "0"}}


def classroom_correctness(device, traversal="pairs-static", base=None, label=None):
    """Phases 8, 17 and 26: classroom 96^2 16 spp through `traversal`
    against the committed JAX image and ground truth and, where given,
    against the default traversal's image `base` (`label` names a pass
    shape the caller switched on). Returns the image."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    label = traversal if label is None else f"{traversal}, {label}"
    out = OUT / f"classroom96_{label.replace(', ', '_').replace(' ', '_')}.exr"
    t0 = time.perf_counter()
    with env_switch(**TRAVERSALS[traversal]):
        stats = cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "--res", "96",
                          "--spp", "16", "-o", str(out), "--device", device])
    wall = time.perf_counter() - t0
    check(stats["traversal"] == traversal, f"classroom 96^2 took the {stats['traversal']} traversal")
    img = read_exr(out)
    jax16 = np.load(ROOT / "akari_render_tpu_torch" / "testdata" / "classroom96_spp16.npy")
    gt = read_exr(CLASSROOM_GT)
    check(img.shape == jax16.shape == gt.shape and bool(np.all(np.isfinite(img))),
          "classroom 96^2 image shape / finiteness")
    m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
    mse_port = float(np.mean((img - gt) ** 2))
    mse_jax = float(np.mean((jax16 - gt) ** 2))
    mse_pj = float(np.mean((img - jax16) ** 2))
    vs_base = "" if base is None else (f", max abs difference from the pairs-static image "
                                       f"{float(np.abs(img - base).max()):.3g}")
    print(f"classroom 96^2 16spp, {label} ({wall:.3f} s CLI wall): means port {m_port} jax "
          f"{m_jax} (max rel {mean_rel:.3g}); MSE(port, gt) {mse_port:.6g}, MSE(jax16, gt) "
          f"{mse_jax:.6g}, MSE(port, jax16) {mse_pj:.6g}{vs_base}", flush=True)
    check(mean_rel <= MEAN_TOL, "classroom channel means differ from the JAX image by more than 1%")
    check(mse_port <= MSE_RATIO * mse_jax, "classroom MSE against the ground truth too high")
    return img


def classroom_full_width(device, traversal="pairs-static"):
    """Phases 9 and 18: classroom 1920x1080 1 spp d12 through the CLI with
    `traversal`, every kernel's launches counted around it and every K3,
    K4, K5 and K7 launch timed. Returns the launch counts and timed_walks'
    summary."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / f"classroom1080_{traversal}.exr"
    out.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    with env_switch(**TRAVERSALS[traversal]), windowed_rounds() as rounds, timed_walks() as walks:
        reset_launches()
        t0 = time.perf_counter()
        stats = cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "-o", str(out),
                          "--device", device])
        wall = time.perf_counter() - t0
        launches = read_launches()
    check(stats["traversal"] == traversal, f"classroom 1080p took the {stats['traversal']} traversal")
    used = {"pairs-static": ("K2", "K3", "K4"), "wide": ("K7",),
            "pairs-windowed": ("K2", "K4", "K5")}[traversal]
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"):
        check((launches[k] > 0) == (k in used),
              f"classroom 1080p through {traversal} launched {k} {launches[k]} times")
    img = read_exr(out)
    check(img.shape == (1080, 1920, 3) and bool(np.all(np.isfinite(img))),
          "1080p image shape / finiteness")
    paths = 1920 * 1080
    peak = torch.cuda.max_memory_allocated()
    walk = (f", {len(rounds)} rounds of the windowed walk in {launches['K2']} traversals (a host "
            f"read each; {sum(rounds)} live blocks in all)") if traversal == "pairs-windowed" else ""
    print(f"classroom 1920x1080 1spp d12, {traversal}: render {stats['total_time']:.3f} s "
          f"({paths / stats['total_time'] / 1e6:.4f} Mpaths/s), CLI wall {wall:.3f} s, "
          f"launches and counts {launches}{walk}, peak device memory {peak / 2**30:.3f} GiB "
          f"({peak / paths:.0f} B per lane), image mean {img.mean(axis=(0, 1))}", flush=True)
    timings = walks.summary()
    for k, v in timings.items():
        check(v["launches"] == launches[k], f"{k}: {v['launches']} launches timed of {launches[k]}")
        what = ("its counters and bytes" if k in ("K3", "K5")
                else "bytes, node steps and box tests")
        print(f"{k} at this render's own shapes (CUDA events around each of its {v['launches']} "
              f"launches): mean {v['ms']:.4f} ms, least {v['ms_min']:.4f}, most {v['ms_max']:.4f}; "
              f"mean bound ({what}) {v['bound_ms']:.4f} ms; the full count would take "
              f"{v['full_count_ms']:.4f} ms", flush=True)
    return launches, timings


def other_traversals_parity(ctx, device):
    """Phase 16: K7 (the wide walk) and K5 (the window refine) against
    their plain versions on phase 7's classroom rays, and both traversals
    against the static pair sweep. Returns the two kernels' JSON entries."""
    import torch

    from akari_render_tpu_torch.accel import pairs, wide

    cl, (o, d, tmin, tmax), (ex0, ex1) = ctx["cl"], ctx["rays"], ctx["ex"]
    hp = ctx["static_hits"]
    n, K, C = o.shape[0], cl.num_clusters, cl.tri.shape[1]
    sw = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1, dead_last=False)
    B = sw.summ.shape[0]

    boxes = pairs.candidate_test_boxes(cl, pairs.cluster_bounds(cl))  # as intersect_wide's

    def walk_args(any_hit):
        return (cl.wide, cl.tri, cl.xf, sw.o_soa, sw.d_soa, sw.lim, sw.ex, sw.best0, any_hit)

    # closest hit (exclusion ids, cut tmax) against the plain rounds on every
    # block. Any hit: the plain version at one leaf a round, counts and all,
    # takes as many rounds as the longest walk has steps (20-28 s on all
    # blocks), so it runs on a quarter of the blocks: every fourth by walk
    # length, the longest among them, whose walks go through the deepest
    # stacks and the most prefetched and dropped leaves (a block's walk does
    # not depend on the others); the kernel's run on all blocks must
    # repeat its run on those, and its occlusion is held against the static
    # sweep's any hit on every ray
    counts = torch.zeros((B, 2), dtype=torch.int32, device=device)
    got = wide.wide_walk(*walk_args(False), counts=counts, boxes=boxes)
    want, plain_ms = timed(lambda: wide.wide_walk_torch(*walk_args(False)))
    counts_any = torch.zeros((B, 2), dtype=torch.int32, device=device)
    got_any = wide.wide_walk(*walk_args(True), counts=counts_any, boxes=boxes)
    by_steps = torch.argsort(counts_any.sum(dim=1), stable=True)
    fourth = torch.sort(by_steps[3::4]).values
    lanes4 = (fourth[:, None] * pairs.BLOCK
              + torch.arange(pairs.BLOCK, device=device)[None, :]).reshape(-1)
    args4 = (cl.wide, cl.tri, cl.xf, *(x[:, lanes4].contiguous() for x in walk_args(True)[3:8]),
             True)
    counts4 = torch.zeros((len(fourth), 2), dtype=torch.int32, device=device)
    counts4_p = torch.zeros_like(counts4)
    got4 = wide.wide_walk(*args4, counts=counts4, boxes=boxes)
    want4, plain_ms_any = timed(lambda: wide.wide_walk_torch(*args4, maxc=1, counts=counts4_p))
    err_k7 = max(max_abs_diff(got, want), max_abs_diff(got4, want4))
    print(f"K7 parity at {n} rays ({B} blocks) x {K} candidates ({cl.wide.shape[0]} nodes): "
          f"closest hit, lanes with a hit {int((got[1] >= 0).sum())}, nodes expanded "
          f"{int(counts[:, 0].sum())} (max {int(counts[:, 0].max())} a block), leaves tested "
          f"{int(counts[:, 1].sum())} (max {int(counts[:, 1].max())}); any hit, lanes occluded "
          f"{int((got_any[1] >= 0).sum())}, nodes {int(counts_any[:, 0].sum())}, leaves "
          f"{int(counts_any[:, 1].sum())} (against the plain version on {len(fourth)} blocks: "
          f"lanes occluded {int((got4[1] >= 0).sum())}, leaves {int(counts4[:, 1].sum())}); max abs "
          f"err {err_k7}", flush=True)
    check(torch.equal(got, want), "K7 (closest hit) differs from its plain version")
    check(torch.equal(got4, want4), "K7 (any hit) differs from its plain version")
    check(torch.equal(counts4, counts4_p),
          "K7's nodes expanded / leaves tested differ from the plain version's at one leaf a round")
    check(torch.equal(got_any[:, lanes4], got4) and torch.equal(counts_any[fourth], counts4),
          "K7 (any hit) on all blocks differs from its run on a quarter of them")
    occ = {fn.__name__: fn(cl, o, d, tmin, tmax, ex0, ex1, any_hit=True)
           for fn in (wide.intersect_wide, pairs.intersect_pairs)}
    print(f"any hit, wide walk vs the static pair sweep: occluded "
          f"{int(occ['intersect_wide'].sum())} / {int(occ['intersect_pairs'].sum())}", flush=True)
    check(torch.equal(occ["intersect_wide"], occ["intersect_pairs"]),
          "the wide walk's any hit differs from the static pair sweep's")

    # both traversals against the static pair sweep, no exclusions
    hw = wide.intersect_wide(cl, o, d, tmin, tmax)
    with env_switch(AKR_PAIRS_STATIC="0"), windowed_rounds() as rounds:
        hwin = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    for name, h in (("wide walk", hw), ("windowed walk", hwin)):
        id_mis = hp.valid & (h.tri_id != hp.tri_id)
        print(f"{name} vs the static pair sweep: hits {int(h.valid.sum())} / "
              f"{int(hp.valid.sum())}, valid equal {torch.equal(h.valid, hp.valid)}, t bit-equal "
              f"{torch.equal(h.t, hp.t)}, ids differ on {int(id_mis.sum())} rays (exact t ties "
              f"between two candidates)" + (f"; {len(rounds)} rounds" if h is hwin else ""),
              flush=True)
        check(torch.equal(h.valid, hp.valid) and torch.equal(h.t, hp.t),
              f"the {name}'s valid or t differs from the static pair sweep's")
        check(bool(torch.equal(h.bary[~id_mis], hp.bary[~id_mis])),
              f"the {name}'s u, v differ from the static pair sweep's on the same triangle")
    check(torch.equal(hwin.tri_id, hp.tri_id), "the windowed walk's ids differ from the static walk's")

    # K5 on the first round's window of the windowed traversal of phase 7's
    # sorted blocks (exclusion ids do not reach it)
    s7, calls, real_k5 = ctx["sorted"], [], pairs.refine_window

    def capture(*args):
        if not calls:
            calls.append(tuple(a.clone() for a in args))
        return real_k5(*args)

    pairs.refine_window = capture
    try:
        pairs.windowed_walk(cl, s7, ctx["e_con"], False)
    finally:
        pairs.refine_window = real_k5
    check(len(calls) == 1, "the windowed walk made no K5 call")
    k5_args = calls[0]
    W = k5_args[1].shape[1]
    k5_counts = torch.zeros((B, 3), dtype=torch.int32, device=device)
    passed = pairs.refine_window(*k5_args, counts=k5_counts)
    passed_p, plain_ms_k5 = timed(lambda: pairs.refine_window_torch(*k5_args))
    err_k5 = max_abs_diff(passed.float(), passed_p.float())
    kc = k5_counts.double().sum(0)
    print(f"K5 parity on the first window of the windowed walk ({B} blocks x {W} members, "
          f"{int(kc[0])} set): members that pass {int(passed.sum())}; (member, warp) summary "
          f"tests {int(kc[1])}, units of 32 slab tests run {int(kc[2])}; max abs err {err_k5}",
          flush=True)
    check(W == pairs.MAXC * pairs.WINDOW_MULT, "K5's window shape")
    check(torch.equal(passed, passed_p), "K5 differs from its plain version")
    check(torch.equal(pairs.refine_window(*k5_args), passed), "K5 with its counters differs")
    k5_rounds = k5_render_traversal(ctx["scene"], device)

    ms_k7 = cuda_ms(lambda: wide.wide_walk(*walk_args(False), boxes=boxes), 5)
    ms_k7_any = cuda_ms(lambda: wide.wide_walk(*walk_args(True), boxes=boxes), 5)
    k7_stats = k7_probe(walk_args, boxes, got, got_any, counts, counts_any, ms_k7, device)
    k5_t = event_and_device_ms(lambda: pairs.refine_window(*k5_args), 20, "window_refine_kernel")
    # bounds. K7: per live lane 8 slab tests (K7_NODE_FLOPS) a node
    # expanded and, a leaf tested, what the candidate test needs
    # (needed_ops, from the closest-hit walk's counters); the full count
    # takes every live lane against every slot of every leaf tested
    # instead; it reads each lane's 16 floats, the node table and the
    # triangle and transform tables once, and writes 4 floats a lane. K5:
    # k5_bound, from its counters.
    live_w = (sw.lim[1] > sw.lim[0]).reshape(B, pairs.BLOCK).sum(1).double()
    table_bytes = (cl.tri.numel() + cl.wide.numel()
                   + (cl.xf.numel() if cl.xf is not None else 0)) * 4
    ops_nodes = float((live_w * counts[:, 0].double()).sum()) * K7_NODE_FLOPS
    ops_k7 = ops_nodes + needed_ops(counts[:, 1], live_w, k7_stats, C)
    b_k7 = bound(ops_k7, 80.0 * n + table_bytes)
    full_ms_k7 = bound(ops_nodes + full_count_ops(counts[:, 1], live_w, C), 0.0)[0]
    b_k5 = k5_bound(*k5_work(k5_args, k5_counts, passed))
    print(f"K7 at classroom's shapes: closest hit {ms_k7:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{b_k7[0]:.4f} ms by {b_k7[1]}: {ops_k7:.4g} FP32 operations, {ops_nodes:.4g} of them "
          f"in node steps; the full count would take {full_ms_k7:.4f} ms), any hit {ms_k7_any:.4f} "
          f"ms (plain, one leaf a round, on a quarter of the blocks {plain_ms_any:.4f} ms); K5 "
          f"{times_text(k5_t)} (plain {plain_ms_k5:.4f} ms, bound {b_k5[0]:.4f} ms by "
          f"{b_k5[1]}; the full count would take {b_k5[2]:.4f} ms)", flush=True)
    common = {"route": "cuda", "launches": 0, "library_ms": None}
    return {
        "K5": {"name": "K5 windowed walk's window refine",
               "source": "akari_render_tpu_torch/csrc/pairs.cu",
               "replaces": "akari_render_tpu/accel/pairs.py:267", "max_abs_err": err_k5,
               "ms": k5_t["ms"], "event_ms": k5_t["event_ms"], "plain_ms": plain_ms_k5,
               "bound_ms": b_k5[0], "bound_by": b_k5[1], "full_count_ms": b_k5[2],
               "render_traversal": k5_rounds, **common},
        "K7": {"name": "K7 wide-BVH walk (with the leaf test)",
               "source": "akari_render_tpu_torch/csrc/wide.cu",
               "replaces": "akari_render_tpu/accel/wide.py:187", "max_abs_err": err_k7,
               "ms": ms_k7, "plain_ms": plain_ms, "bound_ms": b_k7[0], "bound_by": b_k7[1],
               "full_count_ms": full_ms_k7, **common},
    }


def k7_probe(walk_args, boxes, got, got_any, counts, counts_any, ms_k7, device):
    """K7's measuring form on phase 16's rays: the counters of its leaves'
    candidate tests, and its time split between node steps and leaves, two
    ways: thread 0's clock cycles inside the kernel at the real walk, and
    the time of a walk with the leaf test off (the walk of the rays' first
    limits: more nodes), which prices a node step. Returns the closest-hit
    walk's counters [B, 4]."""
    import torch

    from akari_render_tpu_torch.accel import pairs, wide

    B, C = counts.shape[0], walk_args(False)[1].shape[1]
    lim = walk_args(False)[5]
    live = (lim[1] > lim[0]).reshape(B, pairs.BLOCK).sum(1).double()

    def probe(**kw):
        return {"stats": torch.zeros((B, 4), dtype=torch.int32, device=device),
                "cycles": torch.zeros((B, 2), dtype=torch.int64, device=device), **kw}

    closest_stats = None
    for mode, any_hit, want, want_counts in (("closest hit", False, got, counts),
                                             ("any hit", True, got_any, counts_any)):
        pr, ck = probe(), torch.zeros_like(counts)
        if closest_stats is None:
            closest_stats = pr["stats"]
        out = wide.wide_walk(*walk_args(any_hit), counts=ck, boxes=boxes, probe=pr)
        check(torch.equal(out, want) and torch.equal(ck, want_counts),
              f"K7's measuring form ({mode}) differs from K7")
        cyc = pr["cycles"].double().sum(0)
        print(f"K7 counters, {mode}: "
              f"{counters_text(ck[:, 1], pr['stats'], live, C, pairs.BLOCK // 32)}; clock cycles "
              f"in node steps {cyc[0]:.4g} ({cyc[0] / cyc.sum():.4f} of the walk's), in leaves "
              f"{cyc[1]:.4g}; per node expanded {cyc[0] / float(ck[:, 0].sum()):.1f}, per leaf "
              f"{cyc[1] / float(ck[:, 1].sum()):.1f}", flush=True)
    off, c_off = probe(leaf_test=False), torch.zeros_like(counts)
    untouched = wide.wide_walk(*walk_args(False), counts=c_off, boxes=boxes, probe=off)
    check(torch.equal(untouched, walk_args(False)[7]), "K7 with the leaf test off changed a hit")
    ms_off = cuda_ms(lambda: wide.wide_walk(*walk_args(False), boxes=boxes,
                                            probe=probe(leaf_test=False)), 5)
    ms_probe = cuda_ms(lambda: wide.wide_walk(*walk_args(False), boxes=boxes, probe=probe()), 5)
    nodes_off, nodes = int(c_off[:, 0].sum()), int(counts[:, 0].sum())
    print(f"K7 with the leaf test off: {ms_off:.4f} ms for {nodes_off} nodes expanded and "
          f"{int(c_off[:, 1].sum())} leaves popped ({ms_off / nodes_off * 1e6:.2f} ns a node over "
          f"all blocks); at that price the real walk's {nodes} nodes take "
          f"{ms_off * nodes / nodes_off:.4f} of K7's {ms_k7:.4f} ms "
          f"({ms_off * nodes / nodes_off / ms_k7:.4f}); the measuring form with the leaf test on "
          f"{ms_probe:.4f} ms", flush=True)
    return closest_stats


def blinds_setup(device):
    """(scene, task, PTSettings, filter) of blinds at its own 256x256 with
    scenes/blinds/pt.json."""
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.scene import load_scene

    task = RenderTask.from_file(BLINDS_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    scene = load_scene(str(BLINDS), device=device)
    return scene, task, settings, filter_from_config(task.filter_config)


def path_b_bounce(device):
    """The arguments of K9's first call in one path-B sample of blinds at
    its own 256x256 with scenes/blinds/pt.json, as the main path hands them
    to fused_shade: the whole wavefront of the first bounce, and its live
    mask."""
    import torch

    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators.pt import render_sample

    scene, task, settings, filt = blinds_setup(device)
    real, calls = common.fused_shade, []

    def capture(*args, live=None):
        if not calls:
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                          live.clone()))
        return real(*args, live=live)

    common.fused_shade = capture
    try:
        with env_switch(AKR_PALLAS_SHADE="1"):
            render_sample(scene, settings, filt, 0, task.seed, task.sampler)
    finally:
        common.fused_shade = real
    check(len(calls) == 1, "a path-B sample of blinds made no K9 call")
    return calls[0]


def k9_bound(lanes: int, live: int, table_numel: int):
    """(bound ms, by) of one K9 launch over `lanes` lanes, `live` of them
    live: the bytes (a live lane's 104 B in and 53 B out, a dead lane's
    53 B of zeros, a flag a lane, the material table once) against the
    closure's FP32 operations a live lane (K9_LIVE_FLOPS)."""
    return bound(float(K9_LIVE_FLOPS) * live,
                 157.0 * live + 53.0 * (lanes - live) + lanes + 4.0 * table_numel)


def k9_check(label: str, args, live=None) -> dict:
    """K9 against its plain version on one set of fused_shade arguments
    (with `live`, the masked call over the whole wavefront against the
    masked plain version), with the lanes bit-equal on every output, CUDA
    event and device timings; returns its numbers for the JSON line."""
    import torch

    from akari_render_tpu_torch.integrators import fused_shade as fs

    lanes = args[1].shape[0]
    n_live = lanes if live is None else int(live.sum())
    got = fs.fused_shade(*args, live=live)
    want = fs.fused_shade_torch(*args, live=live)
    torch.cuda.synchronize()
    same = got["valid"] == want["valid"]
    valid_mis = int((~same).sum())
    max_abs, max_rel = 0.0, 0.0
    bit_equal = same.clone()
    for k in ("direct", "wi", "f", "pdf", "albedo"):
        g, w = got[k], want[k]
        eq = (g.view(torch.int32) == w.view(torch.int32)).reshape(lanes, -1).all(1)
        bit_equal &= eq
        if k in ("wi", "f", "pdf"):  # a flipped sample draws another direction
            g, w = g[same], w[same]
        max_abs = max(max_abs, max_abs_diff(g, w))
        diff = torch.where(g == w, 0.0, torch.abs(g - w) / torch.clamp(torch.abs(w), min=1e-30))
        max_rel = max(max_rel, float(torch.nan_to_num(diff, nan=float("inf")).max()))
    call = (lambda: fs.fused_shade(*args)) if live is None else (
        lambda: fs.fused_shade(*args, live=live))
    # device time whatever the events read: around a call of this short
    # kernel they measure the host (0.06-0.27 ms a call on an H100 host)
    ev = cuda_ms(call, 20)
    dev = device_ms(call, 20, "fused_shade_kernel")
    t = {"ms": dev, "event_ms": ev, "device_ms": dev}
    plain_ms = cuda_ms(lambda: fs.fused_shade_torch(*args, live=live), 3)
    bound_ms, bound_by = k9_bound(lanes, n_live, args[0][0].numel())
    print(f"K9 parity on {label} ({lanes} lanes, {n_live} live): valid "
          f"{float(want['valid'].float().mean()):.4f}, valid mismatches {valid_mis}, lanes "
          f"bit-equal on every output {int(bit_equal.sum())} of {lanes}, max rel err "
          f"{max_rel:.3g}, max abs err {max_abs:.3g}; kernel {times_text(t)} (plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms by {bound_by})", flush=True)
    check(valid_mis <= K9_VALID_FRAC * lanes, f"K9 valid differs on {valid_mis} lanes")
    check(max_rel <= K9_REL, f"K9 disagrees with its plain version on {label}")
    if live is not None:
        dead = ~live
        check(all(not bool(got[k][dead].any()) for k in got), f"K9 wrote a dead lane ({label})")
    return {"max_abs_err": max_abs, "ms": t["ms"], "event_ms": t["event_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "lanes": lanes, "live": n_live, "bit_equal_lanes": int(bit_equal.sum())}


def k9_sample_launches(device) -> dict:
    """Every K9 launch of one path-B sample of blinds at 256^2: its lanes,
    live lanes, device time (torch.profiler over the sample, padded at both
    ends) and bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators.pt import render_sample

    scene, task, settings, filt = blinds_setup(device)
    real, calls = common.fused_shade, []

    def count(*args, live=None):
        calls.append((args[1].shape[0], live))
        return real(*args, live=live)

    common.fused_shade = count
    try:
        with env_switch(AKR_PALLAS_SHADE="1"), profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profiler_window()
            render_sample(scene, settings, filt, 0, task.seed, task.sampler)
            torch.cuda.synchronize()
            pad_profiler_window()
    finally:
        common.fused_shade = real
    dev = [d / 1e6 for _, d in sorted(
        (e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA and "fused_shade_kernel" in e.name())]
    check(len(dev) >= len(calls) // 2,
          f"the profiler recorded {len(dev)} of the sample's {len(calls)} K9 launches")
    live = [int(v.sum()) for _, v in calls]
    bounds = [k9_bound(n, lv, scene.shade_bake[0].numel())[0] for (n, _), lv in zip(calls, live)]
    per = "; ".join(f"{n} lanes, {lv} live: {t:.4f} ms (bound {b:.4f})"
                    for (n, _), lv, t, b in zip(calls, live, dev, bounds))
    out = {"launches": len(calls), "recorded": len(dev), "device_ms": sum(dev) / len(dev),
           "device_ms_sum": sum(dev), "bound_ms": sum(bounds) / len(bounds),
           "live": live}
    print(f"K9 in one path-B sample of blinds 256^2 ({len(calls)} launches, {len(dev)} device "
          f"records): device time mean {out['device_ms']:.4f} ms, sum {out['device_ms_sum']:.4f} "
          f"(mean bound {out['bound_ms']:.4f}); each launch: {per}", flush=True)
    return out


def k9_parity(device):
    """Phase 11: K9 against its plain version on the first bounce of a real
    path-B sample at 256^2: masked over the whole wavefront, and unmasked on
    its live lanes compacted; on 2^18 seeded blinds shade inputs; the
    bounce loop's shade call as one device event (torch.profiler); and every
    K9 launch of one path-B sample. Returns the kernel's JSON entry, timed
    on the masked wavefront."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.integrators import common

    scene, _, _, _ = blinds_setup(device)
    check(scene.shade_bake is not None, "blinds must bake into the reduced closure")
    n = N_RAYS
    rng = np.random.default_rng(13)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    def unit():
        v = rng.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=-1, keepdims=True))

    si = scene.surface_interaction(t(rng.integers(0, scene.num_tris, n), torch.int64),
                                   t(rng.random((n, 2)) * 0.45))
    synthetic = (scene.shade_bake, *(f.contiguous() for f in si["frame"]), si["ng"].contiguous(),
                 unit(), unit(), t(rng.random((n, 3)) * 3.0), t(rng.random(n) * 2.0 + 1e-3),
                 t(rng.random((n, 3))), si["mat"])
    args, live = path_b_bounce(device)
    main = k9_check("the wavefront of a path-B bounce at 256^2, masked", args, live)
    rows = torch.nonzero(live).squeeze(1)
    compact = (args[0], *(x[rows] for x in args[1:]))
    main["compacted"] = k9_check("the live lanes of that bounce, compacted", compact)
    main["seeded"] = k9_check("seeded blinds inputs", synthetic)
    main["max_abs_err"] = max(main["max_abs_err"], main["compacted"]["max_abs_err"],
                              main["seeded"]["max_abs_err"])
    si_b = {"frame": args[1:4], "ng": args[4], "mat": args[10]}
    extra = dict(zip(("wo", "ls_wi", "ls_li", "ls_pdf", "u_bsdf"), args[5:10]))
    events = device_events_per_call(
        {"K9 call": lambda: common._fused_shade_live(args[0], si_b, extra, live)})
    print(f"the bounce loop's shade call (_fused_shade_live) on that wavefront: "
          f"{events['K9 call']} device events", flush=True)
    check(events["K9 call"] == 1, "the bounce loop's shade call must be one device launch")
    main["sample"] = k9_sample_launches(device)
    return {"name": "K9 fused shade", "route": "cuda",
            "source": "akari_render_tpu_torch/csrc/fused_shade.cu",
            "replaces": "akari_render_tpu/integrators/pallas_shade.py:85", **main,
            "library_ms": None}


def k8_parity(device):
    """Phase 12: one K8 pass of the main path (blinds 256^2, 16 spp, d12)
    against its plain version, bit-equal per pixel and on the rays each
    traced, with
    the time of each, and the SIMT efficiency of its warps' loop (the
    kernel's counters, which must equal the plain version's count from its
    paths): as it runs, with path regeneration, and as it would run with
    the samples in lockstep, the loop of the kernel before regeneration.
    Returns the kernel's JSON entry."""
    import torch

    from akari_render_tpu_torch.integrators import megakernel as mk

    scene, task, settings, filt = blinds_setup(device)
    check(mk.megakernel_eligible(scene, settings, task.sampler, filt),
          "blinds must be megakernel-eligible")
    tb = mk.pass_tables(scene, settings, filt, task.seed)
    spp = task.method.spp_per_pass
    rk, rp = (torch.zeros(2, dtype=torch.int64, device=device) for _ in range(2))
    sk, sp = (torch.zeros(5, dtype=torch.int64, device=device) for _ in range(2))
    got = mk.megakernel_pass(tb, 0, spp, rk, sk)
    want, plain_ms = timed(lambda: mk.megakernel_pass_torch(tb, 0, spp, rp, sp))
    max_abs = max_abs_diff(got, want)
    n_diff = int((got != want).any(0).sum())
    print(f"K8 parity at {tb.width}^2 {spp} spp d{tb.max_depth}: pixels that differ from the "
          f"plain version {n_diff}, max abs err {max_abs:.3g}; rays traced kernel {rk.tolist()} "
          f"plain {rp.tolist()} (closest, shadow)", flush=True)
    ran, used, lockstep, most, most_lockstep = sk.tolist()
    simt = {"iterations_ran": ran, "lane_iterations": used, "lockstep_iterations": lockstep,
            "efficiency": used / (32 * ran), "lockstep_efficiency": used / (32 * lockstep),
            "slowest_warp": most, "slowest_warp_lockstep": most_lockstep}
    print(f"K8 SIMT efficiency (lane iterations used / 32 x warp iterations run; one iteration a "
          f"closest-hit ray): {simt['efficiency']:.4f} with path regeneration ({ran} warp "
          f"iterations, the slowest warp {most}), {simt['lockstep_efficiency']:.4f} with the "
          f"samples in lockstep ({lockstep}, the slowest warp {most_lockstep}); {used} lane "
          f"iterations; kernel counters {sk.tolist()}, plain {sp.tolist()}", flush=True)
    check(bool(torch.isfinite(got).all()), "K8 output not finite")
    check(torch.equal(got, want), "K8 differs from its plain version (bit for bit, per pixel)")
    check(torch.equal(rk, rp), "K8 and its plain version traced different numbers of rays")
    check(torch.equal(sk, sp), "K8's SIMT counters differ from the plain version's count")
    check(torch.equal(mk.megakernel_pass(tb, 0, spp), got), "K8 with its counters differs")

    ms = cuda_ms(lambda: mk.megakernel_pass(tb, 0, spp), 10)
    n_rays = int(rk.sum())
    T = scene.num_tris
    ops = float(n_rays) * T * K8_TRI_FLOPS
    table_bytes = sum(x.numel() * 4 for x in (tb.attr, tb.ce, tb.lsel, tb.loff, tb.ltab, tb.mat))
    bound_ms, bound_by = bound(ops, table_bytes + 16.0 * tb.npix)
    print(f"K8 at {tb.width}^2, {spp} spp, d{tb.max_depth}: {ms:.4f} ms per pass (plain "
          f"{plain_ms:.4f} ms, the parity call); {n_rays} rays traced x {T} triangles x "
          f"{K8_TRI_FLOPS} = {ops:.4g} FP32 operations: bound {bound_ms:.4f} ms by {bound_by}",
          flush=True)
    return {"name": "K8 path megakernel", "route": "cuda",
            "source": "akari_render_tpu_torch/csrc/megakernel.cu",
            "replaces": "akari_render_tpu/integrators/megakernel.py:445",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "simt": simt}


class env_switch:
    """Set environment switches for a block (None unsets one), then restore
    them."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        import os

        self.old = {k: os.environ.get(k) for k in self.kv}
        for k, v in self.kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        import os

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the two fused paths: (name, switch, shade the CLI reports, JAX image of its tier)
FUSED_PATHS = (("path A", "AKR_MEGAKERNEL", "megakernel (K8)", "blinds64_mk_spp16.npy"),
               ("path B", "AKR_PALLAS_SHADE", "fused (K9)", "blinds64_spp16.npy"))


def blinds_correctness(device):
    """Phase 13: paths A and B at 64^2, 16 spp through the CLI against the
    committed JAX images of their tiers and the JAX 256-spp image."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    gt = np.load(testdata / "blinds64_spp256.npy")
    for name, switch, shade, ref in FUSED_PATHS:
        out = OUT / f"blinds64_{name[-1]}.exr"
        with env_switch(**{switch: "1"}):
            stats = cli_main(["-s", str(BLINDS), "-m", str(BLINDS_METHOD), "--res", "64",
                              "--spp", "16", "-o", str(out), "--device", device])
        check(stats["shade"] == shade, f"{name} took the {stats['shade']} shade")
        img = read_exr(out)
        jax16 = np.load(testdata / ref)
        check(img.shape == jax16.shape == gt.shape and bool(np.all(np.isfinite(img))),
              f"blinds 64^2 {name} image shape / finiteness")
        m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
        mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
        mse_port = float(np.mean((img - gt) ** 2))
        mse_jax = float(np.mean((jax16 - gt) ** 2))
        print(f"blinds 64^2 16spp {name} ({stats['tier']}, {shade}): means port {m_port} jax "
              f"{m_jax} (max rel {mean_rel:.3g}); MSE(port, jax256) {mse_port:.6g}, MSE(jax16, "
              f"jax256) {mse_jax:.6g}, MSE(port, jax16) {float(np.mean((img - jax16) ** 2)):.6g}",
              flush=True)
        check(mean_rel <= MEAN_TOL, f"blinds {name} means differ from the JAX image by more than 1%")
        check(mse_port <= MSE_RATIO * mse_jax, f"blinds {name} MSE against the JAX 256-spp image too high")


def reset_launches():
    """Every kernel's launch count, and the bounce loop's counts, to 0."""
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.core import pcg
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    k1.launches = mk.launches = fs.launches = pcg.launches = 0
    for counts in (pairs.launches, wide.launches):
        for k in counts:
            counts[k] = 0
    stats.counts.update(bounces=0, dispatch_groups=0, fused_shades=0)


def read_launches() -> dict:
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.core import pcg
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    return {"K1": k1.launches, **pairs.launches, **wide.launches, "K8": mk.launches,
            "K9": fs.launches, "pcg32_draws": pcg.launches, **stats.counts}


def device_events_per_call(calls: dict, windows: int = 6, busy: bool = False) -> dict:
    """Device events (kernels, copies, fills) of one call of each fn in
    `calls` (name -> fn, each called once before, as a warm-up), with
    `busy` as (events, milliseconds the device was busy with them), by
    torch.profiler, where a marker kernel (spin_kernel) opens each call's
    span and one more closes the last. A window is padded at both ends
    (pad_profiler_window), since this torch build loses records at a
    window's ends, and is whole when each pad kept records and every marker
    was recorded: the loss stayed inside the pads. Windows are repeated, up
    to `windows`, until two whole ones agree on every call's count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def marker():
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    seen = []
    for w in range(windows):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profiler_window()
            for fn in calls.values():
                marker()
                fn()
                torch.cuda.synchronize()
            marker()
            pad_profiler_window()
        t1 = time.perf_counter()
        # the raw kineto records: prof.events() would first build the
        # profiler's Python event tree over every record; the program's
        # spans (annotations on the device's timeline) are no device work
        events = sorted((e.start_ns(), e.name(), e.duration_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation())
        head, counts, busy_ns = 0, [], []
        for _, name, dur in events:
            if "spin_kernel" in name:
                counts.append(0)
                busy_ns.append(0)
            elif counts:
                counts[-1] += 1
                busy_ns[-1] += dur
            else:
                head += 1
        whole = head > 0 and len(counts) == len(calls) + 1 and counts[-1] > 0
        print(f"profiler window {w}: {t1 - t0:.1f} s, {len(events)} device records read in "
              f"{time.perf_counter() - t1:.1f} s; {head} records before the first marker, "
              f"{counts} after each; whole: {whole}", flush=True)
        if whole:
            if counts[:-1] in seen:
                if busy:
                    return {k: (c, b / 1e6) for k, c, b in zip(calls, counts, busy_ns)}
                return dict(zip(calls, counts))
            seen.append(counts[:-1])
    fail(f"the profiler recorded no two whole windows that agree in {windows}")


def blinds_full_width(device):
    """Phase 14: blinds 256^2, d12 through the CLI: path B and path A at
    scenes/blinds/pt.json's 64 spp, and the wavefront with the dispatch at
    one 16-spp pass, each with every launch count read around it. Returns
    the K8 and K9 launches of their paths."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators import megakernel as mk
    from akari_render_tpu_torch.integrators.pt import render_sample

    scene, task, settings, filt = blinds_setup(device)
    tb = mk.pass_tables(scene, settings, filt, task.seed)
    m = task.method
    found = {}
    for name, switch, shade, spp in (("wavefront", None, "dispatch", m.spp_per_pass),
                                     ("path B", "AKR_PALLAS_SHADE", "fused (K9)", m.spp),
                                     ("path A", "AKR_MEGAKERNEL", "megakernel (K8)", m.spp)):
        out = OUT / f"blinds256_{name.replace(' ', '_')}.exr"
        out.unlink(missing_ok=True)
        # the card's default shade on blinds is K9: the wavefront row asks for the dispatch
        with env_switch(**({switch: "1"} if switch else {"AKR_PALLAS_SHADE": "0"})):
            reset_launches()
            t0 = time.perf_counter()
            stats = cli_main(["-s", str(BLINDS), "-m", str(BLINDS_METHOD), "--spp", str(spp),
                              "-o", str(out), "--device", device])
            wall = time.perf_counter() - t0
            got = read_launches()
        img = read_exr(out)
        check(img.shape == (256, 256, 3) and bool(np.all(np.isfinite(img))),
              f"blinds 256^2 {name} image shape / finiteness")
        check(stats["shade"] == shade, f"blinds 256^2 {name} took the {stats['shade']} shade")
        check(stats["spp_total"] == spp, f"blinds 256^2 {name} rendered {stats['spp_total']} spp")
        paths = scene.camera.width * scene.camera.height * spp
        print(f"blinds 256^2 {spp}spp d{m.max_depth} {name} ({stats['tier']}, {shade}): render "
              f"{stats['total_time']:.4f} s ({paths / stats['total_time'] / 1e6:.4f} Mpaths/s), "
              f"CLI wall {wall:.3f} s, launches and counts {got}, image mean "
              f"{img.mean(axis=(0, 1))}", flush=True)
        if name == "wavefront":
            check(got["K1"] > 0 and got["K8"] == 0 and got["K9"] == 0
                  and got["dispatch_groups"] > 0, "the wavefront path's launches")
        elif name == "path B":
            # a bounce whose lanes all missed has nothing to shade
            check(0 < got["K9"] <= got["bounces"], "path B must launch K9 at most once per bounce")
            check(got["dispatch_groups"] == 0 and got["K8"] == 0,
                  "path B shaded lanes through the dispatch")
            found["K9"] = got["K9"]
        else:
            passes = -(-spp // m.spp_per_pass)
            check(stats["tier"] == "megakernel" and got["K8"] == passes,
                  "path A must launch K8 once per pass")
            check(got["K1"] == got["K9"] == got["bounces"] == 0, "path A ran another kernel")
            found["K8"] = got["K8"]

    def wavefront_sample(switch=None):
        def fn():
            with env_switch(**({switch: "1"} if switch else {"AKR_PALLAS_SHADE": "0"})):
                render_sample(scene, settings, filt, 0, task.seed, task.sampler)
        return fn

    t0 = time.perf_counter()
    events = device_events_per_call({
        "wavefront": wavefront_sample(), "path B": wavefront_sample("AKR_PALLAS_SHADE"),
        "path A": lambda: mk.megakernel_pass(tb, 0, 1)})  # a sample is a one-sample pass
    print(f"blinds 256^2 device events per sample (torch.profiler, device activity only; "
          f"{time.perf_counter() - t0:.1f} s): {events}; path B's: {events['path B']}",
          flush=True)
    check(events["path A"] == 1, "path A's sample must be one device event")
    return found


def sampler_parity(device):
    """Phase 19: make_sampler for pmj02bn, sobol, hash (independent under
    AKR_RNG=hash) and independent on the card against the same call on the
    CPU: SAMPLER_LANES lanes x SAMPLER_DIMS dimensions, bit-equal (int32
    views), at sample index 4,100 for every lane (pmj02's epoch 1; one
    index a wavefront, as the renders draw) and at a per-lane index over
    epochs 0-2 (the [N] path)."""
    import torch

    from akari_render_tpu_torch.core.lds import make_sampler

    t0 = time.perf_counter()
    pix = torch.arange(SAMPLER_LANES, dtype=torch.int64)
    per_lane = (pix * 2654435761) % (3 * 4096)
    for kind in ("pmj02bn", "sobol", "hash", "independent"):
        cfg = {"type": "independent" if kind == "hash" else kind, "seed": 0}
        with env_switch(**({"AKR_RNG": "hash"} if kind == "hash" else {})):
            for index in (4100, per_lane):
                draws = []
                for dev in ("cpu", device):
                    si = index.to(dev) if isinstance(index, torch.Tensor) else index
                    s = make_sampler(cfg, pix.to(dev), si, 0)
                    us = []
                    for _ in range(SAMPLER_DIMS):
                        s, u = s.next_1d()
                        us.append(u)
                    draws.append(torch.stack(us).cpu().view(torch.int32))
                check(torch.equal(draws[0], draws[1]),
                      f"{kind} draws on the card differ from the CPU's "
                      f"({int((draws[0] != draws[1]).sum())} of {draws[0].numel()})")
    print(f"sampler parity: pmj02bn, sobol, hash and independent, {SAMPLER_LANES} lanes x "
          f"{SAMPLER_DIMS} dims at sample index 4100 and at per-lane indices over 0-12287, "
          f"bit-equal on cpu and {device} ({time.perf_counter() - t0:.1f} s)", flush=True)


def cbox_setup(device, width=None):
    """(scene, task, PTSettings, filter) of the cbox fixture with
    scenes/cbox/pt.json, at its own 1024x1024 unless `width` is given."""
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.scene import load_scene

    task = RenderTask.from_file(CBOX_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    scene = load_scene(str(CBOX), width, width, device=device)
    return scene, task, settings, filter_from_config(task.filter_config)


def cbox_correctness(device):
    """Phase 20: cbox 64^2, 16 spp, pmj02bn, d12 through the CLI on the
    dispatch route and on path B (K9), each held to phase 4's gates against
    the committed JAX images (testdata/cbox64_spp{16,256}.npy); then one
    sample's first-hit aux on both routes: path B's albedo (K9's albedo
    output) against the dispatch route's closures, and the normal and t
    bit-equal."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators.common import trace_paths
    from akari_render_tpu_torch.integrators.pt import camera_sample

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    jax16 = np.load(testdata / "cbox64_spp16.npy")
    gt = np.load(testdata / "cbox64_spp256.npy")
    for name, route, shade in (("dispatch", "0", "dispatch"), ("path B", "1", "fused (K9)")):
        out = OUT / f"cbox64_{name.replace(' ', '_')}.exr"
        with env_switch(AKR_PALLAS_SHADE=route):
            reset_launches()
            stats = cli_main(["-s", str(CBOX), "-m", str(CBOX_METHOD), "--res", "64", "--spp",
                              "16", "-o", str(out), "--device", device])
            got = read_launches()
        check(stats["shade"] == shade and stats["tier"] == "wavefront",
              f"cbox 64^2 {name} took the {stats['tier']} tier, {stats['shade']} shade")
        check(got["K1"] > 0 and got["K8"] == 0 and (got["K9"] > 0) == (route == "1"),
              f"cbox 64^2 {name} launches {got}")
        img = read_exr(out)
        check(img.shape == jax16.shape and bool(np.all(np.isfinite(img))),
              f"cbox 64^2 {name} image shape / finiteness")
        m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
        mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
        mse_port = float(np.mean((img - gt) ** 2))
        mse_jax = float(np.mean((jax16 - gt) ** 2))
        print(f"cbox 64^2 16spp pmj02bn d12 {name} ({shade}): means port {m_port} jax {m_jax} "
              f"(max rel {mean_rel:.3g}); MSE(port, jax256) {mse_port:.6g}, MSE(jax16, jax256) "
              f"{mse_jax:.6g}, MSE(port, jax16) {float(np.mean((img - jax16) ** 2)):.6g}; "
              f"launches {got}", flush=True)
        check(mean_rel <= MEAN_TOL, f"cbox {name} means differ from the JAX image by more than 1%")
        check(mse_port <= MSE_RATIO * mse_jax, f"cbox {name} MSE against the JAX 256-spp image too high")

    scene, task, settings, filt = cbox_setup(device, 64)
    aux = {}
    for route in ("0", "1"):
        with env_switch(AKR_PALLAS_SHADE=route):
            reset_launches()
            o, d, _, sampler = camera_sample(scene, filt, 0, task.seed, task.sampler)
            _, aux[route], _ = trace_paths(scene, settings, o, d, sampler)
            check((read_launches()["K9"] > 0) == (route == "1"), "the aux sample's K9 launches")
    diff = float((aux["1"]["albedo"] - aux["0"]["albedo"]).abs().max())
    hit = aux["0"]["first_t"] < 1e19
    print(f"cbox 64^2 aux: K9's albedo against the dispatch route's, max abs {diff:.3g} over "
          f"{int(hit.sum())} first hits (mean {aux['1']['albedo'][hit].mean(0).tolist()})",
          flush=True)
    check(diff <= AUX_ALBEDO_TOL, "K9's aux albedo differs from the dispatch route's")
    check(bool(hit.any()) and float(aux["1"]["albedo"][hit].max()) > 0.5, "the aux albedo is empty")
    for k in ("normal", "first_t"):
        check(torch.equal(aux["0"][k], aux["1"][k]), f"the aux {k} differs between the routes")


def k9_first_bounce(device, kind_method: Path) -> dict:
    """K9 on the first bounce of a cbox 1024^2 sample, from one-sample
    renders through the CLI (the phase's warm-ups): the default route's
    first _fused_shade_live call held against K9's plain version
    (k9_check: bit-equal lanes, the device time against the bound at 2^20
    lanes), and the dispatch route's first dispatch_shade call shaded again
    through K9, its valid flags, direct light and albedo against the
    dispatch's on the live lanes. The captured inputs are dropped on
    return, before any timed render."""
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.integrators import common

    def first_call(route, target):
        with env_switch(AKR_PALLAS_SHADE=SHADE_ROUTES[route][0]), \
                captured(common, target, keep=(0,)) as first:
            cli_main(["-s", str(CBOX), "-m", str(kind_method), "--spp", "1", "-o",
                      str(OUT / "cbox1024_warmup.exr"), "--device", device])
        check(len(first.calls) == 1, f"cbox 1024^2 on the {route} route made no {target} call")
        return first.calls[0]

    def against_plain():
        (bake, si, extra, lanes), _ = first_call("K9", "_fused_shade_live")
        args = (bake, *si["frame"], si["ng"], *(extra[k] for k in (
            "wo", "ls_wi", "ls_li", "ls_pdf", "u_bsdf")), si["mat"])
        return k9_check("the first bounce of a cbox 1024^2 sample (the card's default route)",
                        args, live=lanes)

    def against_dispatch():
        a, kw = first_call("dispatch", "dispatch_shade")
        scene, si, extra, _, lanes = a[:5]
        want = common.dispatch_shade(*a, **kw)
        got = common._fused_shade_live(scene.shade_bake, si, extra, lanes)
        live = int(lanes.sum())
        differ = int(((got["valid"] != want["valid"]) & lanes).sum())
        errs = {k: max_abs_diff(got[k][lanes], want[k][lanes]) for k in ("direct", "albedo")}
        share = float((want["valid"] & lanes).sum()) / live
        print(f"cbox 1024^2 first bounce ({live} live lanes of {lanes.numel()}), K9 against the "
              f"dispatch on the same inputs: valid differs on {differ} lanes (valid {share:.6f}), "
              f"max abs err direct {errs['direct']:.3g}, albedo {errs['albedo']:.3g}", flush=True)
        check(differ <= K9_DISPATCH_VALID_FRAC * live,
              f"cbox 1024^2 first bounce: K9's valid differs from the dispatch's on {differ} lanes")
        for k in errs:
            check(bool(torch.allclose(got[k][lanes], want[k][lanes], atol=K9_DISPATCH_ATOL,
                                      rtol=K9_DISPATCH_RTOL)),
                  f"cbox 1024^2 first bounce: K9's {k} differs from the dispatch's")
        return {"live": live, "valid_differ": differ, "valid_share": share, "max_abs_err": errs}

    return {**against_plain(), "against_dispatch": against_dispatch()}


def cbox_full_width(device):
    """Phase 21: cbox at its own 1024^2 with the reference's configuration
    (scenes/cbox/pt.json: pmj02bn, d12, rr 5, Gaussian r 1.5) through the
    CLI, CBOX_SPP samples after a one-sample warm-up, with the independent
    sampler beside it, each under a named shade route (K9, the card's
    default, and the dispatch under AKR_PALLAS_SHADE=0) in the turns of
    CBOX_ROWS: Mpaths/s, every kernel's launches, K1's launches and mean
    time a launch (CUDA events), peak device bytes a lane; K9 on the first
    bounce against its plain version and against the dispatch
    (k9_first_bounce, from pmj02bn's warm-ups); then one sample of each row
    by torch.profiler: its device launches and busy time, and the idle
    share against an unprofiled sample. Returns the printed numbers, by
    "<sampler> <route>", and K9's first-bounce numbers under "k9"."""
    import json as _json

    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators.pt import render_sample

    method = _json.loads(CBOX_METHOD.read_text())
    methods = {}
    for kind in {k for k, _ in CBOX_ROWS}:
        methods[kind] = CBOX_METHOD
        if kind != method["sampler"]["type"]:
            methods[kind] = OUT / f"cbox_{kind}.json"
            methods[kind].write_text(_json.dumps({**method, "sampler": {**method["sampler"],
                                                                        "type": kind}}))
    k9 = k9_first_bounce(device, methods["pmj02bn"])
    found = {}
    for kind, route in CBOX_ROWS:
        switch, shade = SHADE_ROUTES[route]
        row = f"{kind} {route}"
        out = OUT / f"cbox1024_{kind}_{route}.exr"
        out.unlink(missing_ok=True)
        with env_switch(AKR_PALLAS_SHADE=switch):
            if row not in found:
                cli_main(["-s", str(CBOX), "-m", str(methods[kind]), "--spp", "1", "-o",
                          str(out), "--device", device])  # the warm-up
            torch.cuda.reset_peak_memory_stats()
            with timed_k1() as timing:
                reset_launches()
                t0 = time.perf_counter()
                stats = cli_main(["-s", str(CBOX), "-m", str(methods[kind]), "--spp",
                                  str(CBOX_SPP), "-o", str(out), "--device", device])
                wall = time.perf_counter() - t0
                got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        check(stats["tier"] == "wavefront" and stats["spp_total"] == CBOX_SPP
              and stats["shade"] == shade,
              f"cbox 1024^2 {row}: {stats['tier']}, {stats['shade']}, {stats['spp_total']} spp")
        check(got["K1"] > 0 and (got["K9"] > 0) == (route == "K9")
              and all(got[k] == 0 for k in ("K2", "K3", "K4", "K5", "K7", "K8")),
              f"cbox 1024^2 {row} launches {got}")
        img = read_exr(out)
        check(img.shape == (1024, 1024, 3) and bool(np.all(np.isfinite(img))),
              f"cbox 1024^2 {row} image shape / finiteness")
        k1 = timing.summary()
        check(k1["launches"] == got["K1"], f"K1: {k1['launches']} launches timed of {got['K1']}")
        paths = 1024 * 1024 * CBOX_SPP
        run = {"mpaths_s": paths / stats["total_time"] / 1e6, "render_s": stats["total_time"],
               "k1_launches": got["K1"], "k1_ms": k1["ms"], "k1_bound_ms": k1["bound_ms"],
               "bounces": got["bounces"], "peak_bytes_per_lane": peak / (1024 * 1024)}
        found.setdefault(row, {"runs": []})["runs"].append(run)
        print(f"cbox 1024^2 {CBOX_SPP}spp d12 {kind} ({stats['shade']}, {stats['traversal']}): "
              f"render {stats['total_time']:.4f} s ({run['mpaths_s']:.4f} Mpaths/s), CLI "
              f"wall {wall:.3f} s, launches and counts {got}, K1 mean {k1['ms']:.4f} ms a launch "
              f"(least {k1['ms_min']:.4f}, most {k1['ms_max']:.4f}; mean bound "
              f"{k1['bound_ms']:.4f}), peak device memory {peak / 2**30:.3f} GiB "
              f"({peak / (1024 * 1024):.0f} B per lane), image mean {img.mean(axis=(0, 1))}",
              flush=True)

    scene, task, settings, filt = cbox_setup(device)

    def sample(row):
        kind, route = row.split()

        def fn():
            with env_switch(AKR_PALLAS_SHADE=SHADE_ROUTES[route][0]):
                render_sample(scene, settings, filt, 0, task.seed, {**task.sampler, "type": kind})
        return fn

    t0 = time.perf_counter()
    events = device_events_per_call({k: sample(k) for k in found}, busy=True)
    for row, (count, busy_ms) in events.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sample(row)()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        found[row].update(launches_per_sample=count, busy_ms=busy_ms, sample_ms=wall_ms,
                          idle_share=1.0 - busy_ms / wall_ms)
        print(f"cbox 1024^2 one {row} sample (torch.profiler, device activity only): {count} "
              f"device events, device busy {busy_ms:.3f} ms; unprofiled sample {wall_ms:.3f} ms, "
              f"device idle {100 * (1.0 - busy_ms / wall_ms):.1f} %", flush=True)
    print(f"cbox 1024^2 profile: {time.perf_counter() - t0:.1f} s; pmj02bn against independent "
          f"on K9: {events['pmj02bn K9'][0] - events['independent K9'][0]:+d} device events a "
          f"sample; K9 against the dispatch (pmj02bn): "
          f"{events['pmj02bn K9'][0] - events['pmj02bn dispatch'][0]:+d}", flush=True)
    found["k9"] = k9
    return found


def aov_phase(device):
    """Phase 22: the aov method through the CLI: matbox 64^2, 2 spp, each
    of the seven images against the committed JAX set
    (testdata/matbox64_aov_spp2.npz) within AOV_* (the albedo and
    roughness read the card's own GGX albedo table); then cbox 1024^2,
    1 spp: the seven images finite, and the depth above 5 wherever a ray
    hit. K1 traces the first hits."""
    import json as _json

    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators.aov import AOV_NAMES

    ref = np.load(ROOT / "akari_render_tpu_torch" / "testdata" / "matbox64_aov_spp2.npz")
    for scene, res, spp in ((SCENE, "64", 2), (CBOX, None, 1)):
        method = OUT / f"aov_{spp}.json"
        method.write_text(_json.dumps({"method": {"type": "aov", "spp": spp}}))
        out = OUT / f"{scene.parent.name}_aov.exr"
        reset_launches()
        t0 = time.perf_counter()
        cli_main(["-s", str(scene), "-m", str(method), "-o", str(out), "--device", device]
                 + (["--res", res] if res else []))
        wall = time.perf_counter() - t0
        got = read_launches()
        check(got["K1"] == spp, f"the AOV of {scene.parent.name} launched K1 {got['K1']} times")
        images = {n: read_exr(out.with_name(f"{out.stem}_{n}{out.suffix}")) for n in AOV_NAMES}
        check(np.array_equal(read_exr(out), images["albedo"]), "the main image is not the albedo")
        for n, im in images.items():
            check(bool(np.all(np.isfinite(im))), f"AOV {n} of {scene.parent.name} not finite")
        if res:
            worst = []
            for n, im in images.items():
                want = ref[n]
                check(im.shape == want.shape, f"AOV {n} shape {im.shape}")
                off = np.abs(im - want).max(axis=-1) > AOV_ABS
                m_rel = float(np.max(np.abs(im.mean((0, 1)) - want.mean((0, 1)))
                                     / np.maximum(np.abs(want.mean((0, 1))), 1e-6)))
                rough = n == "roughness"
                worst.append(f"{n} {off.mean():.4g} of pixels off, max abs "
                             f"{np.abs(im - want).max():.3g}, means rel {m_rel:.3g}")
                check(off.mean() <= (AOV_ROUGH_FRAC if rough else AOV_PIX_FRAC)
                      and m_rel <= (AOV_ROUGH_MEAN_REL if rough else AOV_MEAN_REL),
                      f"matbox 64^2 AOV {n} differs from JAX's: {worst[-1]}")
            print(f"AOV matbox 64^2 2spp against JAX ({wall:.2f} s CLI): " + "; ".join(worst),
                  flush=True)
        else:
            depth = images["depth"][..., 0]
            hit = depth > 0.0
            check(hit.mean() > 0.95 and float(depth[hit].min()) > 5.0,
                  f"cbox AOV depth: {hit.mean():.4f} of pixels hit, least depth "
                  f"{float(depth[hit].min()) if hit.any() else 0.0}")
            print(f"AOV cbox 1024^2 1spp ({wall:.2f} s CLI): {hit.mean():.4f} of pixels hit, depth "
                  f"{float(depth[hit].min()):.4f}-{float(depth.max()):.4f}, image means "
                  f"{ {n: [round(float(x), 4) for x in im.mean((0, 1))] for n, im in images.items()} }",
                  flush=True)


def method_file(name: str, base: Path, **overrides) -> Path:
    """A copy of a method file with some of its method's fields changed,
    under OUT."""
    import json as _json

    doc = _json.loads(base.read_text())
    doc["method"].update(overrides)
    path = OUT / name
    path.write_text(_json.dumps(doc))
    return path


def image_gates(label: str, img, want, gt, mean_tol: float, mse_ratio: float) -> str:
    """Phase 4's gates: channel means within mean_tol of `want` (the JAX
    render of the same configuration) and MSE against `gt` within
    mse_ratio of want's own; returns the printed comparison."""
    import numpy as np

    check(img.shape == want.shape and bool(np.all(np.isfinite(img))),
          f"{label}: image shape {img.shape} / finiteness")
    m_port, m_jax = img.mean(axis=(0, 1)), want.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
    mse_port, mse_jax = float(np.mean((img - gt) ** 2)), float(np.mean((want - gt) ** 2))
    text = (f"means port {m_port} jax {m_jax} (max rel {mean_rel:.3g}); MSE(port, gt) "
            f"{mse_port:.6g}, MSE(jax, gt) {mse_jax:.6g}, MSE(port, jax) "
            f"{float(np.mean((img - want) ** 2)):.6g}")
    check(mean_rel <= mean_tol, f"{label}: means differ from JAX's by more than "
                                f"{mean_tol:.0%}: {text}")
    check(mse_port <= mse_ratio * mse_jax, f"{label}: MSE against the ground truth too high: "
                                           f"{text}")
    return text


def gpt_correctness(device):
    """Phase 23: cbox 64^2, 4 spp through the CLI with scenes/cbox/gpt.json
    (the reconnection shift; its bounces shade through the dispatch) held
    against the committed JAX render (testdata/cbox64_gpt_spp4.npz), whose
    gradient films hold the mean of a pair's two ends where the port's hold
    their sum: the gradients at JAX's paired pixels (bench_torch/check.py::
    paired) by correlation and by their slope on JAX's (2); the primal by
    phase 4's gates against testdata/cbox64_spp256.npy, and the
    reconstruction by those gates against the port's screened_poisson of
    JAX's films at 2x (the card's own gradients at the few pixels where
    JAX's film holds a reflected end, which no factor turns into a pair);
    then the pss shift on the dispatch route and on path B (K9), the two
    within 1 % in their means."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators.gpt import screened_poisson
    from bench_torch.check import paired

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    ref = np.load(testdata / "cbox64_gpt_spp4.npz")
    gt = np.load(testdata / "cbox64_spp256.npy")
    out = OUT / "cbox64_gpt.exr"
    with env_switch(AKR_PALLAS_SHADE="0"):
        reset_launches()
        t0 = time.perf_counter()
        stats = cli_main(["-s", str(CBOX), "-m", str(CBOX_GPT), "--res", "64", "--spp", "4",
                          "-o", str(out), "--device", device])
        wall = time.perf_counter() - t0
        got = read_launches()
    check(stats["shift_mode"] == "reconnect" and stats["shade"] == "dispatch",
          f"cbox 64^2 GPT took the {stats['shift_mode']} shift, {stats['shade']} shade")
    check(got["K1"] > 0 and got["K8"] == 0 and got["K9"] == 0 and got["dispatch_groups"] > 0,
          f"cbox 64^2 GPT launches {got}")
    full = {}
    for name, axis in (("gx", 1), ("gy", 0)):
        line = paired(64, 1)
        keep = np.broadcast_to(line[None, :, None] if axis == 1 else line[:, None, None],
                               stats[name].shape)
        port_g, jax_g = stats[name][keep], ref[name][keep]
        corr = float(np.corrcoef(port_g, jax_g)[0, 1])
        slope = float(np.dot(port_g, jax_g) / np.dot(jax_g, jax_g))
        print(f"cbox 64^2 GPT {name}: at JAX's {int(line.sum())} paired of 64 lines, "
              f"correlation with JAX's {corr:.6f}, slope {slope:.6f}, mean abs port "
              f"{np.abs(port_g).mean():.6g} jax {np.abs(jax_g).mean():.6g}", flush=True)
        check(corr >= GRAD_CORR, f"cbox 64^2 GPT {name} correlates {corr:.4f} with JAX's")
        check(abs(slope - GRAD_SLOPE) <= GRAD_SLOPE_TOL,
              f"cbox 64^2 GPT {name}: slope {slope:.4f} on JAX's, not {GRAD_SLOPE}")
        full[name] = np.where(keep, GRAD_SLOPE * ref[name], stats[name])
    want = screened_poisson(*(torch.as_tensor(np.asarray(a, np.float32)) for a in (
        ref["primal"], full["gx"], full["gy"]))).numpy()
    for name, img, jax_img in (("recon", read_exr(out), want),
                               ("primal", stats["primal"], ref["primal"])):
        text = image_gates(f"cbox 64^2 GPT {name}", img, jax_img, gt, MEAN_TOL, MSE_RATIO)
        print(f"cbox 64^2 4spp GPT reconnect {name}: {text}", flush=True)
    print(f"cbox 64^2 GPT reconnect: {wall:.2f} s CLI, launches and counts {got}", flush=True)

    pss = method_file("cbox_gpt_pss.json", CBOX_GPT, reconnect=False)
    means = {}
    for route, shade in (("0", "dispatch"), ("1", "fused (K9)")):
        out = OUT / f"cbox64_gpt_pss_{route}.exr"
        with env_switch(AKR_PALLAS_SHADE=route):
            reset_launches()
            stats = cli_main(["-s", str(CBOX), "-m", str(pss), "--res", "64", "--spp", "4",
                              "-o", str(out), "--device", device])
            got = read_launches()
        img = read_exr(out)
        check(stats["shift_mode"] == "pss" and stats["shade"] == shade,
              f"cbox 64^2 GPT pss took the {stats['shift_mode']} shift, {stats['shade']} shade")
        check(img.shape == (64, 64, 3) and bool(np.all(np.isfinite(img)))
              and all(np.all(np.isfinite(stats[k])) for k in ("primal", "gx", "gy")),
              f"cbox 64^2 GPT pss {shade}: shape / finiteness")
        check(got["K1"] > 0 and (got["K9"] > 0) == (route == "1")
              and (got["dispatch_groups"] == 0) == (route == "1"),
              f"cbox 64^2 GPT pss {shade} launches {got}")
        means[shade] = img.mean(axis=(0, 1))
        print(f"cbox 64^2 4spp GPT pss ({shade}): mean {means[shade]}, launches and counts "
              f"{got}", flush=True)
    rel = float(np.max(np.abs(means["fused (K9)"] - means["dispatch"]) / means["dispatch"]))
    check(rel <= MEAN_TOL, f"cbox 64^2 GPT pss: path B's means {rel:.3g} off the dispatch's")


def mcmc_correctness(device):
    """Phase 24: cbox 64^2 through the CLI with scenes/cbox/mcmc.json at
    256 chains and 16 spp-equivalents, on the dispatch route and on path B
    (K9 shades the chains' paths), each held against the committed JAX
    render (testdata/cbox64_mcmc.npy): means within MCMC_MEAN_TOL, MSE
    against testdata/cbox64_spp256.npy within MCMC_MSE_RATIO of JAX's;
    b and the acceptance printed beside JAX's."""
    import json as _json

    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    want = np.load(testdata / "cbox64_mcmc.npy")
    jstats = _json.loads((testdata / "cbox64_mcmc_stats.json").read_text())
    gt = np.load(testdata / "cbox64_spp256.npy")
    method = method_file("cbox_mcmc_64.json", CBOX_MCMC, n_chains=MCMC_CHAINS_64)
    for route, shade in (("0", "dispatch"), ("1", "fused (K9)")):
        out = OUT / f"cbox64_mcmc_{route}.exr"
        with env_switch(AKR_PALLAS_SHADE=route):
            reset_launches()
            t0 = time.perf_counter()
            stats = cli_main(["-s", str(CBOX), "-m", str(method), "--res", "64", "--spp", "16",
                              "-o", str(out), "--device", device])
            wall = time.perf_counter() - t0
            got = read_launches()
        check(stats["shade"] == shade, f"cbox 64^2 MCMC took the {stats['shade']} shade")
        check(got["K1"] > 0 and got["K8"] == 0 and (got["K9"] > 0) == (route == "1"),
              f"cbox 64^2 MCMC {shade} launches {got}")
        text = image_gates(f"cbox 64^2 MCMC {shade}", read_exr(out), want, gt, MCMC_MEAN_TOL,
                           MCMC_MSE_RATIO)
        print(f"cbox 64^2 MCMC ({shade}): b {stats['b']:.6g} (jax {jstats['b']:.6g}), "
              f"acceptance {stats['acceptance']:.4f} (jax {jstats['acceptance']:.4f}), "
              f"{stats['steps']} steps a chain; {text}; {wall:.2f} s CLI, launches and counts "
              f"{got}", flush=True)


def gpt_mcmc_full_width(device):
    """Phase 25: cbox 1024^2 through the CLI with gpt.json at GPT_SPP
    samples and mcmc.json (65,536 chains) at MCMC_SPP spp-equivalents:
    GPT paths a second (five a pixel a sample), MCMC mutations a second
    over the mutation steps, K1's launches and mean time (CUDA events),
    peak device bytes a pixel; then one GPT sample and one mutation step
    by torch.profiler (device events and busy time) against an unprofiled
    one (the idle share). Returns the printed numbers."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.film import Film
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators import gpt, mcmc
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.scene import load_scene

    found = {}
    npix = 1024 * 1024
    for name, method, spp in (("gpt", CBOX_GPT, GPT_SPP), ("mcmc", CBOX_MCMC, MCMC_SPP)):
        out = OUT / f"cbox1024_{name}.exr"
        out.unlink(missing_ok=True)
        torch.cuda.reset_peak_memory_stats()
        with timed_k1() as timing:
            reset_launches()
            t0 = time.perf_counter()
            stats = cli_main(["-s", str(CBOX), "-m", str(method), "--spp", str(spp), "-o",
                              str(out), "--device", device])
            wall = time.perf_counter() - t0
            got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        img = read_exr(out)
        check(img.shape == (1024, 1024, 3) and bool(np.all(np.isfinite(img)))
              and float(img.mean()) > 0.0, f"cbox 1024^2 {name} image shape / finiteness")
        check(got["K1"] > 0 and all(got[k] == 0 for k in ("K2", "K3", "K4", "K5", "K7", "K8")),
              f"cbox 1024^2 {name} launches {got}")
        k1 = timing.summary()
        check(k1["launches"] == got["K1"], f"K1: {k1['launches']} launches timed of {got['K1']}")
        run = {"render_s": stats["total_time"], "k1_launches": got["K1"], "k1_ms": k1["ms"],
               "k1_bound_ms": k1["bound_ms"], "peak_bytes_per_pixel": peak / npix}
        if name == "gpt":
            run["paths_s"] = 5 * npix * spp / stats["total_time"]
            rate = f"{run['paths_s'] / 1e6:.4f} Mpaths/s (5 paths a pixel a sample)"
        else:
            c = 65536
            check(stats["steps"] == npix * spp // c, f"MCMC ran {stats['steps']} steps a chain")
            run.update(mutations_s=c * stats["steps"] / stats["mutate_time"],
                       mutate_s=stats["mutate_time"], bootstrap_s=stats["bootstrap_time"],
                       direct_s=stats["direct_time"])
            rate = (f"{run['mutations_s'] / 1e6:.4f} M mutations/s over the steps "
                    f"({stats['steps']} steps x {c} chains in {stats['mutate_time']:.3f} s; "
                    f"bootstrap {stats['bootstrap_time']:.3f} s, direct pass "
                    f"{stats['direct_time']:.3f} s; b {stats['b']:.6g}, acceptance "
                    f"{stats['acceptance']:.4f})")
        found[name] = run
        print(f"cbox 1024^2 {name} {spp}spp: render {stats['total_time']:.4f} s, {rate}, CLI "
              f"wall {wall:.3f} s, launches and counts {got}, K1 mean {k1['ms']:.4f} ms a "
              f"launch (least {k1['ms_min']:.4f}, most {k1['ms_max']:.4f}; mean bound "
              f"{k1['bound_ms']:.4f}), peak device memory {peak / 2**30:.3f} GiB "
              f"({peak / npix:.0f} B a pixel), image mean {img.mean(axis=(0, 1))}", flush=True)

    scene = load_scene(str(CBOX), device=device)
    gtask = RenderTask.from_file(CBOX_GPT)
    gm = gtask.method
    gset = PTSettings(max_depth=gm.max_depth, rr_depth=gm.rr_depth, use_nee=gm.use_nee)
    gfilt = filter_from_config(gtask.filter_config)
    films = tuple(Film.new(1024, 1024, device) for _ in range(6))
    pix = torch.arange(npix, device=device)

    def gpt_sample():
        gpt.gpt_sample_films(scene, gm, gfilt, gset, mcmc.sample_dimension(gm.max_depth),
                             gtask.seed, "reconnect", films, 0, pix)

    step, carry = mcmc_step(scene, device)
    calls = {"gpt sample": gpt_sample, "mcmc step": lambda: step(carry)}
    t0 = time.perf_counter()
    events = device_events_per_call(calls, busy=True)
    for name, (count, busy_ms) in events.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        calls[name]()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        found[name.split()[0]].update(events=count, busy_ms=busy_ms, unprofiled_ms=wall_ms,
                                      idle_share=1.0 - busy_ms / wall_ms)
        print(f"cbox 1024^2 one {name} (torch.profiler, device activity only): {count} device "
              f"events, device busy {busy_ms:.3f} ms; unprofiled {wall_ms:.3f} ms, device idle "
              f"{100 * (1.0 - busy_ms / wall_ms):.1f} %", flush=True)
    print(f"cbox 1024^2 GPT/MCMC profile: {time.perf_counter() - t0:.1f} s", flush=True)
    return found


def mcmc_step(scene, device):
    """(step, carry): the mutation step of mcmc.json's configuration on the
    cbox `scene` (1024^2) and its first carry, after the bootstrap."""
    import torch

    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.film import Film
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.core.samplers import IndependentSampler
    from akari_render_tpu_torch.integrators import mcmc

    mtask = RenderTask.from_file(CBOX_MCMC)
    mm = mtask.method
    mset, d = mcmc._mcmc_settings(mm)
    mfilt = filter_from_config(mtask.filter_config)
    boot = mcmc.bootstrap_chains(scene, mset, mfilt, mm, d, mm.n_chains, mtask.seed)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    rng = IndependentSampler.new(torch.arange(mm.n_chains, device=device),
                                 seed=mtask.seed ^ 0xC4A1).rng
    carry = mcmc.Chains(*boot[:4], rng, Film.new(1024, 1024, device),
                        torch.zeros((), device=device), zero, zero, zero)
    return mcmc.make_mutate_step(scene, mset, mfilt, mm, d), carry


def pcg_kernel_phase(device) -> dict:
    """Phase 30: the pcg32_draws kernel at PCG_SHAPES against its plain
    version on the same streams (u and the new state bit-equal, one launch
    a call), timed at the 61-draw shapes (device time by the profiler and
    CUDA events) beside its bound and the plain version's time; its
    resources; then one job of the benchmark's MCMC configuration
    (MCMC_JOB) after a warm-up: the kernel's launches and its share of the
    draws, the job's phases, and one mutation step's launches and device
    events. Returns the kernel's JSON entry."""
    import numpy as np
    import torch

    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core import pcg
    from akari_render_tpu_torch.integrators import mcmc
    from akari_render_tpu_torch.scene import load_scene

    entry = {"name": "pcg32_draws (csrc/pcg.cu)", "shapes": {}}
    for lanes, d in PCG_SHAPES:
        ids = np.random.default_rng(lanes * 7 + d).integers(0, 1 << 64, lanes, dtype=np.uint64)
        s = pcg.Pcg32.new_seq(torch.as_tensor(ids.view(np.int64), device=device))
        state0 = s.state.clone()
        before = pcg.launches
        got_rng, got = pcg.pcg32_draws(s, d)
        torch.cuda.synchronize()
        check(pcg.launches == before + 1, f"pcg32_draws at {lanes} x {d}: "
              f"{pcg.launches - before} launches")
        (want_rng, want), plain_ms = timed(lambda: pcg.pcg32_draws_torch(s, d))
        check(torch.equal(got, want) and torch.equal(got_rng.state, want_rng.state)
              and torch.equal(s.state, state0),
              f"pcg32_draws at {lanes} x {d} differs from its plain version")
        text = f"pcg32_draws {lanes} lanes x {d} draws: u and state bit-equal to the plain version"
        if d > 1 and lanes >= 1 << 16:
            t = event_and_device_ms(lambda: pcg.pcg32_draws(s, d), 200, "pcg32_draws_kernel")
            plain_ms = cuda_ms(lambda: pcg.pcg32_draws_torch(s, d), 5)
            b_ms, what = bound(0.0, lanes * d * 4 + 24 * lanes)
            entry["shapes"][f"{lanes}x{d}"] = {
                "ms": t["ms"], "event_ms": t["event_ms"], "bound_ms": b_ms, "bound": what,
                "plain_ms": plain_ms, "roofline_pct": 100.0 * b_ms / t["ms"]}
            text += (f"; {times_text(t)}, bound {b_ms:.4f} ms ({what}, "
                     f"{100.0 * b_ms / t['ms']:.1f} % of it), plain version {plain_ms:.4f} ms")
        print(text, flush=True)
    for d in (61, 1):
        v = pcg.kernel_info(d)["pcg32_draws"]
        entry[f"resources_d{d}"] = v
        print(f"pcg32_draws resources at {d} draws a call: {v['registers']} registers a thread, "
              f"{v['static_smem']} + {v['dynamic_smem']} B shared memory, {v['local_bytes']} B "
              f"local memory, {v['threads']} threads a block, {v['blocks_per_sm']} blocks "
              f"resident an SM", flush=True)
    entry["registers"] = entry["resources_d61"]["registers"]
    entry["blocks_per_sm"] = entry["resources_d61"]["blocks_per_sm"]

    scene = load_scene(str(CBOX), device=device)
    task = RenderTask.from_file(method_file("cbox_mcmc_job.json", CBOX_MCMC, **MCMC_JOB))
    mcmc.render_mcmc(scene, task.method, task)  # the warm-up
    torch.cuda.synchronize()
    l0 = pcg.launches
    c0 = dict(stats.counts)
    _, st = mcmc.render_mcmc(scene, task.method, task)
    torch.cuda.synchronize()
    kd = stats.counts["pcg_kernel_draws"] - c0["pcg_kernel_draws"]
    pd = stats.counts["pcg_plain_draws"] - c0["pcg_plain_draws"]
    check(pd == 0 and kd > 0, f"an MCMC job drew {kd} lane-draws by the kernel, {pd} plain")
    job = {"launches": pcg.launches - l0, "kernel_draws": kd, "plain_draws": pd,
           "steps": st["steps"], "step_ms": 1e3 * st["mutate_time"] / st["steps"],
           "bootstrap_s": st["bootstrap_time"], "direct_s": st["direct_time"],
           "total_s": st["total_time"]}
    step, carry = mcmc_step(scene, device)
    l0 = pcg.launches
    step(carry)
    job["step_launches"] = pcg.launches - l0
    (events, busy_ms), = device_events_per_call({"mcmc step": lambda: step(carry)},
                                                busy=True).values()
    job.update(step_events=events, step_busy_ms=busy_ms)
    entry["mcmc_job"] = job
    print(f"MCMC job ({MCMC_JOB}, 65,536 chains, cbox 1024^2): pcg32_draws {job['launches']} "
          f"launches, kernel share of the draws {kd / (kd + pd):.4f} ({kd} lane-draws); "
          f"{job['steps']} steps at {job['step_ms']:.3f} ms, bootstrap {job['bootstrap_s']:.3f} s, "
          f"direct pass {job['direct_s']:.3f} s, job {job['total_s']:.3f} s; one step: "
          f"{job['step_launches']} pcg32_draws launches, {events} device events, device busy "
          f"{busy_ms:.3f} ms (torch.profiler)", flush=True)
    return entry


class captured:
    """For a block, replace `attr` of module `mod` by a wrapper that keeps
    the arguments of its calls number `keep` (counted from 0) that `want`
    accepts, and calls through."""

    def __init__(self, mod, attr: str, want=lambda *a, **kw: True, keep=(1,)):
        self.mod, self.attr, self.want, self.keep = mod, attr, want, keep
        self.calls = []

    def __enter__(self):
        self.real = getattr(self.mod, self.attr)
        seen = [0]

        def wrapped(*a, **kw):
            if self.want(*a, **kw):
                if seen[0] in self.keep:
                    self.calls.append((a, kw))
                seen[0] += 1
            return self.real(*a, **kw)

        setattr(self.mod, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


# the split pass's depth in phases 26-27
SPLIT_D = 6
# the PT pass shapes of phases 26 and 27: name -> (switches, the shade and
# the tier the stats report)
PASS_SHAPES = {
    "pass": ({}, "dispatch", "wavefront"),
    "split": ({"AKR_SPLIT_DEPTH": str(SPLIT_D)}, "dispatch", "wavefront"),
}
# phase 27: renders of each route timed (the median and the spread reported)
SHAPE_RENDERS = 3


def pass_shapes_correctness(device, base96):
    """Phase 26: the cbox fixture at 64^2, 16 spp, pmj02bn, d12 through the
    CLI on each PASS_SHAPES route, held to phase 4's gates against
    testdata/cbox64_spp{16,256}.npy (the pass: phase 20's dispatch render
    where it is there), the split bit-equal to the pass. Then classroom
    96^2 with the split, held to phase 17's gates and bit-equal to phase
    8's image `base96`. Last the alpha fixture (tests/torch_alpha_scene.py)
    on the card: intersect_alpha and occlude_alpha, through K1 and through
    the pair sweep (AKR_FORCE_BVH), equal to the CPU's. Returns the
    launches of each cbox route."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    jax16 = np.load(testdata / "cbox64_spp16.npy")
    gt = np.load(testdata / "cbox64_spp256.npy")
    images, launches = {}, {}
    for name, (switches, shade, tier) in PASS_SHAPES.items():
        out = OUT / f"cbox64_shape_{name}.exr"
        if name == "pass" and (OUT / "cbox64_dispatch.exr").exists():
            images[name] = read_exr(OUT / "cbox64_dispatch.exr")  # phase 20's render
            continue
        with env_switch(**{"AKR_PALLAS_SHADE": "0", **switches}):
            reset_launches()
            t0 = time.perf_counter()
            stats = cli_main(["-s", str(CBOX), "-m", str(CBOX_METHOD), "--res", "64", "--spp",
                              "16", "-o", str(out), "--device", device])
            wall = time.perf_counter() - t0
            got = read_launches()
        launches[f"cbox 64^2 {name}"] = got
        check(stats["tier"] == tier and stats["shade"] == shade,
              f"cbox 64^2 {name} took the {stats['tier']} tier, {stats['shade']} shade")
        check(got["K1"] > 0
              and all(got[k] == 0 for k in ("K2", "K3", "K4", "K5", "K7", "K8", "K9")),
              f"cbox 64^2 {name} launches {got}")
        images[name] = read_exr(out)
        text = image_gates(f"cbox 64^2 {name}", images[name], jax16, gt, MEAN_TOL, MSE_RATIO)
        extra = {"split_live": stats["split_live"]} if "split_live" in stats else {}
        print(f"cbox 64^2 16spp pmj02bn d12, {name} ({wall:.2f} s CLI): {text}; launches and "
              f"counts {got} {extra}", flush=True)
    check(np.array_equal(images["split"], images["pass"]),
          f"cbox 64^2: the split pass differs from the pass by "
          f"{float(np.abs(images['split'] - images['pass']).max()):.3g}")

    with env_switch(**PASS_SHAPES["split"][0]):
        img = classroom_correctness(device, "pairs-static", base96, label="split")
    check(np.array_equal(img, base96), "classroom 96^2: the split pass differs from the pass")
    alpha_on_card(device)
    return launches


def alpha_on_card(device):
    """Phase 26's alpha part: the six-sheet alpha fixture, intersect_alpha
    and occlude_alpha (staged) on the card against the CPU, through K1 and
    (AKR_FORCE_BVH) through the pair sweep: hit ids, validity and occlusion
    equal, every restart carrying its rejected id in the third exclusion
    slot."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_alpha_scene import alpha_rays, write_alpha_scene

    from akari_render_tpu_torch.scene import load_scene

    path = write_alpha_scene(OUT, 77, 6)
    rays = alpha_rays(1 << 14, 9, 1.9)
    for route, switches, kernels in (("K1", {}, ("K1",)),
                                     ("the pair sweep", {"AKR_FORCE_BVH": "1"},
                                      ("K2", "K3", "K4"))):
        with env_switch(**switches):
            cpu, card = (load_scene(path, device=dv) for dv in ("cpu", device))
            check(card.has_alpha and cpu.has_alpha, "the alpha fixture has no alpha")
            reset_launches()
            res = []
            for sc in (cpu, card):
                t = [torch.as_tensor(x, device=sc.device) for x in rays]
                res.append((sc.intersect_alpha(*t),
                            sc.occlude_alpha(*t[:3], torch.full_like(t[3], 6.5))))
            got = read_launches()
        (hc, oc), (hk, ok) = res
        ids_eq = torch.equal(hk.tri_id.cpu(), hc.tri_id) and torch.equal(hk.valid.cpu(), hc.valid)
        occ_eq = torch.equal(ok.cpu(), oc)
        wall = float((hc.tri_id >= 12).float().mean())
        print(f"alpha fixture on the card through {route}: {rays[0].shape[0]} rays, ids and "
              f"valid equal to the CPU {ids_eq}, occlusion equal {occ_eq}, wall share {wall:.4f} "
              f"(the law {(1 - 77 / 255) ** 6:.4f}), t max abs {max_abs_diff(hk.t.cpu(), hc.t)}; "
              f"launches {got}", flush=True)
        check(ids_eq and occ_eq, f"the alpha traversal through {route} differs from the CPU's")
        check(all(got[k] > 0 for k in kernels), f"the alpha traversal through {route} launched "
                                                 f"{got}")


def pass_shapes_full_width(device):
    """Phase 27: the split at SPLIT_D on classroom 1920x1080 (pt.json, d12)
    at 1 spp, rendered SHAPE_RENDERS times through render_pt after a
    one-sample warm-up, with the counts reset before and read after each:
    Mpaths/s (the median and the spread), K1's and K4's launches a sample,
    peak device bytes a lane; then one sample by torch.profiler (device
    events, busy time) against an unprofiled one (the idle share). Returns
    the numbers."""
    import copy

    import numpy as np
    import torch

    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.film import Film
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_pt, render_sample_split
    from akari_render_tpu_torch.scene import load_scene

    task = RenderTask.from_file(CLASSROOM_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    scene = load_scene(str(CLASSROOM), device=device)
    filt = filter_from_config(task.filter_config)
    npix = scene.camera.width * scene.camera.height
    switches, shade, tier = PASS_SHAPES["split"]
    cfg = copy.copy(m)
    cfg.spp = cfg.spp_per_pass = 1
    runs = []
    with env_switch(**{"AKR_PALLAS_SHADE": "0", **switches}):
        render_pt(scene, cfg, task)  # a warm-up
        for r in range(SHAPE_RENDERS):
            if r == 0:
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            img, stats = render_pt(scene, cfg, task)
            got = read_launches()
            runs.append({"render_s": stats["total_time"],
                         "mpaths_s": npix / stats["total_time"] / 1e6, "launches": got,
                         "split_live": stats["split_live"]})
            if r == 0:
                peak = torch.cuda.max_memory_allocated()
    key = "classroom split"
    check(stats["tier"] == tier and stats["shade"] == shade,
          f"{key}: the {stats['tier']} tier, {stats['shade']} shade")
    check(bool(np.all(np.isfinite(img))) and float(img.mean()) > 0.0, f"{key}: image finiteness")
    rates = sorted(r["mpaths_s"] for r in runs)
    got = runs[0]["launches"]
    found = {"mpaths_s_median": rates[len(rates) // 2], "mpaths_s": rates,
             "k1_per_sample": got["K1"], "k4_per_sample": got["K4"],
             "peak_bytes_per_lane": peak / npix, "launches": got,
             "split_live": runs[0]["split_live"]}
    print(f"{key} at full width (1 spp, d12): Mpaths/s median {rates[len(rates) // 2]:.4f} over "
          f"{SHAPE_RENDERS} renders ({rates[0]:.4f}-{rates[-1]:.4f}), K1 {got['K1']:g} and K4 "
          f"{got['K4']:g} launches a sample, peak device memory {peak / 2**30:.3f} GiB "
          f"({peak / npix:.0f} B a lane); launches {got}, live {runs[0]['split_live']}",
          flush=True)

    def sample():
        with env_switch(**{"AKR_PALLAS_SHADE": "0", **switches}):
            film = Film.new(scene.camera.width, scene.camera.height, scene.device)
            render_sample_split(scene, settings, filt, 0, task.seed, task.sampler, SPLIT_D, film)

    t0 = time.perf_counter()
    (count, busy_ms), = device_events_per_call({key: sample}, busy=True).values()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sample()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    found.update(events_per_sample=count, busy_ms=busy_ms, sample_ms=wall_ms,
                 idle_share=1.0 - busy_ms / wall_ms)
    print(f"{key}, one sample (torch.profiler, device activity only): {count:g} device events, "
          f"device busy {busy_ms:.3f} ms; unprofiled {wall_ms:.3f} ms, device idle "
          f"{100 * (1.0 - busy_ms / wall_ms):.1f} %", flush=True)
    print(f"pass shapes profile: {time.perf_counter() - t0:.1f} s", flush=True)
    return {key: found}


def spectral_correctness(device):
    """Phase 28 (the module's docstring). Returns the launches of the two
    spectral 64^2 renders."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    cbox_method = method_file("cbox_spectral.json", CBOX_METHOD, color="spectral")
    launches = {}
    for name, scene, method in (("cbox", CBOX, cbox_method), ("prism", PRISM, PRISM_SPECTRAL)):
        out = OUT / f"{name}64_spectral.exr"
        reset_launches()
        t0 = time.perf_counter()
        stats = cli_main(["-s", str(scene), "-m", str(method), "--res", "64", "--spp", "16",
                          "-o", str(out), "--device", device])
        wall = time.perf_counter() - t0
        got = read_launches()
        launches[f"{name} 64^2 spectral"] = got
        check(stats["color"] == "spectral" and stats["tier"] == "wavefront"
              and stats["shade"] == "dispatch", f"{name} 64^2 spectral: {stats['color']}, "
                                                f"{stats['tier']}, {stats['shade']}")
        check(got["K1"] > 0 and all(got[k] == 0 for k in ("K2", "K3", "K4", "K5", "K7", "K8",
                                                           "K9")),
              f"{name} 64^2 spectral launches {got}")
        text = image_gates(f"{name} 64^2 spectral", read_exr(out),
                           np.load(testdata / f"{name}64_spectral_spp16.npy"),
                           np.load(testdata / f"{name}64_spectral_spp256.npy"), MEAN_TOL, MSE_RATIO)
        print(f"{name} 64^2 16spp d12 spectral ({wall:.2f} s CLI): {text}; launches and counts "
              f"{got}", flush=True)

    # the routes the JAX package keeps spectral renders off (pt.py:401-431,
    # common.py:592-596), on blinds, which takes each of them in RGB
    spectral_blinds = method_file("blinds_spectral.json", BLINDS_METHOD, color="spectral")
    images = {}
    for switch, rgb_route in (("", None), ("AKR_PALLAS_SHADE", "K9"), ("AKR_MEGAKERNEL", "K8")):
        with env_switch(**({switch: "1"} if switch else {})):
            for method in ((BLINDS_METHOD,) if switch else ()) + (spectral_blinds,):
                spectral = method == spectral_blinds
                out = OUT / f"blinds64_{'spectral' if spectral else 'rgb'}_{switch or 'pass'}.exr"
                reset_launches()
                stats = cli_main(["-s", str(BLINDS), "-m", str(method), "--res", "64", "--spp",
                                  str(SWITCH_SPP), "-o", str(out), "--device", device])
                got = read_launches()
                took = {"K9": got["K9"] > 0, "K8": got["K8"] > 0}
                if spectral:
                    images[switch] = read_exr(out)
                    check(stats["tier"] == "wavefront" and stats["shade"] == "dispatch"
                          and got["K8"] == got["K9"] == 0 and got["K1"] > 0,
                          f"blinds 64^2 spectral under {switch or 'no switch'}: {stats['tier']}, "
                          f"{stats['shade']}, launches {got}")
                else:
                    check(took[rgb_route], f"blinds 64^2 RGB under {switch} did not take "
                                           f"{rgb_route}: {stats['tier']}, launches {got}")
                print(f"blinds 64^2 {SWITCH_SPP}spp {'spectral' if spectral else 'RGB'} under "
                      f"{switch or 'no switch'}: {stats['tier']} tier, {stats['shade']} shade, "
                      f"K1 {got['K1']}, K8 {got['K8']}, K9 {got['K9']}", flush=True)
    for switch, img in images.items():
        check(np.array_equal(img, images[""]), f"blinds 64^2 spectral under {switch} differs "
                                               f"from the pass's image")
    spectral_functions_on_card(device)
    shader_fixture_on_card(device)
    return launches


def spectral_functions_on_card(device):
    """Phase 28: core/spectral.py on SPECTRAL_LANES seeded inputs, card
    against the CPU."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.core import spectral as sp

    rng = np.random.default_rng(28)
    n = SPECTRAL_LANES
    rgb = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    rgb[:256] = 0.0
    rgb[256:1024, 0] = 0.0
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    spec = rng.uniform(0.0, 5.0, (n, 4)).astype(np.float32)
    out = {}
    for dev in ("cpu", device):
        table = sp.device_table(dev)
        sw = sp.sample_wavelengths(torch.as_tensor(u, device=dev))
        c, scale = sp.uplift_unbounded(table, torch.as_tensor(rgb, device=dev))
        out[dev] = {k: v.cpu().numpy().astype(np.float64) for k, v in {
            "wavelengths": sw.lambdas, "uplift scale": scale, "uplift coefficients": c,
            "reflectance": sp.eval_reflectance(c, sw.lambdas), "CIE": sp.cie_xyz_bar(sw.lambdas),
            "D65": sp.illuminant_d65(sw.lambdas),
            "sRGB": sp.spectral_to_rgb(torch.as_tensor(spec, device=dev), sw.lambdas, sw.pdf),
        }.items()}
    want, got = out["cpu"], out[device]
    xyz = np.abs(want["CIE"] * (spec / (1.0 / 470.0))[..., None]).mean(-2).max(-1, keepdims=True)
    # (scale, tolerance); a lane's coefficients go by their largest
    scales = {"wavelengths": (None, 0.0), "uplift scale": (None, 0.0),
              "uplift coefficients": (np.abs(want["uplift coefficients"]).max(-1, keepdims=True),
                                      SPECTRAL_TOL),
              "reflectance": (1.0, SPECTRAL_TOL_DIV), "CIE": (1.0, SPECTRAL_TOL),
              "D65": (1.0, SPECTRAL_TOL_DIV), "sRGB": (xyz, SPECTRAL_TOL)}
    ratios = {}
    for k, (scale, _) in scales.items():
        if scale is None:
            ratios[k] = 0.0 if np.array_equal(got[k], want[k]) else float("inf")
        else:
            ratios[k] = float(np.max(np.abs(got[k] - want[k])
                                     / np.maximum(np.maximum(np.abs(want[k]), scale), 1e-30)))
    print(f"spectral functions on the card against the CPU, {n} seeded inputs (largest error "
          f"over the quantity's scale, 0 where equal): "
          + ", ".join(f"{k} {r:.3g}" for k, r in ratios.items()), flush=True)
    for k, (_, tol) in scales.items():
        check(ratios[k] <= tol, f"spectral {k}: the card is {ratios[k]:.3g} of its scale from "
                                f"the CPU (tolerance {tol:g})")


def shader_fixture_on_card(device):
    """Phase 28: the shader-ops fixture at FIXTURE_RES^2 on the card against
    the CPU, with the fused and the combinator principled."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_shader_scene import write_shader_scene

    from akari_render_tpu_torch.config import PTConfig
    from akari_render_tpu_torch.integrators.pt import render_pt
    from akari_render_tpu_torch.scene import load_scene

    path = write_shader_scene(OUT, FIXTURE_RES)
    table = load_scene(path, device=device).ggx_table_np
    cfg = PTConfig(spp=FIXTURE_SPP, spp_per_pass=FIXTURE_SPP, max_depth=FIXTURE_DEPTH)
    for fused in ("1", "0"):
        imgs, secs = [], []
        with env_switch(AKR_FUSED_PRINCIPLED=fused):
            for dev in ("cpu", device):
                scene = load_scene(path, device=dev, ggx_table=table)
                check(scene.shade_bake is None, "the shader-ops fixture baked")
                reset_launches()
                t0 = time.perf_counter()
                img, _ = render_pt(scene, cfg)
                secs.append(time.perf_counter() - t0)
                got = read_launches()
                check((got["K1"] > 0) == (dev != "cpu") and got["K8"] == got["K9"] == 0,
                      f"the shader-ops fixture on {dev} launched {got}")
                imgs.append(img)
        cpu, card = imgs
        check(bool(np.all(np.isfinite(card))) and float(card.mean()) > 0.0,
              "the shader-ops fixture's image on the card")
        m_rel = float(np.max(np.abs(card.mean((0, 1)) - cpu.mean((0, 1)))
                             / np.abs(cpu.mean((0, 1)))))
        off = float(np.mean(np.abs(card - cpu).max(-1)
                            > 1e-3 * np.maximum(np.abs(cpu).max(-1), 1.0)))
        print(f"shader-ops fixture {FIXTURE_RES}^2 {FIXTURE_SPP}spp d{FIXTURE_DEPTH}, "
              f"AKR_FUSED_PRINCIPLED={fused}: card against the CPU, means {card.mean((0, 1))} "
              f"(max rel {m_rel:.3g}), pixels off {off:.4g}, max abs "
              f"{float(np.abs(card - cpu).max()):.3g}; CPU {secs[0]:.2f} s, card {secs[1]:.2f} s",
              flush=True)
        check(m_rel <= FIXTURE_MEAN_REL and off <= FIXTURE_PIX_FRAC,
              f"the shader-ops fixture (AKR_FUSED_PRINCIPLED={fused}) on the card differs from "
              f"the CPU: means {m_rel:.3g}, pixels off {off:.4g}")


def spectral_full_width(device, rgb=None):
    """Phase 29 (the module's docstring); `rgb` is phase 21's result, whose
    pmj02bn row on the dispatch (the shade route spectral renders take) is
    the RGB row of the same call. Returns the spectral launches of K1 (cbox)
    and K2-K4 (classroom) and the printed numbers."""
    import copy

    import numpy as np
    import torch

    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_pt, render_sample
    from akari_render_tpu_torch.scene import load_scene

    def spectral_cfg(task, spp):
        cfg = copy.copy(task.method)
        cfg.spp = cfg.spp_per_pass = spp
        cfg.color = "spectral"
        return cfg

    def settings_of(task):
        m = task.method
        return PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect, color="spectral")

    def checked(label, img, stats, got, kernels):
        check(stats["color"] == "spectral" and stats["tier"] == "wavefront"
              and stats["shade"] == "dispatch", f"{label}: {stats['tier']}, {stats['shade']}")
        check(all(got[k] > 0 for k in kernels) and got["K8"] == got["K9"] == 0,
              f"{label} launches {got}")
        check(bool(np.all(np.isfinite(img))) and float(img.mean()) > 0.0, f"{label} image")

    found, samples = {}, {}
    # cbox 1024^2, pmj02bn, d12, CBOX_SPP samples a render
    scene, task, _, filt = cbox_setup(device)
    npix = 1024 * 1024
    render_pt(scene, spectral_cfg(task, 1), task)  # the warm-up
    runs = []
    for r in range(SPECTRAL_RENDERS):
        if r == 0:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        img, stats = render_pt(scene, spectral_cfg(task, CBOX_SPP), task)
        got = read_launches()
        if r == 0:
            peak = torch.cuda.max_memory_allocated()
        checked("cbox 1024^2 spectral", img, stats, got, ("K1",))
        runs.append({"mpaths_s": npix * CBOX_SPP / stats["total_time"] / 1e6, "launches": got})
    rates = sorted(r["mpaths_s"] for r in runs)
    found["cbox"] = {"mpaths_s_median": rates[len(rates) // 2], "mpaths_s": rates,
                     "k1_per_sample": runs[0]["launches"]["K1"] / CBOX_SPP,
                     "peak_bytes_per_lane": peak / npix, "launches": runs[0]["launches"]}
    print(f"cbox 1024^2 {CBOX_SPP}spp pmj02bn d12 spectral: Mpaths/s median "
          f"{rates[len(rates) // 2]:.4f} over {SPECTRAL_RENDERS} renders ({rates[0]:.4f}-"
          f"{rates[-1]:.4f}), K1 {found['cbox']['k1_per_sample']:g} launches a sample, peak "
          f"device memory {peak / 2**30:.3f} GiB ({peak / npix:.0f} B a lane); launches and "
          f"counts {runs[0]['launches']}", flush=True)
    cbox_settings = settings_of(task)
    samples["cbox spectral"] = lambda: render_sample(scene, cbox_settings, filt, 0, task.seed,
                                                     task.sampler)

    # classroom 1080p, 1 spp, d12, the static pair sweep
    ctask = RenderTask.from_file(CLASSROOM_METHOD)
    with env_switch(**TRAVERSALS["pairs-static"]):
        cscene = load_scene(str(CLASSROOM), device=device)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        img, stats = render_pt(cscene, spectral_cfg(ctask, 1), ctask)
        got = read_launches()
    cpix = 1920 * 1080
    cpeak = torch.cuda.max_memory_allocated()
    checked("classroom 1080p spectral", img, stats, got, ("K2", "K3", "K4"))
    check(stats["traversal"] == "pairs-static", f"classroom took {stats['traversal']}")
    found["classroom"] = {"mpaths_s": cpix / stats["total_time"] / 1e6,
                          "peak_bytes_per_lane": cpeak / cpix, "launches": got}
    print(f"classroom 1920x1080 1spp d12 spectral (pairs-static): render "
          f"{stats['total_time']:.3f} s ({cpix / stats['total_time'] / 1e6:.4f} Mpaths/s), "
          f"K2 {got['K2']}, K3 {got['K3']}, K4 {got['K4']} launches, peak device memory "
          f"{cpeak / 2**30:.3f} GiB ({cpeak / cpix:.0f} B a lane), image mean "
          f"{img.mean(axis=(0, 1))}", flush=True)
    cl_settings, cl_filt = settings_of(ctask), filter_from_config(ctask.filter_config)

    def classroom_sample():
        with env_switch(**TRAVERSALS["pairs-static"]):
            render_sample(cscene, cl_settings, cl_filt, 0, ctask.seed, ctask.sampler)

    samples["classroom spectral"] = classroom_sample

    # prism at its sensor's 256^2, PRISM_SPP samples, d12, dispersion
    ptask = RenderTask.from_file(PRISM_SPECTRAL)
    pscene = load_scene(str(PRISM), device=device)
    reset_launches()
    img, stats = render_pt(pscene, spectral_cfg(ptask, PRISM_SPP), ptask)
    got = read_launches()
    checked("prism 256^2 spectral", img, stats, got, ("K1",))
    check(pscene.has_dispersion, "prism has no dispersive glass")
    ppix = pscene.camera.width * pscene.camera.height
    m, mn = img.max(-1), img.min(-1)
    sat = float(((m - mn) / np.maximum(m, 1e-6))[m > 0.5].mean())
    found["prism"] = {"mpaths_s": ppix * PRISM_SPP / stats["total_time"] / 1e6, "launches": got}
    print(f"prism {pscene.camera.width}x{pscene.camera.height} {PRISM_SPP}spp d12 spectral: "
          f"render {stats['total_time']:.3f} s ({found['prism']['mpaths_s']:.4f} Mpaths/s), "
          f"K1 {got['K1']} launches, image mean {img.mean(axis=(0, 1))}, mean chroma of the "
          f"bright pixels {sat:.3f}", flush=True)

    t0 = time.perf_counter()
    events = device_events_per_call(samples, busy=True)
    for key, (count, busy_ms) in events.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        samples[key]()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        found[key.split()[0]].update(events_per_sample=count, busy_ms=busy_ms, sample_ms=wall_ms,
                                     idle_share=1.0 - busy_ms / wall_ms)
        print(f"{key}, one sample (torch.profiler, device activity only): {count} device events, "
              f"device busy {busy_ms:.3f} ms; unprofiled {wall_ms:.3f} ms, device idle "
              f"{100 * (1.0 - busy_ms / wall_ms):.1f} %", flush=True)
    print(f"spectral profile: {time.perf_counter() - t0:.1f} s", flush=True)
    if rgb is not None:
        r = rgb["pmj02bn dispatch"]
        rr = sorted(x["mpaths_s"] for x in r["runs"])
        c = found["cbox"]
        print(f"cbox 1024^2 pmj02bn d12 on the dispatch, spectral against RGB (phase 21, this "
              f"call): Mpaths/s "
              f"{c['mpaths_s_median']:.4f} ({c['mpaths_s'][0]:.4f}-{c['mpaths_s'][-1]:.4f}) "
              f"against {rr[len(rr) // 2]:.4f} ({rr[0]:.4f}-{rr[-1]:.4f}); device events a "
              f"sample {c['events_per_sample']} against {r['launches_per_sample']} "
              f"({c['events_per_sample'] / r['launches_per_sample']:.3f}x); busy "
              f"{c['busy_ms']:.3f} against {r['busy_ms']:.3f} ms; idle "
              f"{100 * c['idle_share']:.1f} against {100 * r['idle_share']:.1f} %; peak "
              f"{c['peak_bytes_per_lane']:.0f} against {r['runs'][0]['peak_bytes_per_lane']:.0f} B "
              f"a lane; K1 {c['k1_per_sample']:g} against "
              f"{r['runs'][0]['k1_launches'] / CBOX_SPP:g} launches a sample", flush=True)
    return found


def k9r_bound(lanes: int, live: int, table_numel: int):
    """(bound ms, by) of one K9r launch: a live lane's 104 B in and 49 B out
    (direct, wi, f, pdf, valid, roughness), a dead lane's 49 B of zeros, a
    flag a lane, the table once; K9R_LIVE_FLOPS a live lane."""
    return bound(float(K9R_LIVE_FLOPS) * live,
                 153.0 * live + 49.0 * (lanes - live) + lanes + 4.0 * table_numel)


def k9e_bound(lanes: int, live: int, dirs: int, table_numel: int):
    """(bound ms, by) of one K9e launch at `dirs` directions: a live lane
    reads its frame, ng and wo (60 B), the directions (12 B each) and a
    material id (4 B) and writes 16 B a direction, a dead lane its zeros,
    a flag a lane, the table once."""
    return bound(float(K9E_SETUP_FLOPS + dirs * K9E_DIR_FLOPS) * live,
                 (64.0 + 28.0 * dirs) * live + 16.0 * dirs * (lanes - live) + lanes
                 + 4.0 * table_numel)


def gpt_entries_phase(device) -> dict:
    """Phase 31: K9's roughness entry (K9r) and evaluation entry (K9e) at
    cbox-gpt-final's shapes. One GPT sample of cbox 1024^2 (gpt.json) on
    the card's default route, its first K9r call (the base path's first
    bounce) and first K9e calls of one and two directions (the first
    shift's first connection, at x'_{k-1} and at V) captured; each call
    again against its plain version (every output bit-equal, zeros on the
    dead lanes), its device time (profiler) against its bound and the
    plain version's time (CUDA events); the entries' resources; the
    sample's launches and counts. Returns the JSON entries."""
    import torch

    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.film import Film
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import gpt, gpt_reconnect, mcmc
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.scene import load_scene

    scene = load_scene(str(CBOX), device=device)
    task = RenderTask.from_file(CBOX_GPT)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee)
    filt = filter_from_config(task.filter_config)
    npix = scene.camera.width * scene.camera.height
    films = tuple(Film.new(scene.camera.width, scene.camera.height, device) for _ in range(6))
    pix = torch.arange(npix, device=device)

    def sample(idx):
        gpt.gpt_sample_films(scene, m, filt, settings, mcmc.sample_dimension(m.max_depth),
                             task.seed, "reconnect", films, idx, pix)

    def dirs(n):
        return lambda *a, **kw: len(a[6]) == n

    with env_switch(AKR_PALLAS_SHADE=None), \
            captured(gpt_reconnect, "fused_shade", keep=(0,)) as shade, \
            captured(gpt_reconnect, "fused_eval", want=dirs(1), keep=(0,)) as conn, \
            captured(gpt_reconnect, "fused_eval", want=dirs(2), keep=(0,)) as at_v:
        stats.reset()
        before = fs.launches, fs.rough_launches, fs.eval_launches
        sample(0)
        torch.cuda.synchronize()
        counts = dict(stats.counts)
        launches = {"K9": fs.launches - before[0], "K9r": fs.rough_launches - before[1],
                    "K9e": fs.eval_launches - before[2]}
    check(launches["K9"] == 0 and counts["dispatch_groups"] == 0
          and counts["gpt_fused_shades"] == launches["K9r"] + launches["K9e"] > 0,
          f"a cbox 1024^2 GPT sample took another route: {launches}, {counts}")
    check(len(shade.calls) == len(conn.calls) == len(at_v.calls) == 1,
          "the GPT sample made no K9r or K9e call")
    print(f"cbox 1024^2 GPT sample on the default route: launches {launches}, "
          f"gpt_fused_shades {counts['gpt_fused_shades']}, bounces' shades and evaluations "
          f"in {counts['gpt_shifts']} shifts", flush=True)
    tab_numel = scene.shade_bake[0].numel()
    entries = {}

    def check_call(name, label, kernel, plain, live, n_dirs):
        lanes = int(live.shape[0])
        n_live = int(live.sum())
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs_ = (list(got.items()) if isinstance(got, dict) else
                  [(f"{k}{d}", v) for d, pr in enumerate(got) for k, v in zip("fp", pr)])
        wants = (list(want.values()) if isinstance(want, dict) else
                 [v for pr in want for v in pr])
        equal = all(torch.equal(g, w) for (_, g), w in zip(pairs_, wants))
        dead_zero = all(not bool(g[~live].any()) for _, g in pairs_)
        check(equal, f"{name} differs from its plain version on {label}")
        check(dead_zero, f"{name} wrote a dead lane on {label}")
        ev = cuda_ms(kernel, 20)
        dev = device_ms(kernel, 20, "fused_shade_rough_kernel" if name == "K9r"
                        else "fused_eval_kernel")
        plain_ms = cuda_ms(plain, 3)
        b_ms, b_by = (k9r_bound(lanes, n_live, tab_numel) if name == "K9r" else
                      k9e_bound(lanes, n_live, n_dirs, tab_numel))
        print(f"{name} on {label} ({lanes} lanes, {n_live} live): every output bit-equal to "
              f"the plain version, zeros on the dead lanes; kernel {dev:.4f} ms device time "
              f"(profiler; CUDA events {ev:.4f} ms), {100 * b_ms / dev:.1f} % of its bound "
              f"{b_ms:.4f} ms by {b_by}; plain {plain_ms:.4f} ms", flush=True)
        entries[f"{name} {label}"] = {"lanes": lanes, "live": n_live, "ms": dev, "event_ms": ev,
                                      "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms}

    a, kw = shade.calls[0]
    check_call("K9r", "the base path's first bounce",
               lambda: fs.fused_shade(*a, **kw), lambda: fs.fused_shade_torch(*a, **kw),
               kw["live"], 0)
    for call, label in ((conn, "the first shift connection at x'_{k-1}"),
                        (at_v, "the first shift connection at V")):
        a, kw = call.calls[0]
        check_call("K9e", label, lambda: fs.fused_eval(*a, **kw),
                   lambda: fs.fused_eval_torch(*a, **kw), kw["live"], len(a[6]))
    del shade, conn, at_v, a, kw
    info = fs.entries_info(scene.shade_bake)
    for k, v in info.items():
        print(f"{k} resources (cbox's table): {v['registers']} registers a thread, "
              f"{v['local_bytes']} B local memory, {v['threads']} threads a block, "
              f"{v['blocks_per_sm']} blocks resident an SM", flush=True)
    return {"entries": entries, "sample_launches": launches, "sample_counts": counts,
            "resources": info}


def build_all():
    """Phases 2, 6, 10 and 15: one nvcc per kernel source, started together,
    and beside them the host's pmj02 tables (core/pmj02.py, cached in
    build/cache/) for phases 19-21."""
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.core import pcg
    from akari_render_tpu_torch.core.pmj02 import get_pmj02_tables
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    errors = []

    def run(build):
        try:
            build()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(b,))
               for b in (k1.build, pairs.build, wide.build, mk.build, fs.build, pcg.build,
                         get_pmj02_tables)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    print(f"K1 build: nvcc {k1.build_seconds:.3f} s", flush=True)
    print(f"K2-K6 build: nvcc {pairs.build_seconds:.3f} s; K7 build: nvcc "
          f"{wide.build_seconds:.3f} s", flush=True)
    print(f"K8 build: nvcc {mk.build_seconds:.3f} s; K9 build: nvcc {fs.build_seconds:.3f} s; "
          f"pcg32_draws build: nvcc {pcg.build_seconds:.3f} s ({wall:.3f} s for the six builds "
          f"and the pmj02 tables, in parallel)", flush=True)
    # K3 at classroom's 4,633 candidates, K8 and K9 at blinds' tables: the
    # shapes of their main paths
    scene, _, settings, filt = blinds_setup("cuda")
    tb = mk.pass_tables(scene, settings, filt, 0)
    info = {**k1.kernel_info(), **pairs.kernel_info(), **wide.kernel_info(),
            **mk.kernel_info(tb), **fs.kernel_info(scene.shade_bake)}
    for k in sorted(info):
        v = info[k]
        print(f"{k} resources: {v['registers']} registers a thread, {v['static_smem']} + "
              f"{v['dynamic_smem']} B shared memory (static + dynamic), {v['local_bytes']} B local "
              f"memory, {v['threads']} threads a block, {v['blocks_per_sm']} blocks resident an SM",
              flush=True)
    return info


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from akari_render_tpu_torch.core.math import disable_tf32
    from akari_render_tpu_torch.scene import load_scene

    query = gpu_query()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} ({query}); torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    disable_tf32()
    device = "cuda"
    OUT.mkdir(parents=True, exist_ok=True)

    info = build_all()
    lap("phases 2, 6, 10 and 15 (build)")
    if ONLY:  # a quick check of some phases; prints no result
        if 11 in ONLY:
            k9_parity(device)
            lap("phase 11")
        if 14 in ONLY:
            blinds_full_width(device)
            lap("phase 14")
        rgb_cbox = None
        if 21 in ONLY:
            rgb_cbox = cbox_full_width(device)
            lap("phase 21")
        if 23 in ONLY:
            gpt_correctness(device)
            lap("phase 23")
        if 26 in ONLY:
            pass_shapes_correctness(device, classroom_correctness(device))
            lap("phase 26")
        if 27 in ONLY:
            pass_shapes_full_width(device)
            lap("phase 27")
        if 28 in ONLY:
            spectral_correctness(device)
            lap("phase 28")
        if 29 in ONLY:
            spectral_full_width(device, rgb_cbox)
            lap("phase 29")
        if 30 in ONLY:
            print(json.dumps({"pcg32_draws": pcg_kernel_phase(device)}), flush=True)
            lap("phase 30")
        if 31 in ONLY:
            print(json.dumps({"gpt_entries": gpt_entries_phase(device)}), flush=True)
            lap("phase 31")
        return
    scene = load_scene(str(SCENE), device=device)
    entry = k1_parity(scene, device)
    pcg_parity(device)
    lap("phase 3 (K1 parity)")
    slice_correctness(device)
    lap("phase 4 (matbox 64^2)")
    entry["launches"], entry["main_path"] = full_width(device)
    lap("phase 5 (matbox 512^2)")

    pair_entries, ctx = pairs_parity(device)
    lap("phase 7 (K2/K3/K4/K6 parity)")
    other = other_traversals_parity(ctx, device)
    del ctx  # its tensors would count in the renders' peak memory
    lap("phase 16 (K7 and K5 parity)")
    base96 = classroom_correctness(device)
    lap("phase 8 (classroom 96^2)")
    launches, timings = classroom_full_width(device)
    for k in ("K2", "K3", "K4"):
        pair_entries[k]["launches"] = launches[k]
    pair_entries["K3"]["main_path"] = timings["K3"]
    pair_entries["K4"]["main_path"] = timings["K4"]
    lap("phase 9 (classroom 1080p)")
    for traversal in ("wide", "pairs-windowed"):
        classroom_correctness(device, traversal, base96)
    lap("phase 17 (classroom 96^2, wide and windowed)")
    launches, timings = classroom_full_width(device, "wide")
    other["K7"]["launches"], other["K7"]["main_path"] = launches["K7"], timings["K7"]
    launches, timings = classroom_full_width(device, "pairs-windowed")
    other["K5"]["launches"], other["K5"]["main_path"] = launches["K5"], timings["K5"]
    lap("phase 18 (classroom 1080p, wide and windowed)")

    fused = {"K9": k9_parity(device)}
    lap("phase 11 (K9 parity)")
    fused["K8"] = k8_parity(device)
    lap("phase 12 (K8 parity)")
    blinds_correctness(device)
    lap("phase 13 (blinds 64^2)")
    for k, c in blinds_full_width(device).items():
        fused[k]["launches"] = c
    lap("phase 14 (blinds 256^2)")

    sampler_parity(device)
    lap("phase 19 (sampler parity)")
    cbox_correctness(device)
    lap("phase 20 (cbox 64^2)")
    rgb_cbox = cbox_full_width(device)
    fused["K9"]["cbox_first_bounce"] = rgb_cbox.pop("k9")
    lap("phase 21 (cbox 1024^2)")
    aov_phase(device)
    lap("phase 22 (AOV)")
    gpt_correctness(device)
    lap("phase 23 (GPT cbox 64^2)")
    mcmc_correctness(device)
    lap("phase 24 (MCMC cbox 64^2)")
    gpt_mcmc_full_width(device)
    lap("phase 25 (GPT and MCMC cbox 1024^2)")
    shape_launches = pass_shapes_correctness(device, base96)
    lap("phase 26 (the split at cbox 64^2 and classroom 96^2; alpha)")
    shapes = pass_shapes_full_width(device)
    lap("phase 27 (the split at classroom 1080p)")
    spectral_launches = spectral_correctness(device)
    lap("phase 28 (spectral cbox and prism 64^2, the routes, the functions, the shader ops)")
    spectral = spectral_full_width(device, rgb_cbox)
    lap("phase 29 (spectral at full width)")
    pcg_entry = pcg_kernel_phase(device)
    lap("phase 30 (pcg32_draws, an MCMC job)")
    gpt_entries = gpt_entries_phase(device)
    lap("phase 31 (K9's roughness and evaluation entries, a GPT sample)")

    kernels = [entry, *pair_entries.values(), other["K5"], other["K7"], fused["K8"], fused["K9"]]
    for k in kernels:  # the pass shapes' launches
        name = k["name"].split()[0]
        got = {**{r: c[name] for r, c in shape_launches.items() if c[name]},
               **{r: v["launches"][name] for r, v in shapes.items() if v["launches"][name]}}
        if got:
            k["pass_shapes"] = {"launches": got}
    for k in kernels:  # the spectral renders' launches
        name = k["name"].split()[0]
        got = {**{r: c[name] for r, c in spectral_launches.items() if c[name]},
               **{f"{w} full width": v["launches"][name] for w, v in spectral.items()
                  if v["launches"][name]}}
        if got:
            k["spectral"] = {"launches": got}
    for k in kernels:  # K6 is K4's kernel
        res = info[k["name"].split()[0].replace("K6", "K4")]
        k["registers"], k["blocks_per_sm"] = res["registers"], res["blocks_per_sm"]
    print(json.dumps({"kernels": [*kernels, pcg_entry], "gpt_entries": gpt_entries}))
    print(gpu_query())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


# `--only 26,27`: the build and those phases alone (26 after phase 8's
# image; 11, 14, 21, 23 and 26-31 can be named), for a quick check on the
# card; the full run takes no arguments
ONLY = ({int(x) for x in sys.argv[sys.argv.index("--only") + 1].split(",")}
        if "--only" in sys.argv else set())

if __name__ == "__main__":
    main()
