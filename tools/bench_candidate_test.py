"""Time the cluster tier's walks (K4, the pair sweep's candidate walk, and
K7, the wide-BVH walk) on chip_smoke.py's 2^18 classroom rays, as built and
with single steps of their design taken out, to show what each step pays.

    python tools/bench_candidate_test.py [--reps 10] [--render] [--out build/bench_candidate_test.json]

Needs one NVIDIA GPU and nvcc. A variant is the package's csrc/ copied to
build/variants/<name>/ with a few lines replaced (each replacement must
find its text, so a variant cannot silently measure the unchanged source):

- as_built: the sources as they are (run first and last: the spread);
- no_prefetch: K4 waits for the next candidate's copy right after starting
  it, and K7 never starts the next leaf's copy early;
- three_blocks: __launch_bounds__(512, 3), which caps the walks at 40
  registers a thread for a third resident block an SM.

Every variant must give as_built's `best`, bit for bit. With --render each
variant also renders classroom 1920x1080, 1 spp by the static pair sweep and
by the wide walk, and the K4 and K7 launches of those renders are timed.
Prints one line per variant and writes them, with the card's name and power
limit, as JSON.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root's: its rays, timers and switches)

PAIRS, WIDE = "pairs.cu", "wide.cu"
VARIANTS = {
    "as_built": [],
    "no_prefetch": [
        (PAIRS, "ci_next,\n                           C);",
         "ci_next,\n                           C), akr::stage_wait();"),
        (WIDE, "if (sp > 0 && s_sid[sp - 1] < -1 && s_se[sp - 1] <= horizon) {", "if (false) {"),
    ],
    "three_blocks": [
        (PAIRS, "__launch_bounds__(akr::kMaxLanes, 2)", "__launch_bounds__(akr::kMaxLanes, 3)"),
        (WIDE, "__launch_bounds__(kMaxLanes, 2)", "__launch_bounds__(kMaxLanes, 3)"),
    ],
}


def use_variant(name: str):
    """Point the K2-K7 wrappers at a patched copy of csrc/ and drop their
    loaded libraries."""
    from akari_render_tpu_torch.accel import nvcc, pairs, wide

    src = ROOT / "akari_render_tpu_torch" / "csrc"
    dst = ROOT / "build" / "variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, old, new in VARIANTS[name]:
        text = (dst / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {fname} holds {text.count(old)} times: {old!r}")
        (dst / fname).write_text(text.replace(old, new))
    nvcc.CSRC = dst  # the build key covers the headers there
    pairs.SOURCE, wide.SOURCE = dst / PAIRS, dst / WIDE
    pairs._lib = wide._lib = None


def render_1080p(device) -> dict:
    """Classroom 1920x1080, 1 spp through the CLI by the static pair sweep
    and by the wide walk: the mean milliseconds of the 25 K4 or K7 launches
    of each render (CUDA events, chip_smoke.timed_walks) and its Mpaths/s."""
    from akari_render_tpu_torch.cli import main as cli_main

    out = {}
    for traversal, kernel in (("pairs-static", "K4"), ("wide", "K7")):
        exr = ROOT / "build" / "variants" / f"classroom_{traversal}.exr"
        with chip_smoke.env_switch(**chip_smoke.TRAVERSALS[traversal]), \
                chip_smoke.timed_walks() as walks:
            stats = cli_main(["-s", str(chip_smoke.CLASSROOM), "-m",
                              str(chip_smoke.CLASSROOM_METHOD), "-o", str(exr), "--device", device])
        t = walks.summary()[kernel]
        out[f"{kernel}_1080p_ms"] = t["ms"]
        out[f"{kernel}_1080p_launches"] = t["launches"]
        out[f"{traversal}_mpaths_per_s"] = 1920 * 1080 / stats["total_time"] / 1e6
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--render", action="store_true",
                    help="also render classroom 1080p per variant and time its K4 / K7 launches")
    ap.add_argument("--out", default=str(ROOT / "build" / "bench_candidate_test.json"))
    args = ap.parse_args()

    import torch

    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.core.math import disable_tf32
    from akari_render_tpu_torch.scene import load_scene

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    disable_tf32()
    device = "cuda"
    scene = load_scene(str(chip_smoke.CLASSROOM), device=device)
    cl = scene.arrays.unified
    o, d, tmin, tmax, _ = chip_smoke.classroom_rays(scene, cl, device)
    cb6 = pairs.cluster_bounds(cl)
    boxes = pairs.candidate_test_boxes(cl, cb6)
    s = pairs.sort_rays(cl, o, d, tmin, tmax)
    sw = pairs.sort_rays(cl, o, d, tmin, tmax, dead_last=False)

    def k4(any_hit):
        return pairs.sweep_walk(*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex,
                                s.best0, any_hit, boxes=boxes)

    def k7(any_hit):
        return wide.wide_walk(cl.wide, cl.tri, cl.xf, sw.o_soa, sw.d_soa, sw.lim, sw.ex, sw.best0,
                              any_hit, boxes=boxes)

    card = chip_smoke.gpu_query()
    rows, want = [], None
    for name in ("as_built", "no_prefetch", "three_blocks", "as_built"):
        use_variant(name)
        order = pairs.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim,
                                  pairs.cull_einit(s.summ, cb6))[1:]
        got = [k4(False), k4(True), k7(False), k7(True)]
        torch.cuda.synchronize()
        if want is None:
            want = got
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"variant {name} changed a hit")
        info = {**pairs.kernel_info(), **wide.kernel_info()}
        row = {"variant": name,
               "K4_ms": chip_smoke.cuda_ms(lambda: k4(False), args.reps),
               "K4_any_ms": chip_smoke.cuda_ms(lambda: k4(True), args.reps),
               "K7_ms": chip_smoke.cuda_ms(lambda: k7(False), args.reps),
               "K7_any_ms": chip_smoke.cuda_ms(lambda: k7(True), args.reps),
               **{f"{k}_{f}": info[k][f] for k in ("K4", "K7")
                  for f in ("registers", "local_bytes", "blocks_per_sm")}}
        if args.render:
            row.update(render_1080p(device))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rays": int(o.shape[0]), "rows": rows}, indent=1) + "\n")


if __name__ == "__main__":
    main()
