"""A CPU rehearsal of the benchmark; it measures nothing and prints no metric.

    python3 bench_torch/selfcheck.py [--size 24]

1. BENCHMARK.json: its keys, and every name, unit and `why` within the
   contract's characters and lengths; each cell's configuration, traffic
   and metric files resolve by name (a new file is found the same way);
   every `moves` is an end-to-end metric and every `workloads` entry a cell;
   each configuration file lists the same `reduced` keys, each with its
   published value (`source_<key>`) and an `assumed` line.
2. The compulsory-bytes count of traversal_roofline_pct on each
   configuration's counts.
3. Each traffic mix drives two jobs of each of its cells at --size pixels
   on the CPU, through the plain versions of the kernels; an MCMC cell's
   chains and bootstrap are cut with the pixels (scaled_method), a GPT
   cell's jobs keep their samples and shifts.

The measuring path itself (run.py) refuses to run without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text_ok(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def check_spec(spec: dict) -> list[str]:
    errs = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    need(set(spec) == TOP_KEYS, f"top-level keys {sorted(spec)}")
    need(1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  for p in spec["paths"]), "paths")
    need(len(spec["command"]) <= 32 and all(text_ok(w) for w in spec["command"]), "command")
    need(isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51, "run_seconds")
    names = set()
    for kind, keys in KEYS.items():
        for e in spec[kind]:
            extra = set(e) - keys - ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
            need(keys <= set(e) and not extra, f"{kind} {e.get('name')}: keys {sorted(e)}")
            need(bool(NAME.match(e["name"])), f"name {e['name']!r}")
            need(e["name"] not in names, f"name {e['name']!r} twice")
            names.add(e["name"])
            if "unit" in e:
                need(bool(UNIT.match(e["unit"])), f"unit {e['unit']!r}")
                need(e["better"] in ("lower", "higher"), f"{e['name']}: better")
            for k in ("why", "layer", "source"):
                if k in e:
                    need(text_ok(e[k]), f"{e['name']}: {k}")
    cells = {w["name"]: w for w in spec["workloads"]}
    confs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    need("setup_s" in e2e, "setup_s missing")
    for c in spec["configs"]:
        need(any(c["file"].startswith(p + "/") for p in spec["paths"]), f"{c['name']}: file")
        need((harness.ROOT / c["file"]).is_file(), f"{c['name']}: {c['file']} missing")
        need(len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"]),
             f"{c['name']}: reduced")
        if (harness.ROOT / c["file"]).is_file():
            f = json.loads((harness.ROOT / c["file"]).read_text())
            need(f.get("reduced") == c["reduced"], f"{c['name']}: the file's reduced differs")
            need(all(f"source_{k}" in f and k in f.get("assumed", {}) for k in c["reduced"]),
                 f"{c['name']}: a reduced key without its source_ value or its assumed line")
        need(any(w["config"] == c["name"] for w in cells.values()), f"{c['name']}: no cell")
    for w in cells.values():
        need(w["config"] in confs, f"{w['name']}: config {w['config']!r}")
        need(NAME.match(w["traffic"]) and harness.traffic_file(w["traffic"]).is_file(),
             f"{w['name']}: traffic {w['traffic']!r} has no file")
        need(w["chips"] in (1, 4), f"{w['name']}: chips")
    for m in spec["end_to_end"] + spec["per_layer"]:
        need(harness.metric_file(m["name"]).is_file(), f"metric {m['name']} has no reader")
        need(all(x in cells for x in m.get("workloads", [])), f"{m['name']}: workloads")
    for m in spec["end_to_end"]:
        need(m["source"] in ("host_clock", "device_trace"), f"{m['name']}: source")
        need(0 < m["bound"] <= 0.25, f"{m['name']}: bound")
    for m in spec["per_layer"]:
        need(m["moves"] in e2e, f"{m['name']}: moves {m['moves']!r}")
        need(m["source"] in ("device_trace", "program_span", "program_counter", "host_clock"),
             f"{m['name']}: source")
    for w in cells:
        for kind in ("end_to_end", "per_layer"):
            need(any("workloads" not in m or w in m["workloads"] for m in spec[kind]
                     if m["name"] != "setup_s"), f"{w}: no {kind} metric")
    need(len(json.dumps(spec)) <= 64 * 1024, "BENCHMARK.json over 64 KiB")
    return errs


def bytes_counts() -> None:
    spec = importlib.util.spec_from_file_location(
        "traversal_bytes", harness.BENCH / "metrics" / "traversal_bytes.py")
    tb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tb)
    from bench_torch.reference import scene as ref_scene

    for c in harness.benchmark()["configs"]:
        conf_name = c["name"]
        conf = harness.load_config(conf_name)
        ref = ref_scene.load(harness.ROOT / conf["scene"])
        rays = conf["width"] * conf["height"]
        print(f"{conf_name}: {ref.n_unique_tris} triangles, {ref.n_instances} instances: "
              f"{tb.scene_bytes(ref.n_unique_tris, ref.n_instances)} B of scene a call; a call of "
              f"{rays} live rays needs {tb.call_bytes(rays, ref.n_unique_tris, ref.n_instances)} B")


def scaled_method(method: dict, pixels: int, full_pixels: int) -> dict:
    """An MCMC method with its chains and bootstrap cut in proportion to the
    pixels (at least 16 chains), so that a chain makes as many steps a job
    as at full size and the bootstrap draws as many candidates a chain;
    any other method as it is (a PT or GPT sample is one path, or one base
    path and its shifts, a pixel, at any size)."""
    if method["type"] != "mcmc_opt":
        return method
    chains = max(16, method["n_chains"] * pixels // full_pixels)
    return dict(method, n_chains=chains,
                n_bootstrap=method["n_bootstrap"] * chains // method["n_chains"])


def drive(size: int) -> None:
    from bench_torch import loop

    spec = harness.benchmark()
    for w in spec["workloads"]:
        conf = harness.load_config(w["config"], spec)
        traffic = harness.load_traffic(w["traffic"])
        scale = size / max(conf["width"], conf["height"])
        wh = max(2, round(conf["width"] * scale)), max(2, round(conf["height"] * scale))
        conf = dict(conf, method=scaled_method(conf["method"], wh[0] * wh[1],
                                               conf["width"] * conf["height"]))
        prog = harness.Program(conf, "cpu", *wh)
        ic = harness.Intercept(prog.scene, traffic["lanes_checked"], 1)
        spp = loop.job_spp(traffic, conf)
        win = loop.run_window(prog, ic, traffic, 1, 1e9, spp, max_jobs=2)
        print(f"{w['name']}: {len(win['jobs'])} jobs of {spp} spp at {wh[0]}x{wh[1]} "
              f"({len(win['checked'])} checked, {sum(len(c['records']) for c in win['checked'])} "
              f"traversal calls kept)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=24, help="the larger image side of the drive")
    args = ap.parse_args()
    errs = check_spec(harness.benchmark())
    for e in errs:
        print(f"BENCHMARK.json: {e}")
    print(f"BENCHMARK.json: {len(errs)} problems")
    bytes_counts()
    drive(args.size)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
