"""What the benchmark knows of a cell: its entries in BENCHMARK.json, its
configuration, traffic and metric files (found by name), the sampler key
each job gets from the seed, and the system under test, driven through the
public entry of the configuration's method: `integrators.pt.render_pt`
("pt"), `integrators.mcmc.render_mcmc` ("mcmc_opt", Kelemen PSSMLT) or
`integrators.gpt.render_gpt` ("gpt", the gradient-domain path tracer).

Nothing here imports the system under test at module level: the self-check
and the tests import this file on any machine.
"""
from __future__ import annotations

import importlib.util
import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent  # the checkout: BENCHMARK.json and the system under test
MASK32 = 0xFFFFFFFF
TRAVERSAL_RANGE = "bench.traversal"
SHIFT_RANGE = "bench.shift"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, spec: dict | None = None) -> dict:
    spec = spec or benchmark()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_file(name: str, spec: dict | None = None) -> Path:
    spec = spec or benchmark()
    for c in spec["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise SystemExit(f"no config named {name!r} in BENCHMARK.json")


def load_config(name: str, spec: dict | None = None) -> dict:
    return json.loads(config_file(name, spec).read_text())


def traffic_file(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def load_traffic(name: str) -> dict:
    return json.loads(traffic_file(name).read_text())


def metric_file(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def metric_reader(name: str):
    """The `read(run) -> float | None` of bench_torch/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mix64(x: int) -> int:
    """splitmix64's finaliser: a well-mixed 64-bit value of x."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def job_key(seed: int, job: int) -> int:
    """The sampler seed of job `job` of a run with --seed `seed`: 32 bits,
    as the samplers keep their seed."""
    return mix64(mix64(seed) ^ (job + 1) * 0x9E3779B97F4A7C15) & MASK32


def unit_draw(seed: int, job: int, salt: int) -> float:
    """A uniform draw in [0, 1) from (seed, job, salt)."""
    return (mix64(job_key(seed, job) ^ mix64(salt)) >> 11) / float(1 << 53)


def clear_route_switches() -> list[str]:
    """Unset every AKR_* switch, so the default route runs; returns the
    names that were set."""
    found = sorted(k for k in os.environ if k.startswith("AKR_"))
    for k in found:
        del os.environ[k]
    return found


class Program:
    """The system under test: the scene loaded onto `device` and one
    render job = one call of the method's entry of `spp` samples of every
    pixel, keyed by the job's sampler seed, ending with the developed image
    on the host. For "mcmc_opt" a job's samples are mutations a pixel; for
    "gpt" a sample is a base path and its four shifts a pixel."""

    def __init__(self, conf: dict, device, width: int | None = None, height: int | None = None):
        import torch

        from akari_render_tpu_torch.config import GPTConfig, MCMCConfig, PTConfig
        from akari_render_tpu_torch.integrators import gpt, mcmc, pt
        from akari_render_tpu_torch.scene import load_scene

        self.torch, self.pt, self.mcmc, self.gpt, self.conf = torch, pt, mcmc, gpt, conf
        self.mcmc_config_cls, self.gpt_config_cls = MCMCConfig, GPTConfig
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.scene = load_scene(str(ROOT / conf["scene"]), width or conf["width"],
                                height or conf["height"], device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.load_s = time.perf_counter() - t0
        self.width, self.height = self.scene.camera.width, self.scene.camera.height
        self.method = conf["method"]
        self.config_cls = PTConfig

    def render(self, key: int, spp: int):
        """(image [H, W, 3] numpy float32, the entry's stats)."""
        if self.method["type"] == "mcmc_opt":
            return self.render_mcmc(key, spp)
        if self.method["type"] == "gpt":
            return self.render_gpt(key, spp)
        m = dict(self.method, spp=spp, spp_per_pass=spp)
        task = SimpleNamespace(filter_config=self.conf["film"]["filter"], seed=0,
                               sampler=dict(self.conf["sampler"], seed=key))
        return self.pt.render_pt(self.scene, self.config_cls.from_json(m), task)

    def render_mcmc(self, key: int, spp: int):
        """One render_mcmc call of `spp` mutations a pixel. The key is the
        task's seed, from which the bootstrap, its fallback and the chains
        draw; the task's sampler has seed 0, so the direct pass's render_pt
        draws from the key too (0 ^ key). The stats gain the route keys
        (_route)."""
        m = dict(self.method, spp=spp)
        task = SimpleNamespace(filter_config=self.conf["film"]["filter"], seed=key,
                               sampler=dict(self.conf["sampler"], seed=0))
        img, stats = self.mcmc.render_mcmc(self.scene, self.mcmc_config_cls.from_json(m), task)
        return img, self._route(stats)

    def render_gpt(self, key: int, spp: int):
        """One render_gpt call of `spp` samples a pixel. The key is the
        task's seed, from which render_gpt draws every pixel's PSS stream
        (it reads no sampler). The stats (with the primal, gx and gy films)
        gain the route keys, as render_mcmc's do."""
        m = dict(self.method, spp=spp)
        task = SimpleNamespace(filter_config=self.conf["film"]["filter"], seed=key)
        img, stats = self.gpt.render_gpt(self.scene, self.gpt_config_cls.from_json(m), task)
        return img, self._route(stats)

    def _route(self, stats: dict) -> dict:
        """The route keys that render_pt's stats carry: tier and traversal
        from the scene, and the colour, RGB (the MCMC chains and the GPT
        paths trace RGB)."""
        traversal = self.scene.traversal
        stats.update(tier="flat" if traversal == "flat (K1)" else "cluster", traversal=traversal,
                     color="rgb")
        return stats

    def free(self):
        """Drop the scene and every cached block of device memory."""
        self.scene = None
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()


class Intercept:
    """Harness-owned wrappers around the scene's public traversal methods
    (Scene.intersect, Scene.occlude), set as instance attributes for one
    job and removed after it. `capture` keeps, for a fixed sample of lanes
    of each call (the same lanes for every call of one size), the rays and
    the answers the program gave, and counts each call's live rays, all on
    the device without a host read; `ranges` opens a profiler range named
    TRAVERSAL_RANGE around each call, and one named SHIFT_RANGE around each
    call of the GPT integrator's shifted path (gpt.trace_shift_reconnect,
    the module attribute that render_gpt calls)."""

    def __init__(self, scene, lanes: int, seed: int):
        self.scene, self.lanes, self.seed = scene, lanes, seed
        self.index: dict[int, object] = {}
        self.records: list = []
        self.live: list = []
        self.shift_real = None

    def lane_index(self, n: int):
        if n not in self.index:
            import torch

            g = torch.Generator(device="cpu").manual_seed(mix64(self.seed) & ((1 << 63) - 1))
            idx = torch.randperm(n, generator=g)[:min(n, self.lanes)]
            self.index[n] = idx.sort().values.to(self.scene.device)
        return self.index[n]

    def install(self, capture: bool, ranges: bool):
        import torch

        scene = self.scene
        real = {"intersect": type(scene).intersect, "occlude": type(scene).occlude}

        def wrap(kind):
            def call(o, d, tmin, tmax, *args, **kw):
                if ranges:
                    with torch.profiler.record_function(TRAVERSAL_RANGE):
                        out = real[kind](scene, o, d, tmin, tmax, *args, **kw)
                else:
                    out = real[kind](scene, o, d, tmin, tmax, *args, **kw)
                if capture:
                    self._keep(kind, o, d, tmin, tmax, out)
                return out
            return call

        scene.intersect = wrap("intersect")
        scene.occlude = wrap("occlude")
        if ranges:
            from akari_render_tpu_torch.integrators import gpt

            real_shift = self.shift_real = gpt.trace_shift_reconnect

            def shift(*args, **kw):
                with torch.profiler.record_function(SHIFT_RANGE):
                    return real_shift(*args, **kw)
            gpt.trace_shift_reconnect = shift

    def remove(self):
        for k in ("intersect", "occlude"):
            self.scene.__dict__.pop(k, None)
        if self.shift_real is not None:
            from akari_render_tpu_torch.integrators import gpt

            gpt.trace_shift_reconnect, self.shift_real = self.shift_real, None

    def _keep(self, kind, o, d, tmin, tmax, out):
        import torch

        n = o.shape[0]
        idx = self.lane_index(n)
        tmin = torch.as_tensor(tmin, dtype=torch.float32, device=o.device).expand(n)
        rays = torch.cat([o.expand(n, 3), d, tmin[:, None], tmax[:, None]], 1).index_select(0, idx)
        if kind == "intersect":
            ans = torch.stack([out.t, out.valid.to(torch.float32)], 1).index_select(0, idx)
        else:
            ans = out.to(torch.float32).index_select(0, idx)[:, None]
        self.records.append((kind, n, rays, ans))
        self.live.append((tmax > tmin).sum())

    def take(self):
        """The records of the job (moved to the host) and its live rays."""
        recs = [(k, n, r.cpu(), a.cpu()) for k, n, r, a in self.records]
        live = int(sum(self.live).item()) if self.live else 0
        calls = len(self.records)
        self.records, self.live = [], []
        return recs, live, calls
