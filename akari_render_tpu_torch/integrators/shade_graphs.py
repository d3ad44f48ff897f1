"""The per-kind dispatch shade of the reconnection shift, replayed as CUDA
graphs.

A GPT sample evaluates a kind's closure about 90 times on cbox (each
bounce of the base path and of the four shifts, and each connection's two
re-evaluations), each call 300 to 1,800 eager launches over as many lanes
as the group holds. Issuing them is most of a job's host time, and the
card idles under it. shade() answers as common.dispatch_shade does, with
its host read (kind_rows: the group's row count sizes the work), its span
and its counter, but on a CUDA device each kind's group is one graph
replay:

- the group's R rows are padded to a bucket size B >= R with the first
  row repeated, and the closure's inputs (the interaction's mat, uv, p,
  ng and frame, and every tensor of `extra`) are gathered at those rows
  into fixed buffers, a few eager launches;
- the graph builds the kind's closure over the B rows, calls the site's
  function on it and copies each output into a fixed buffer;
- the first R rows of each output go to the group's lanes, as
  dispatch_shade's scatter puts them.

A call site (its function, the kind, the wavefront's width and the
inputs' names, shapes and dtypes) captures its graphs at its first call:
one for each bucket up to the width (1,024 x 2^i and 1,536 x 2^i below
it, then the width itself), after one eager run at the width on the
capture stream, with the call's own lanes in the buffers. That is set-up
work, paid by a process's first job at that width. The sites are kept on
the scene (Scene.shade_graphs) and share one memory pool: a replay's
temporaries live in the pool, and the tensors kept between replays (the
fixed buffers) outside it. Graphs never run at once, so the pool is safe
to share.

A lane's answer is computed by the same launches on the same values as in
the eager dispatch; only the number of rows they cover differs (the
padding). The closures' host constants (svm/eval.py: copies to the device,
which a graph cannot capture) are copied once, at the eager run, and kept
with the site for its graphs; a replay reads none.

On the CPU, and for lanes that carry hero wavelengths (spectral mode),
shade() is dispatch_shade. padded_shade() is the padded path alone, which
on the CPU evaluates each bucket eagerly from the same buffers.
"""
from __future__ import annotations

import torch

from ..svm.eval import keep_constants
from .common import dispatch_shade

SMALLEST_BUCKET = 1024
_SI_FIELDS = ("mat", "uv", "p", "ng")


def buckets(n: int) -> list[int]:
    """The padded row counts of a site n lanes wide, ascending."""
    out, b = [], SMALLEST_BUCKET
    while b < n:
        out.append(b)
        if b * 3 // 2 < n:
            out.append(b * 3 // 2)
        b *= 2
    return out + [n]


def _inputs(si, extra: dict) -> dict:
    """The closure's inputs by name: the interaction's fields it reads and
    extra's tensors ("x.<key>")."""
    f = {name: si[name] for name in _SI_FIELDS}
    f.update((f"frame{i}", t) for i, t in enumerate(si["frame"]))
    f.update((f"x.{k}", v) for k, v in extra.items())
    return f


class _Site:
    """One call site's fixed buffers and its graphs by bucket."""

    def __init__(self, scene, k: int, fn, inputs: dict):
        t0 = next(iter(inputs.values()))
        self.scene, self.k, self.fn = scene, k, fn
        self.n = t0.shape[0]
        self.sizes = buckets(self.n)
        self.rows = torch.zeros((self.n,), dtype=torch.int64, device=t0.device)
        self.inp = {name: torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for name, t in inputs.items()}
        self.out = None  # by output key, [n, ...], named by the first run
        self.constants: dict = {}  # the closures' host constants the graphs read
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}

    def gather(self, inputs: dict, rows, b: int) -> None:
        """The buffers' first b rows: the inputs at `rows`, then at rows[0]."""
        r = rows.shape[0]
        self.rows[:r].copy_(rows)
        if b > r:
            self.rows[r:b].copy_(rows[:1].expand(b - r))
        idx = self.rows[:b]
        for name, t in inputs.items():
            torch.index_select(t, 0, idx, out=self.inp[name][:b])

    def body(self, b: int) -> None:
        """The closure over the buffers' first b rows, the site's function
        on it, and its outputs copied into the output buffers."""
        v = {name: t[:b] for name, t in self.inp.items()}
        sub = {name: v[name] for name in _SI_FIELDS}
        sub["frame"] = (v["frame0"], v["frame1"], v["frame2"])
        res = self.fn(self.scene.closure_at(sub, self.k),
                      {name[2:]: t for name, t in v.items() if name.startswith("x.")})
        if self.out is None:
            self.out = {key: torch.empty((self.n,) + t.shape[1:], dtype=t.dtype, device=t.device)
                        for key, t in res.items()}
        for key, t in res.items():
            self.out[key][:b].copy_(t)

    def capture(self, inputs: dict, rows, pool, stream) -> None:
        """Fill the buffers from this call (every bucket's rows valid), run
        the widest bucket once eagerly, then capture every bucket."""
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), keep_constants(self.constants):
            self.gather(inputs, rows, self.n)
            self.body(self.n)
            for b in self.sizes:
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool)
                try:
                    self.body(b)
                finally:
                    graph.capture_end()
                self.graphs[b] = graph
        torch.cuda.current_stream().wait_stream(stream)

    def __call__(self, inputs: dict, rows) -> dict:
        r = rows.shape[0]
        b = next(x for x in self.sizes if x >= r)
        self.gather(inputs, rows, b)
        if self.graphs:
            self.graphs[b].replay()
        else:
            self.body(b)
        return {key: t[:r] for key, t in self.out.items()}


def _site(scene, fn, k: int, inputs: dict) -> _Site:
    cache = scene.shade_graphs
    key = (fn, k) + tuple((name, tuple(t.shape), t.dtype) for name, t in inputs.items())
    return cache.get(key) or cache.setdefault(key, _Site(scene, k, fn, inputs))


def padded_shade(scene, si, extra: dict, fn, lanes, spec):
    """dispatch_shade's answer, each kind's group evaluated padded from the
    site's fixed buffers: by a graph replay on a CUDA device (the graphs
    captured at the site's first call), eagerly elsewhere."""
    inputs = _inputs(si, extra)

    def evaluate(k, rows):
        site = _site(scene, fn, k, inputs)
        if lanes.device.type == "cuda" and not site.graphs:
            if "shared" not in scene.shade_graphs:  # the pool and the capture stream
                scene.shade_graphs["shared"] = (torch.cuda.graph_pool_handle(),
                                                torch.cuda.Stream())
            site.capture(inputs, rows, *scene.shade_graphs["shared"])
        return site(inputs, rows)

    return dispatch_shade(scene, si, extra, fn, lanes, spec, evaluate=evaluate)


def shade(scene, si, extra: dict, fn, lanes, spec):
    """dispatch_shade's answer; on a CUDA device by padded_shade's graphs."""
    if lanes.device.type != "cuda" or "lambdas" in extra:
        return dispatch_shade(scene, si, extra, fn, lanes, spec)
    return padded_shade(scene, si, extra, fn, lanes, spec)
