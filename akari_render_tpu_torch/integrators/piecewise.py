"""Piecewise CUDA graphs of a computation that stops for the host.

A computation written as a generator of requests (common.trace_steps, or a
generator that yields from it) stops wherever it needs the host: at each
traversal call (a Traverse) and at each read of whether any lane lives (a
LiveRead). Between two requests its work is a fixed sequence of launches
on fixed shapes, and that is what Piecewise captures: each segment once as
a torch.cuda.CUDAGraph, all in one memory pool, replayed in the order they
were captured.

The traversal stays out of the graphs and is called afresh between two
replays, looked up on the scene at the call, on the tensors the segment
before it wrote: the cluster tier sizes its work with torch.nonzero and
stochastic alpha restarts on a host read, and neither can be captured. Its
answer is copied into the tensors the next segment was captured on. A
LiveRead is read between segments as it is in an eager run; where it finds
no live lane, the eager run would leave the bounce loop there, so the
replay stops and the caller's `on_exit` finishes the computation eagerly
from the state the read carries.

Counters that the segments' code adds to while it is captured (stats.counts,
the kernel modules' `launches`) get the same increments on each replay, so
a replayed run counts as an eager one does.

On the CPU, which has no graphs, run() executes the segments one after
the other, with the same requests answered between them, and keeps
nothing.

Memory: the graphs' pool holds the segments' temporaries and the tensors
kept for the replays (each request's arguments, each LiveRead's state);
release() drops them, and cuBLAS's workspaces with them (see there). A
pool that no graph uses any more is freed by the caching allocator only
when it empties its cache (torch.cuda.empty_cache, or a failed
allocation's retry): it stays reserved, not allocated.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from .. import stats
from ..core import pcg
from . import fused_shade
from .common import LiveRead, answer

# the modules whose `launches` count the kernel launches of the segments' code
_LAUNCH_COUNTERS = (pcg, fused_shade)


def _tally():
    return dict(stats.counts), [m.launches for m in _LAUNCH_COUNTERS]


def _since(before):
    """The counters' increments since `before` (a _tally())."""
    counts0, launches0 = before
    counts1, launches1 = _tally()
    return ({k: v - counts0.get(k, 0) for k, v in counts1.items() if v != counts0.get(k, 0)},
            [b - a for a, b in zip(launches0, launches1)])


def _add(increments):
    counts, launches = increments
    for k, v in counts.items():
        stats.counts[k] += v
    for m, v in zip(_LAUNCH_COUNTERS, launches):
        m.launches += v


def _copy_into(dst, src):
    """Copy an answer (a tensor, or a tuple of them such as a Hit) into the
    tensors of the answer the next segment was captured on."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


class _Segment:
    __slots__ = ("graph", "request", "increments", "reply")

    def __init__(self, graph, request, increments):
        self.graph, self.request, self.increments = graph, request, increments
        self.reply = None  # the answer the next segment was captured on


class Piecewise:
    """The segments of one computation, captured once and replayed."""

    def __init__(self, scene):
        self.scene = scene
        self.graphs = scene.device.type == "cuda"
        self.segments: list[_Segment] = []
        self._pool = None
        self._stream = None

    @property
    def captured(self) -> bool:
        return bool(self.segments)

    @contextmanager
    def _capturing(self, graph):
        if graph is None:
            yield
            return
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                yield
            finally:
                graph.capture_end()

    def run(self, start, on_exit) -> bool:
        """Run the computation once: start() makes its generator (the work
        before its first request included), and each request is answered
        as it comes. With graphs every segment is captured, then replayed
        once, before its request is answered. Returns True where it ran to
        its end (with graphs, the segments are kept for replay()); False
        where a LiveRead found no live lane and on_exit(read) finished the
        computation (nothing is kept)."""
        if self.graphs:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        steps = reply = None
        while True:
            graph = torch.cuda.CUDAGraph() if self.graphs else None
            before = _tally()
            with self._capturing(graph):
                try:
                    if steps is None:
                        steps = start()
                        req = next(steps)
                    else:
                        req = steps.send(reply)
                except StopIteration:
                    req = None
            if graph is not None:
                graph.replay()
                self.segments.append(_Segment(graph, req, _since(before)))
            if req is None:
                return True
            reply = answer(self.scene, req)
            if isinstance(req, LiveRead):
                if not reply:
                    steps.close()
                    on_exit(req)
                    self.release()
                    return False
            elif graph is not None:
                self.segments[-1].reply = reply

    def replay(self, on_exit) -> bool:
        """Replay the captured segments, answering each request between
        two; returns run()'s answer."""
        for seg in self.segments:
            seg.graph.replay()
            _add(seg.increments)
            req = seg.request
            if req is None:
                return True
            reply = answer(self.scene, req)
            if isinstance(req, LiveRead):
                if not reply:
                    on_exit(req)
                    return False
            else:
                _copy_into(seg.reply, reply)
        raise RuntimeError("Piecewise.replay: the last segment made a request")

    def release(self) -> None:
        """Drop the graphs, their pool and every tensor kept for them."""
        captured = self._stream is not None
        self.segments = []
        self._pool = self._stream = None
        if captured:
            # cuBLAS keeps a workspace for every stream it has run a matmul
            # on (the camera's transforms), made there at the first one and
            # kept for the process: the capture stream's was made in the
            # graphs' pool and would outlive them. Drop them all; the next
            # matmul on a stream makes that stream's again.
            torch._C._cuda_clearCublasWorkspaces()
