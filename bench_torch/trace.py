"""The traced window: one job of the cell's traffic under torch.profiler,
reduced to device events, busy time, the traversal ranges' device time, the
GPT shift ranges' device time (outside the traversal ranges) and host time,
and a breakdown of device operations and idle gaps.

This torch build loses a profiler window's first and last device records,
so the window opens and closes with pads of tiny kernels, and a marker
kernel (`torch.cuda._sleep`, named spin_kernel) on each side of the job
bounds the records that count. The harness's traversal ranges
(`record_function(TRAVERSAL_RANGE)` around Scene.intersect and
Scene.occlude) appear on the device's timeline as annotations; a device
record belongs to the traversal when it starts inside one of them. So for
the shift ranges (`record_function(SHIFT_RANGE)` around the GPT
integrator's shifted path), which hold traversal ranges: a record belongs
to the shift when it starts inside a shift range and outside every
traversal range.
"""
from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict

from .harness import SHIFT_RANGE, TRAVERSAL_RANGE

PAD_LAUNCHES = 1024
MARKER = "spin_kernel"
TOP = 10


def _pad():
    import torch

    x = torch.empty(1, device="cuda")
    for _ in range(PAD_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize()


def _marker():
    import torch

    torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def _union_ns(spans) -> int:
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class LostRecords(RuntimeError):
    """The profiler lost a marker or every record of the window."""


def traced_job(job, attempts: int = 3) -> dict:
    """Run job() (the traced jobs, which return their pixel samples)
    under the profiler and reduce its records; a window whose records were
    lost past its pads is run again."""
    for _ in range(attempts - 1):
        try:
            return _traced_once(job)
        except LostRecords:
            pass
    return _traced_once(job)


def _traced_once(job) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad()
        _marker()
        t0 = time.perf_counter()
        samples = job()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        _marker()
        _pad()
    t_read = time.perf_counter()
    out = reduce_events(prof.profiler.kineto_results.events())
    out.update(samples=samples, window_s=window_s, read_s=time.perf_counter() - t_read)
    return out


def _kind(e, cuda) -> str:
    """The record's kind, told apart by device, annotation flag and name
    (this torch's records carry no activity type)."""
    on_device = e.device_type() == cuda
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "kernel"
    return "cuda_runtime" if e.name().startswith("cuda") else "cpu_op"


def reduce_events(events) -> dict:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, notes, shifts, host = [], [], [], []
    shift_host_ns = 0
    for e in events:
        kind = _kind(e, cuda)
        if e.device_type() == cuda:
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if kind == "kernel":  # kernels, copies and memsets alike
                dev.append(span)
            elif kind == "gpu_user_annotation" and e.name() == TRAVERSAL_RANGE:
                notes.append(span)
            elif kind == "gpu_user_annotation" and e.name() == SHIFT_RANGE:
                shifts.append(span)
        else:
            if kind == "user_annotation" and e.name() == SHIFT_RANGE:
                shift_host_ns += e.duration_ns()
            name = e.name() if kind in ("cpu_op", "user_annotation") else f"> {e.name()}"
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.start_thread_id()))
    dev.sort()
    marks = [i for i, r in enumerate(dev) if MARKER in r[2]]
    if len(marks) < 2:
        raise LostRecords(f"the profiler kept {len(marks)} of the window's 2 markers")
    job = dev[marks[0] + 1:marks[-1]]
    if not job:
        raise LostRecords("the profiler recorded no device work inside the window")
    busy_ns = _union_ns([(s, e) for s, e, _ in job])
    inside_trav = _inside(notes)
    inside_shift = _inside(shifts)
    trav_ns = shift_ns = 0
    for s, e, _ in job:
        if inside_trav(s):
            trav_ns += e - s
        elif inside_shift(s):
            shift_ns += e - s
    by_name = defaultdict(int)
    for s, e, name in job:
        by_name[name[:120]] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_events": len(job), "busy_s": busy_ns / 1e9,
            "traversal_s": trav_ns / 1e9 if notes else None,
            "shift_s": shift_ns / 1e9 if shifts else None,
            "shift_host_s": shift_host_ns / 1e9 if shifts else None,
            "breakdown": {"device_ops": [[n, ns / 1e9] for n, ns in device_ops],
                          "idle_gaps": idle_gaps(job, host)}}


def _inside(ranges):
    """inside(t): whether t lies inside one of ranges [(start, end, name)],
    which do not overlap (ranges of one name on one stream)."""
    ranges = sorted(ranges)
    starts = [s for s, _, _ in ranges]

    def inside(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < ranges[i][1]
    return inside


def idle_gaps(job, host) -> list:
    """The device's idle time inside the job, by the innermost host
    operation running on the main thread at each gap's middle (a runtime
    call, marked "> ", after the operation that made it)."""
    if not host:
        return []
    main = Counter(h[3] for h in host).most_common(1)[0][0]
    ops = sorted((s, e, n) for s, e, n, tid in host if tid == main)
    gaps = []
    end = job[0][1]
    for s, e, _ in job[1:]:
        if s > end:
            gaps.append(((end + s) // 2, s - end))
        end = max(end, e)
    gaps.sort()
    total = defaultdict(int)
    stack, k = [], 0
    for mid, ns in gaps:
        while k < len(ops) and ops[k][0] <= mid:
            while stack and stack[-1][1] <= ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        if not stack:
            label = "(no host op)"
        elif stack[-1][2].startswith("> ") and len(stack) > 1:
            label = f"{stack[-2][2]} {stack[-1][2]}"
        else:
            label = stack[-1][2]
        total[label[:120]] += ns
    return [[n, ns / 1e9] for n, ns in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
