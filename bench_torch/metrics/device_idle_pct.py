"""device_idle_pct: 100 x (1 - device busy time a sample, from the traced
jobs' records, over the wall time of a sample in the unprofiled window of
the same run). The profiler slows the host, so the wall time comes from
the window (layer: device; moves mpaths_s)."""


def read(run):
    t, w = run["trace"], run["window"]
    if not t:
        return None
    busy = t["busy_s"] / t["samples"]
    wall = w["seconds"] / w["samples"]
    return 100.0 * (1.0 - busy / wall)
