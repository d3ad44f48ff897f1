"""gpt_shift_host_share_pct: the host time inside the harness's ranges
around the GPT integrator's shifted path (gpt.trace_shift_reconnect), as
the profiler's host records time them, over the traced jobs' host time (the
host clock from the first job's start to the sync after the last), in %.
A share cancels most of the drift that the host's speed and the profiler's
overhead a torch op put into a time (layer: shift mapping; moves
mpaths_s). None where the traced jobs made no shift."""


def read(run):
    t = run["trace"]
    if not t or not t.get("shift_host_s"):
        return None
    return 100.0 * t["shift_host_s"] / t["window_s"]
