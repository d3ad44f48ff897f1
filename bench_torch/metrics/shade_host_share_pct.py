"""shade_host_share_pct: host time inside the program's bounce.shade spans
over host time inside its render.sample spans (akari_render_tpu_torch.
stats), in %. The spans are timed only while a profiler collects, so this
reads the traced jobs alone; as a ratio it cancels most of the drift that
the host's speed and the profiler's overhead a torch op put into
shade_host_ms_per_sample (layer: shade dispatch; moves mpaths_s). None
where the program has no such spans."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    s = snapshot()["spans"] if snapshot else {}
    if "bounce.shade" not in s or not s.get("render.sample", [0, 0])[1]:
        return None
    return 100.0 * s["bounce.shade"][1] / s["render.sample"][1]
