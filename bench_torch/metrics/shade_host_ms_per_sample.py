"""shade_host_ms_per_sample: host time inside the program's bounce.shade
spans (akari_render_tpu_torch.stats; the per-kind dispatch or K9, the
spans opened inside it included) over its render.sample spans, in ms. The
spans are timed only while a profiler collects, so this reads the traced
jobs alone, and their times carry the profiler's overhead a torch op
(layer: shade dispatch; moves mpaths_s). None where the program has no
such spans."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    s = snapshot()["spans"] if snapshot else {}
    if "bounce.shade" not in s or "render.sample" not in s:
        return None
    return s["bounce.shade"][1] / s["render.sample"][0] / 1e6
