"""job_tail_ms: host time inside the program's render.finish spans (the
job's last sync, develop, the copy of the image to the host and its cast;
akari_render_tpu_torch.stats) over its render.job spans, in ms. The spans
are timed only while a profiler collects, so this reads the traced jobs
alone, with the profiler's overhead a torch op (layer: render job; moves
refresh_ms_p90). None where the program has no such spans."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    s = snapshot()["spans"] if snapshot else {}
    if "render.finish" not in s or "render.job" not in s:
        return None
    return s["render.finish"][1] / s["render.job"][0] / 1e6
