"""gpt_dispatch_host_ms_per_sample: host time inside the program's
shade.<k> spans (akari_render_tpu_torch.stats; the per-kind dispatch's
groups, which GPT's reconnection shift takes three times a shifted bounce
and once a base bounce) over its render.sample spans, in ms. The spans are
timed only while a profiler collects, so this reads the traced jobs alone,
and their times carry the profiler's overhead a torch op (layer: shade
dispatch; moves mpaths_s). None where the program has no such spans."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    s = snapshot()["spans"] if snapshot else {}
    shade = [v[1] for k, v in s.items() if k.startswith("shade.")]
    if not shade or not s.get("render.sample", [0])[0]:
        return None
    return sum(shade) / s["render.sample"][0] / 1e6
