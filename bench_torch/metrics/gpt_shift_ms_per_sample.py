"""gpt_shift_ms_per_sample: device time of the records that start inside
the harness's ranges around the GPT integrator's shifted path
(gpt.trace_shift_reconnect, four calls a sample) and outside its ranges
around Scene.intersect and Scene.occlude, over the traced pixel samples:
the shift's own bounce, shading and reconnection work, its traversal left
to traversal_ms_per_sample (layer: shift mapping; moves mpaths_s). None
where the traced jobs made no shift."""


def read(run):
    t = run["trace"]
    if not t or not t.get("shift_s"):
        return None
    return t["shift_s"] / t["samples"] * 1e3
