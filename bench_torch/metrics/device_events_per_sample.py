"""device_events_per_sample: device records (kernels, copies, fills) of the
traced jobs, over their samples (layer: bounce loop; moves mpaths_s)."""


def read(run):
    t = run["trace"]
    return t["device_events"] / t["samples"] if t else None
