"""traversal_ms_per_sample: device time of the records that start inside
the harness's ranges around Scene.intersect and Scene.occlude, over the
traced samples; no kernel names are read (layer: traversal; moves
mpaths_s)."""


def read(run):
    t = run["trace"]
    if not t or not t["traversal_s"]:
        return None
    return t["traversal_s"] / t["samples"] * 1e3
