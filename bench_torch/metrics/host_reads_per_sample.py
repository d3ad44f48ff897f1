"""host_reads_per_sample: the program's count of calls that block the host
on the device (akari_render_tpu_torch.stats: counts["host_reads"], one at
each read.* site), over its count of samples of every pixel rendered
(counts["samples"]), over the whole run (scene load, warm-up, window and
traced jobs); read in --trace 1 runs only (layer: bounce loop; moves
mpaths_s). None where the program keeps no such counters."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    c = snapshot()["counts"] if snapshot else {}
    return c["host_reads"] / c["samples"] if c.get("samples") else None
