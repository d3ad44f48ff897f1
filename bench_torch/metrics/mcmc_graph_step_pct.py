"""mcmc_graph_step_pct: the share of MCMC mutation steps run from CUDA
graphs to their end, in % of every step (akari_render_tpu_torch.stats:
counts["mcmc_graph_steps"] over it plus counts["mcmc_eager_steps"]), over
the whole run (warm-up, window and traced jobs); read in --trace 1 runs
only (layer: mutation step; moves mpaths_s). None where the program keeps
no such counters or ran no mutation step."""


def read(run):
    if not run["trace"]:
        return None
    from akari_render_tpu_torch import stats

    snapshot = getattr(stats, "snapshot", None)
    c = snapshot()["counts"] if snapshot else {}
    graph, eager = c.get("mcmc_graph_steps"), c.get("mcmc_eager_steps")
    if graph is None or eager is None or graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
