"""mcmc_setup_share_pct: the share of an MCMC job's time that its bootstrap
(the candidates' paths, the host's resampling and the chains' first
evaluation; stats "bootstrap_time") and its depth-1 direct pass (render_pt,
stats "direct_time") take of the whole job (stats "total_time"), summed
over the window's jobs, in %; render_mcmc's own timers, each ending in a
sync (host clock; layer: bootstrap and direct pass; moves mpaths_s). None
where the jobs are not MCMC jobs."""


def read(run):
    jobs = [j["stats"] for j in run["window"]["jobs"] if "bootstrap_time" in j["stats"]]
    total = sum(s["total_time"] for s in jobs)
    if not total:
        return None
    part = sum(s["bootstrap_time"] + s.get("direct_time", 0.0) for s in jobs)
    return 100.0 * part / total
