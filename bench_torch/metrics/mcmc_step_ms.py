"""mcmc_step_ms: render_mcmc's own synchronised timer of its mutation steps
(stats "mutate_time", from the first step to the sync after the last) over
its steps a chain (stats "steps"), summed over the window's jobs, in ms: one
Kelemen mutation and Metropolis step of every chain, a full trace_paths over
the chains' lanes with the expected-value splats (host clock; layer:
mutation step; moves mpaths_s). None where the jobs are not MCMC jobs."""


def read(run):
    jobs = [j["stats"] for j in run["window"]["jobs"] if "mutate_time" in j["stats"]]
    steps = sum(s["steps"] for s in jobs)
    return 1e3 * sum(s["mutate_time"] for s in jobs) / steps if steps else None
