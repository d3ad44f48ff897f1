"""refresh_ms_p90: the 90th percentile of every job's time in the window,
from the viewer's request to the developed image on the host (host clock;
statistics.quantiles, exclusive method)."""
import statistics


def read(run):
    ms = [(j["end"] - j["start"]) * 1e3 for j in run["window"]["jobs"]]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
