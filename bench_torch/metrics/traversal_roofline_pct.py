"""traversal_roofline_pct: the compulsory-bytes bound of a sample's traversal
(traversal_bytes.py: live rays and calls a sample counted in the window's
checked jobs, the scene's triangles and instances) over the card's memory
bandwidth, as a share of traversal_ms_per_sample (layer: traversal
kernels; moves mpaths_s)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_traversal_bytes", Path(__file__).with_name("traversal_bytes.py"))
traversal_bytes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(traversal_bytes)


def read(run):
    t, checked = run["trace"], run["window"]["checked"]
    if not t or not t["traversal_s"] or not checked:
        return None
    samples = sum(c["spp"] for c in checked)
    live = sum(c["live_rays"] for c in checked) / samples
    calls = sum(c["calls"] for c in checked) / samples
    b = traversal_bytes.bytes_per_sample(live, calls, run["scene"]["tris"],
                                         run["scene"]["instances"])
    bound_s = b / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (t["traversal_s"] / t["samples"])
