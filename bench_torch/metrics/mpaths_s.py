"""mpaths_s: camera paths (pixel samples) of every job completed in the
window, over the seconds from the window's start to the end of the last
job, in millions a second (host clock)."""


def read(run):
    w = run["window"]
    return run["pixels"] * w["samples"] / w["seconds"] / 1e6
