"""setup_s: from the process's start to the first timed job: imports, CUDA
start-up, the kernel libraries (built on a checkout's first run), the scene
load and upload, the warm-up job (host clock)."""


def read(run):
    return run["setup_s"]
