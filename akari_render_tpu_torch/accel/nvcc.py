"""Build a CUDA source of csrc/ into a shared library with a plain C
interface, once per hash of the source and flags, under
build/torch_kernels/ (route (b) of the port's kernels: nvcc by hand, loaded
with ctypes, seconds to build).

Every kernel library is compiled for sm_90a with -fmad=false: each product
and sum then rounds on its own, as torch's elementwise ops do, so a kernel
matches its plain torch version bit for bit. No -use_fast_math: 1/x stays
IEEE division.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_library(source: Path, stem: str) -> tuple[Path, float]:
    """Compile `source` unless its library is built already. Returns the
    library's path and the seconds nvcc took (0.0 when it was built). The
    key covers the source, the flags and every header in csrc/."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{key}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0


INFO_FIELDS = ("registers", "static_smem", "dynamic_smem", "local_bytes", "threads",
               "blocks_per_sm")


def read_kernel_info(fn, names, *args: int) -> dict:
    """{kernel: {INFO_FIELDS}} from a library's kernel-info entry point
    `fn(out, *args)` (csrc/kernel_info.cuh's layout, one row a kernel of
    `names`; args: the launch shape the entry point takes): what the
    compiler gave each kernel (registers a thread, shared and local memory
    in bytes) and the blocks of that shape that one SM keeps resident."""
    out = (ctypes.c_int32 * (len(INFO_FIELDS) * len(names)))()
    err = fn(ctypes.cast(out, ctypes.c_void_p), *args)
    if err != 0:
        raise RuntimeError(f"kernel info failed: CUDA error {err}")
    vals = list(out)
    return {k: dict(zip(INFO_FIELDS, vals[i * len(INFO_FIELDS):(i + 1) * len(INFO_FIELDS)]))
            for i, k in enumerate(names)}
