"""The native (C++) binned-SAH BVH builder and rgb2spec optimizer, loaded
with ctypes (port of akari_render_tpu/native.py).

The repo's own native/*.cpp are compiled once per source hash with the JAX
package's g++ flags into build/native/ and loaded with ctypes. There is no
fallback: if g++ or the build fails, this raises. The JAX package's numpy
builder makes different trees, and the cluster tables would then stop
matching the JAX package's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sources = sorted(NATIVE_DIR.glob("*.cpp"))
        if not sources:
            raise RuntimeError(f"no native sources under {NATIVE_DIR}")
        tag = hashlib.sha1(b"".join(s.read_bytes() for s in sources)).hexdigest()[:12]
        so = BUILD_DIR / f"akari_native_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, *(str(s) for s in sources), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.akr_build_bvh.restype = ctypes.c_int64
        lib.akr_build_bvh.argtypes = [fp] * 3 + [ctypes.c_int64] + [
            ctypes.POINTER(fp)] * 2 + [ctypes.POINTER(ip)] * 4
        lib.akr_free.argtypes = [ctypes.c_void_p]
        # rgb2spec_opt(res, out_path, gamut) -> 0 on success
        lib.akr_rgb2spec_opt.restype = ctypes.c_int
        lib.akr_rgb2spec_opt.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        _lib = lib
        return lib


def build_bvh_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """C++ binned-SAH BVH2 build (native/bvh_builder.cpp); returns its leaf
    order, [T] int32 reordered triangle -> original id, which cuts the
    clusters (accel/cluster.py). The nodes themselves are not kept: the
    JAX package's stackless BVH traversal is not ported."""
    lib = get_lib()
    n = len(v0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    o_bmin, o_bmax = fp(), fp()
    o_start, o_count, o_skip, o_order = ip(), ip(), ip(), ip()
    v0c, e1c, e2c = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    lib.akr_build_bvh(
        v0c.ctypes.data_as(fp), e1c.ctypes.data_as(fp), e2c.ctypes.data_as(fp), n,
        ctypes.byref(o_bmin), ctypes.byref(o_bmax), ctypes.byref(o_start),
        ctypes.byref(o_count), ctypes.byref(o_skip), ctypes.byref(o_order),
    )
    order = np.ctypeslib.as_array(o_order, (n,)).copy()
    for p in (o_bmin, o_bmax, o_start, o_count, o_skip, o_order):
        lib.akr_free(p)
    return order
