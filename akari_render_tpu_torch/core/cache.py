"""On-disk cache of host tables: `.npy` files under build/cache/ in the
repository checkout (the GGX albedo table, the pmj02 tables, the blue-noise
textures). Nothing is read or written outside the checkout."""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Callable

import numpy as np

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "cache"


def cached_array(name: str, make: Callable[[], np.ndarray]) -> np.ndarray:
    """The array cached as CACHE_DIR/name, or make() written there first
    (atomically: concurrent builders cannot tear the file)."""
    path = CACHE_DIR / name
    if path.exists():
        return np.load(path)
    arr = make()
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npy", dir=CACHE_DIR)
    with os.fdopen(fd, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)
    return arr
