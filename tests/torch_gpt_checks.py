"""Image checks shared by the GPT and MCMC tests of the PyTorch port (no
jax here): the standard of test_torch_pt.py::test_slice_matches_jax."""
import numpy as np


def assert_images_match(got, want, name: str, pix_frac: float = 0.95, rel: float = 1e-3):
    """Channel means within 1 % (of the image's mean magnitude where the
    mean is near zero, as a gradient image's is) and at least `pix_frac` of
    the pixels within `rel` relative (to a magnitude of at least 1e-3)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.all(np.isfinite(got)), name
    gm, wm = got.mean(axis=(0, 1)), want.mean(axis=(0, 1))
    scale = np.maximum(np.abs(wm), np.abs(want).mean(axis=(0, 1)))
    assert np.all(np.abs(gm - wm) <= 0.01 * scale), f"{name}: means {gm} against {wm}"
    off = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    frac = np.mean(np.all(off <= rel, axis=-1))
    assert frac >= pix_frac, f"{name}: {frac:.4f} of the pixels within {rel}"
