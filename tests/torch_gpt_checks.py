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


def paired_pixels(height: int, width: int, axis: int, stride: int = 1):
    """bool [H, W]: the pixels of a gradient film along `axis` (1: Gx, 0:
    Gy) at which the JAX package's film holds exactly the two ends of one
    pair a sample (bench_torch/check.py::paired, the storage rule of the
    JAX package's GPT, which keeps a reflected shift's end: at stride 1
    every pixel but the second and the last along the axis)."""
    from bench_torch.check import paired

    line = paired(width if axis == 1 else height, stride)
    return np.broadcast_to(line[None, :] if axis == 1 else line[:, None], (height, width))


def assert_full_strength(got: dict, want: dict, pix_frac: float = 0.95):
    """The port's gx and gy (`got`, render stats) against the JAX
    package's of the same samples (`want`). Where JAX's film holds a pair's
    two ends it holds their mean and the port's their sum, so the port's
    is 2x JAX's there, to assert_images_match's standard. The port's last
    column of gx and last row of gy hold no pair and read 0 exactly."""
    for name, axis in (("gx", 1), ("gy", 0)):
        g, w = np.asarray(got[name]), 2.0 * np.asarray(want[name])
        keep = paired_pixels(g.shape[0], g.shape[1], axis)
        assert_images_match(g[keep][:, None], w[keep][:, None], name, pix_frac)
        edge = g[:, -1] if axis == 1 else g[-1]
        assert not edge.any(), f"{name}: the pixels that hold no pair read {edge}"
