"""The gradient-domain path tracer's films with planted paths: known base
and shifted values stand in for the traced ones (gpt._camera,
trace_base_record, trace_shift_reconnect and _eval_from_pixel are
monkeypatched here only), so render_gpt's developed films can be held
exactly to what each pixel should read. Gx[p] is the sum of the two ends of
the pair (p, p + 1), base p's +x shift and minus base (p + 1)'s -x shift,
at every p of the image, the border's included; the last column of Gx and
the last row of Gy hold no pair and read 0; the square films hold the
square of that sum. In the reconnection mode with the lumped weighting and
with separate_weights, and in the pss mode. No jax here."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from akari_render_tpu_torch.config import GPTConfig
from akari_render_tpu_torch.integrators import gpt

W, H = 7, 5  # not square, so a mix-up of the axes shows
SPP = 2


def radiance(pix):
    """F(p) [N, 3], the planted radiance of a path from pixel p: small
    whole numbers, so every sum and half of them is exact in float32."""
    x, y = pix[:, 0].double(), pix[:, 1].double()
    return torch.stack([(3 * x + 5 * y) % 11, (x * y) % 7, x + 2 * y], -1).float()


def camera_part(pix):
    """F0(p), the part of F(p) that the camera vertex contributes."""
    return torch.floor(radiance(pix) / 2)


def lin(pix):
    return pix[:, 1] * W + pix[:, 0]


def fails(a, b):
    """Whether the shift between pixels a and b fails; the same both ways,
    as the shift and its inverse fail together."""
    lo, hi = torch.minimum(lin(a), lin(b)), torch.maximum(lin(a), lin(b))
    return (lo + hi) % 5 == 0


def plant(monkeypatch, jac_up: float, separate: bool):
    """The reconnection mode's paths. A ray carries its pixel in its
    origin; the record is the base pixel. The shift from a to b has the
    jacobian jac_up where b follows a in raster order, 1 / jac_up where it
    comes before, and gives the values of the inverse shift's paths: F(b)
    at weight J, so its rest (all of it, lumped) is F(b) / J; a failed
    shift gives values that must go unused."""
    def _camera(scene, filt, pix, sampler):
        o = torch.cat([pix.float(), torch.zeros_like(pix[:, :1]).float()], -1)
        return pix.float() + 0.5, o, torch.zeros_like(o), torch.ones(pix.shape[0]), sampler

    def trace_base_record(scene, settings, ray_o, ray_d, sampler, **kw):
        pix = ray_o[:, :2].long()
        return (radiance(pix), camera_part(pix)), pix, sampler

    def trace_shift_reconnect(scene, settings, ray_o, ray_d, sampler, rec, **kw):
        a, b = rec, ray_o[:, :2].long()
        jac = torch.where(lin(b) > lin(a), jac_up, 1.0 / jac_up)
        ok = ~fails(a, b)
        f, f0 = radiance(b), camera_part(b)
        sh0 = f0 if separate else f0 / jac[:, None]
        rest = (f - f0) / jac[:, None]
        sh0 = torch.where(ok[:, None] | separate, sh0, 1e3)
        rest = torch.where(ok[:, None], rest, 1e3)
        return (sh0, rest), torch.where(ok, jac, 0.0), ok, sampler

    monkeypatch.setattr(gpt, "_camera", _camera)
    monkeypatch.setattr(gpt, "trace_base_record", trace_base_record)
    monkeypatch.setattr(gpt, "trace_shift_reconnect", trace_shift_reconnect)


def plant_pss(monkeypatch):
    def _eval_from_pixel(scene, settings, filt, pix, pss, rng):
        return pix.float() + 0.5, radiance(pix), rng
    monkeypatch.setattr(gpt, "_eval_from_pixel", _eval_from_pixel)


def render(monkeypatch, mode: str, separate: bool = True):
    """The six developed films [H, W, 3] of render_gpt with planted paths."""
    films = {}
    real = gpt.screened_poisson

    def screened_poisson(primal, gx, gy, variances=None, iters=30):
        films.update(primal=primal, gx=gx, gy=gy, var=variances)
        return real(primal, gx, gy, variances, iters)
    monkeypatch.setattr(gpt, "screened_poisson", screened_poisson)
    scene = SimpleNamespace(camera=SimpleNamespace(width=W, height=H),
                            device=torch.device("cpu"))
    cfg = GPTConfig(spp=SPP, max_depth=3, separate_weights=separate, uniform_weights=False)
    gpt.render_gpt(scene, cfg, shift_mode=mode)
    return films


def want_gradients():
    """Gx, Gy [H, W, 3]: F(p + e) - F(p) where p + e lies in the image, 0
    at the last column (Gx) and row (Gy)."""
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)
    f = radiance(pix).reshape(H, W, 3)
    gx, gy = torch.zeros_like(f), torch.zeros_like(f)
    gx[:, :-1] = f[:, 1:] - f[:, :-1]
    gy[:-1] = f[1:] - f[:-1]
    return gx, gy


CASES = [("reconnect", True, 1.0), ("reconnect", False, 1.0), ("reconnect", True, 3.0),
         ("reconnect", False, 3.0), ("pss", True, 1.0)]


@pytest.mark.parametrize("mode,separate,jac", CASES,
                         ids=["separate", "lumped", "separate-jac3", "lumped-jac3", "pss"])
def test_planted_gradient_is_the_sum_of_the_pair_ends(monkeypatch, mode, separate, jac):
    """Gx[p] = F(p + 1) - F(p) at every pixel whose pair lies in the image,
    the first and the last of each row included; the sum of the two ends,
    which with jacobian 1 (and at a failed shift, both ways) is exact in
    float32; with jacobian 3 (and 1/3 back) within float32 rounding. Where
    a shift was reflected at the border its end is in no film. The square
    films hold the square of each sample's sum (the same every sample
    here), so the weighted solve reads a variance of 0."""
    if mode == "pss":
        plant_pss(monkeypatch)
    else:
        plant(monkeypatch, jac, separate)
    got = render(monkeypatch, mode, separate)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W - 1), indexing="ij")
    a = torch.stack([xs, ys], -1).reshape(-1, 2)
    broken = fails(a, a + torch.tensor([1, 0]))
    assert broken.any() and not broken.all()  # some pairs planted as failed shifts
    for g, want in zip((got["gx"], got["gy"]), want_gradients()):
        if jac == 1.0:
            assert torch.equal(g, want)
        else:
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
    # var = clamp(sq - m^2, 1e-8): the square film is the mean's square
    for v in got["var"][1:]:
        assert torch.equal(v, torch.full_like(v, 1e-8))

