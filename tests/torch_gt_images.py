"""The long run's ground-truth images (rain_tpu_torch.scripts.e2e_long)
held against another renderer's, with an f64 render as the arbiter of
threshold flips.

Two f32 renderers of one scene agree at the oracle tolerances (rtol 1e-4,
atol 3e-5; tests/test_rasterize.py:51-100) except where a Gaussian's
alpha lies within rounding of the compositor's 1/255 cut: one renderer
composites it and the other skips it, and the pixel moves by up to that
Gaussian's alpha times its colour and transmittance (~1e-4 to 1e-3 on
this scene), while n_contrib, which counts to the last contributor,
stays equal. rain_tpu's quadratic-basis power and the port's direct
form round such alphas apart, and so do the CPU's and the card's expf.
At every value past the tolerances an f64 render of the same scene
(the port's main path with the plain versions of kernels B1-B4, which
keep their input's dtype) settles it: one of the two f32 images must lie
within the tolerances of it. Such values may be at most
``MAX_FLIP_SHARE`` of all.
No jax.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.scripts import e2e_long

RTOL, ATOL = 1e-4, 3e-5
MAX_FLIP_SHARE = 1e-4


# (module, wrapper) of kernels B1-B4, whose wrappers take f32 only
_KERNELS = ((expand_ops, "expand_instances"),
            (expand_ops, "reduce_instances"),
            (tile_render, "composite_forward"),
            (tile_render, "composite_backward"))


@contextlib.contextmanager
def plain_kernels():
    """The plain versions of kernels B1-B4 behind their wrappers, so that
    the main path runs in any dtype."""
    saved = [getattr(mod, name) for mod, name in _KERNELS]
    for mod, name in _KERNELS:
        setattr(mod, name, getattr(mod, name + "_torch"))
    try:
        yield
    finally:
        for (mod, name), f in zip(_KERNELS, saved):
            setattr(mod, name, f)


class F64Views:
    """The scene's ground truth rendered in f64 on the CPU, view by
    view, from the port's f32 ground-truth state."""

    def __init__(self, n_gauss=e2e_long.N_GAUSS, seed=e2e_long.SEED):
        _, pts, cols = e2e_long.gt_cloud(n_gauss, seed)
        params = e2e_long.gt_state(pts, cols, "cpu").params
        params = gmod.GaussianParams(*[p.double() for p in params])
        self.xyz = params.xyz
        self.act = gmod.activate(params)
        self.alive = torch.ones(n_gauss, dtype=torch.bool)

    @torch.no_grad()
    def __call__(self, i) -> np.ndarray:
        cam = e2e_long.gt_camera(i)
        inputs = {k: v.double() for k, v in cam.render_inputs("cpu").items()}
        with plain_kernels():
            out = render_ops.render(
                self.xyz, *self.act, self.alive, camera=inputs,
                width=cam.width, height=cam.height, sh_degree=3,
                bg=torch.zeros(3, dtype=torch.float64),
                max_instances=e2e_long.GT_MAX_INSTANCES)
        assert out.render.dtype == torch.float64
        return torch.clamp(out.render, 0, 1).numpy()


def _within(a, b):
    return np.abs(a - b) <= ATOL + RTOL * np.abs(b)


def compare(got, want, f64_view) -> dict:
    """Images ``got`` against ``want`` (lists of [3, H, W] f32 arrays, one
    per view) at the oracle tolerances, each value past them settled by
    ``f64_view(i)`` (see the module docstring). Raises AssertionError if
    one is not, or if they are more than MAX_FLIP_SHARE of all values.
    Returns the record: values past the tolerances, their views, the
    largest difference, and at how many of them each side was the f64
    render's."""
    rec = {"values": 0, "outside": 0, "views": [], "max_abs": 0.0,
           "got_is_f64s": 0, "want_is_f64s": 0}
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        rec["values"] += g.size
        rec["max_abs"] = max(rec["max_abs"], float(np.abs(g - w).max()))
        out = ~_within(g, w)
        if not out.any():
            continue
        e = f64_view(i)
        g_ok, w_ok = _within(g, e)[out], _within(w, e)[out]
        if not (g_ok | w_ok).all():
            raise AssertionError(
                f"view {i}: {int((~(g_ok | w_ok)).sum())} values differ "
                f"past the tolerances and neither image is the f64 "
                f"render's there")
        rec["outside"] += int(out.sum())
        rec["views"].append(i)
        rec["got_is_f64s"] += int(g_ok.sum())
        rec["want_is_f64s"] += int(w_ok.sum())
    if rec["outside"] > MAX_FLIP_SHARE * rec["values"]:
        raise AssertionError(f"{rec['outside']} of {rec['values']} values "
                             f"past the tolerances: {rec}")
    return rec
