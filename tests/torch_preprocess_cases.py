"""Preprocess's kernels against their plain version on a card: the check
shared by tests/test_torch_preprocess_kernel.py and chip_smoke.py, and the
scenes they share. Imports numpy and torch (and the port) only.

``check_kernels`` holds the forward kernel to ``preprocess_torch`` bit for
bit, every output, and the backward kernel to autograd through it: each
leaf's gradient within a relative norm gap of 1e-6 (GRAD_GAP) and each
element within 1e-3 of the leaf's largest gradient (ELEMENT_TOL). Both f32
paths lie ~1e-7 from the float64 gradient
(tests/test_torch_preprocess.py); an element whose terms cancel keeps the
absolute error of its largest term, hence the element bar's base. The
cotangents are seeded and zero on the rows the forward culls, as a
render's are.
"""

import numpy as np
import torch

from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import preprocess as prep_ops

OUTS = ("xy", "depth", "conic", "rgb", "opacity")
GRAD_GAP = 1e-6
ELEMENT_TOL = 1e-3


def small_params(device, n=20000, rest=15, seed=1, special=False):
    """Anisotropic, randomly rotated Gaussians in front of the camera;
    ``special`` adds 200 rows behind the near plane, 200 with zero scales
    (a zero determinant at low_pass 0) and 200 of opacity under 1/255."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(2, 8, (n, 1))], 1)
    scaling = rng.uniform(-4.5, -2.0, (n, 3))
    opacity = rng.normal(0, 2.0, (n, 1))
    if special:
        xyz[:200, 2] = rng.uniform(-3, 0.2, 200)
        scaling[200:400] = -200.0
        opacity[400:600] = -8.0
    arrays = [xyz, rng.normal(0, 0.5, (n, 1, 3)),
              rng.normal(0, 0.3, (n, rest, 3)), scaling,
              rng.normal(size=(n, 4)), opacity]
    return gmod.GaussianParams(*[torch.tensor(a, dtype=torch.float32,
                                              device=device)
                                 for a in arrays])


def camera(device, width, height, yaw=0.0):
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    return Camera(uid=0, image_name="t", R=R, T=np.array([0.1, 0.0, 0.0]),
                  fovx=1.0, fovy=0.7, image=None, width=width,
                  height=height).render_inputs(device)


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def cotangents(prep, seed=7):
    """Seeded normal cotangents of Preprocessed's float outputs, zero on
    the rows without a tile."""
    gen = torch.Generator(device=prep.xy.device).manual_seed(seed)
    vis = prep.tiles_touched > 0
    out = []
    for f in OUTS:
        t = getattr(prep, f)
        c = torch.randn(t.shape, generator=gen, device=t.device)
        out.append(c * vis.view(-1, *[1] * (c.dim() - 1)))
    return out


def check_kernels(params, alive, cam, *, deg, width, height, grid,
                  low_pass=0.3, scale_modifier=1.0, tight=True) -> dict:
    """Both kernels against the plain version (see the module docstring),
    ``tight`` their tight_opacity_culling; raises AssertionError on a
    difference past the bars. Returns the plain Preprocessed, the kernel's
    gradients, the gradients' gaps and largest element errors per leaf,
    and the visible rows."""
    kw = dict(sh_degree=deg, camera=cam, width=width, height=height,
              grid=grid, low_pass=low_pass, scale_modifier=scale_modifier,
              tight_opacity_culling=tight)
    leaves = gmod.GaussianParams(*[t.detach().clone().requires_grad_(True)
                                   for t in params])
    plain = prep_ops.preprocess_torch(leaves, alive, **kw)
    vals = prep_ops.call_values(cam, width, height, low_pass, scale_modifier,
                                params.xyz.device)
    n0 = prep_ops.preprocess_forward.launches
    kern = prep_ops.preprocess_forward(params, alive, vals, sh_degree=deg,
                                       grid=grid, tight_opacity_culling=tight)
    if prep_ops.preprocess_forward.launches != n0 + 1:
        raise AssertionError("the forward kernel did not count its launch")
    for f in plain._fields:
        if not same_bits(getattr(kern, f), getattr(plain, f).detach()):
            raise AssertionError(f"forward kernel: {f} differs from the "
                                 f"plain version")
    cots = cotangents(plain)
    want = torch.autograd.grad([getattr(plain, f) for f in OUTS],
                               list(leaves), cots)
    n0 = prep_ops.preprocess_backward.launches
    got = prep_ops.preprocess_backward(
        params, vals, sh_degree=deg, d_xy=cots[0], d_depth=cots[1],
        d_conic=cots[2], d_rgb=cots[3], d_opacity=cots[4])
    if prep_ops.preprocess_backward.launches != n0 + 1:
        raise AssertionError("the backward kernel did not count its launch")
    gaps, errs = {}, {}
    for name, a, b in zip(gmod.GaussianParams._fields, got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"backward kernel: {name} is not finite")
        scale = float(b.abs().max())
        norm = float(b.norm())
        gaps[name] = float((a - b).norm()) / norm if norm > 0 else \
            float(a.norm())
        errs[name] = float((a - b).abs().max())
        if not (gaps[name] <= GRAD_GAP and errs[name] <= ELEMENT_TOL * scale):
            raise AssertionError(f"backward kernel: {name} off autograd by "
                                 f"{gaps[name]:.3g} (norm), {errs[name]:.3g} "
                                 f"(element, of {scale:.3g})")
    return {"plain": plain, "grads": got, "gaps": gaps, "errs": errs,
            "visible": int((plain.tiles_touched > 0).sum())}
