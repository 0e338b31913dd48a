"""The plain reference of the program's training step and frame render.

A training step as 3DGS's train.py:71-147 runs it and as the program
specifies it (rain_tpu_torch/train/step.py:77-144): render one view,
loss (1 - λ)·L1 + λ·(1 - SSIM), the gradients of every parameter and of
the screen-space means, the densification statistics, Adam. The render
and its gradients come from ``preprocess.screen`` and the blocked
compositor of ``composite``; SSIM is the 11-tap separable Gaussian blur
with zero padding (utils/loss_utils.py:12-52), frozen from
rain_tpu_torch/ops/losses.py:47-100; Adam is torch's with eps outside the
root and the bias corrections as the program writes them, frozen from
rain_tpu_torch/model/adam.py:82-100; the statistics from
rain_tpu_torch/model/densify.py:77-100.

All of it runs in the dtype of the parameters it is given, float32 for
the reference and bfloat16 for the control. Matrix products run in full
float32 (no TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gsbench.reference import composite as comp
from gsbench.reference.preprocess import TILE, screen

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
STATS = ("max_radii2d", "xyz_gradient_accum", "denom")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
SSIM_TAPS = 11


class Frame(NamedTuple):
    image: torch.Tensor       # [3, H, W]
    final_t: torch.Tensor     # [H, W]
    instances: int
    counts: comp.Counts


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _frame(s, width: int, height: int, bg: torch.Tensor,
           grad_image: torch.Tensor | None = None) -> Frame:
    """Composite every tile of screen ``s``; with ``grad_image`` [3, H, W]
    also backpropagate it, block by block, into s's tensors."""
    gx, gy = _grid(width, height)
    inst = comp.instances(s, gx, gy)
    dt = s.xy.dtype
    image = bg.to(dt)[:, None].repeat(1, width * height)
    final_t = torch.ones(width * height, dtype=dt, device=s.xy.device)
    ev = co = walk = 0
    for tiles, k in comp.blocks(inst):
        with torch.set_grad_enabled(grad_image is not None):
            colour, t_final, n = comp.composite_block(s, inst, tiles, k, gx,
                                                      bg.to(dt))
        inside, flat = comp.pixel_index(tiles.to(s.xy.device), gx, width,
                                        height)
        ev, co, walk = ev + n.evaluated, co + n.composited, \
            walk + n.contrib_walk
        if grad_image is not None:
            g = grad_image.reshape(3, -1)[:, flat.clamp(max=width * height - 1)]
            g = torch.where(inside[None], g, torch.zeros_like(g))
            torch.autograd.backward(colour, g.permute(1, 2, 0))
        image[:, flat[inside]] = colour.detach()[inside].T
        final_t[flat[inside]] = t_final.detach()[inside]
    return Frame(image.reshape(3, height, width),
                 final_t.reshape(height, width), inst.total,
                 comp.Counts(ev, co, walk))


@torch.no_grad()
def render(params: dict, camera: dict, bg: torch.Tensor, *, width: int,
           height: int, sh_degree: int, low_pass: float) -> Frame:
    """One frame of ``params`` (the program's ``eval_render``)."""
    s = screen(params, camera, width=width, height=height,
               sh_degree=sh_degree, low_pass=low_pass)
    return _frame(s, width, height, bg)


def _window() -> tuple[float, ...]:
    g = np.array([math.exp(-(i - SSIM_TAPS // 2) ** 2 / (2 * 1.5 ** 2))
                  for i in range(SSIM_TAPS)])
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    pad = len(taps) // 2
    padding = [0, 0] * x.dim()
    padding[2 * (x.dim() - 1 - dim)] = pad
    padding[2 * (x.dim() - 1 - dim) + 1] = pad
    xp = F.pad(x, padding)
    n = x.shape[dim]
    acc = None
    for k, gk in enumerate(taps):
        term = gk * xp.narrow(dim, k, n)
        acc = term if acc is None else acc + term
    return acc


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    img1, img2 = img1[None], img2[None]
    c = img1.shape[1]
    taps = _window()
    out = _blur(_blur(torch.cat([img1, img2, img1 * img1, img2 * img2,
                                 img1 * img2], dim=1), 3, taps), 2, taps)
    mu1, mu2 = out[:, 0:c], out[:, c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = out[:, 2 * c:3 * c] - mu1_sq
    s2 = out[:, 3 * c:4 * c] - mu2_sq
    s12 = out[:, 4 * c:5 * c] - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1_mu2 + c1) * (2 * s12 + c2)) /
            ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean()


def training_loss(image, gt, lambda_dssim: float):
    """(loss, l1) of train.py:113-114."""
    l1 = torch.abs(image - gt).mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * \
        (1.0 - ssim(image, gt)), l1


def learning_rates(hp: dict, dt, device) -> dict:
    """Per-leaf learning rates (gaussian_model.py:144-151): features_rest
    at the feature rate times f32(1/20), as the program computes it."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device).to(dt)
    lr = hp["opt_leaves"]
    return {"xyz": t(hp["xyz_lr"]), "features_dc": t(lr["feature_lr"]),
            "features_rest": t(lr["feature_lr"]) *
            float(np.float32(1.0) / np.float32(20.0)),
            "scaling": t(lr["scaling_lr"]), "rotation": t(lr["rotation_lr"]),
            "opacity": t(lr["opacity_lr"])}


def adam_init(params: dict) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["xyz"].device)}


def adam(params: dict, grads: dict, opt: dict, lrs: dict):
    step = opt["step"] + 1
    dt = params["xyz"].dtype
    b1c = (1.0 - BETA1 ** step.to(torch.float32)).to(dt)
    b2c = (1.0 - BETA2 ** step.to(torch.float32)).to(dt)
    new_p, mu, nu = {}, {}, {}
    for k in LEAVES:
        m = BETA1 * opt["mu"][k] + (1.0 - BETA1) * grads[k]
        v = BETA2 * opt["nu"][k] + (1.0 - BETA2) * (grads[k] * grads[k])
        new_p[k] = params[k] - lrs[k] * (m / b1c) / \
            (torch.sqrt(v / b2c) + EPS)
        mu[k], nu[k] = m, v
    return new_p, {"mu": mu, "nu": nu, "step": step}


def stats_init(n: int, dt, device) -> dict:
    return {k: torch.zeros(n, dtype=dt, device=device) for k in STATS}


def densify_stats(stats: dict, tap_grad, radii, width: int,
                  height: int) -> dict:
    vis = radii > 0
    sc = torch.tensor([width * 0.5, height * 0.5], dtype=tap_grad.dtype,
                      device=tap_grad.device)
    s = tap_grad * sc[None, :]
    g = torch.sqrt(torch.sum(s * s, dim=-1))
    return {"xyz_gradient_accum": stats["xyz_gradient_accum"] +
            torch.where(vis, g, torch.zeros_like(g)),
            "denom": stats["denom"] + vis.to(g.dtype),
            "max_radii2d": torch.where(
                vis, torch.maximum(stats["max_radii2d"], radii.to(g.dtype)),
                stats["max_radii2d"])}


class StepOut(NamedTuple):
    params: dict
    stats: dict
    opt: dict
    grads: dict
    loss: float
    instances: int
    counts: comp.Counts


def train_step(params: dict, stats: dict, opt: dict, camera: dict,
               gt: torch.Tensor, bg: torch.Tensor, hp: dict, *, width: int,
               height: int, sh_degree: int, loss_fn=training_loss) -> StepOut:
    """One training step; ``hp``: low_pass, xyz_lr, opt_leaves,
    lambda_dssim (the traffic's hyper-parameters)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    dt = params["xyz"].dtype
    with torch.enable_grad():
        s = screen(leaves, camera, width=width, height=height,
                   sh_degree=sh_degree, low_pass=hp["low_pass"])
        # the compositor's inputs as leaves of their own: their gradients
        # are gathered block by block, then go back through preprocess
        flat = s._replace(**{k: getattr(s, k).detach().requires_grad_(True)
                             for k in ("xy", "conic", "opacity", "rgb")})
        with torch.no_grad():
            fr = _frame(flat, width, height, bg)
        image = fr.image.detach().requires_grad_(True)
        loss, _ = loss_fn(image, gt.to(dt), hp["lambda_dssim"])
        g_image, = torch.autograd.grad(loss, image)
        _frame(flat, width, height, bg, grad_image=g_image)
        outs = [s.xy, s.conic, s.opacity, s.rgb]
        grads_2d = [getattr(flat, k).grad for k in ("xy", "conic",
                                                    "opacity", "rgb")]
        keep = [(o, g) for o, g in zip(outs, grads_2d) if g is not None]
        torch.autograd.backward([o for o, _ in keep], [g for _, g in keep])
    grads = {k: leaves[k].grad if leaves[k].grad is not None
             else torch.zeros_like(leaves[k]) for k in LEAVES}
    tap = flat.xy.grad if flat.xy.grad is not None else \
        torch.zeros_like(flat.xy)
    new_stats = densify_stats(stats, tap, s.radii, width, height)
    new_params, new_opt = adam(
        {k: params[k].detach() for k in LEAVES}, grads, opt,
        learning_rates(hp, dt, params["xyz"].device))
    return StepOut(new_params, new_stats, new_opt, grads,
                   float(loss.detach()),
                   fr.instances, fr.counts)
