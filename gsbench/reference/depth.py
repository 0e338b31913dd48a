"""The plain reference of a depth-regularized training step.

Depth regularization as graphdeco-inria/gaussian-splatting's 2024 update
runs it (its README's "Depth regularization", from Kerbl et al., "A
Hierarchical 3D Gaussian Representation for Real-Time Rendering of Very
Large Datasets", SIGGRAPH 2024; train.py's depth term): the rasterizer
composites, beside the colours, the inverse depth of each Gaussian's mean,

  D = Σ_i T_i α_i / z_i   (no background term),

and the loss of ``step.training_loss`` gains

  w(t) · mean(|(D - D̂) · m|),

D̂ the target inverse depth, m its mask (ones, or zeros for a map that is
not reliable), w(t) = exp((1 - s) ln w0 + s ln w1), s = clip(t / T, 0,
1) (``depth_weight``: train.py's ``get_expon_lr_func`` without a delay).

Here the inverse depth is a fourth colour channel of ``composite``'s
blocked compositor: each Gaussian's colour [r, g, b, 1/z] over the
background [bg, 0], so the same blocks, masks and weights give it, and
autograd takes its gradient into 1/z and, through it, into the means.
A Gaussian that touches no tile takes 1/1 in place of 1/z, which no
pixel reads. The step is ``step.train_step``'s with that loss: the
render's gradients gathered block by block, then back through
``preprocess.screen``, the statistics, Adam.

Plain PyTorch in the dtype of the parameters it is given (float32 for the
reference, bfloat16 for the control), matrix products in full float32 (no
TF32). Nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gsbench.reference import composite as comp
from gsbench.reference import step as ref
from gsbench.reference.preprocess import TILE, Screen, screen

# train.py's OptimizationParams: depth_l1_weight_init, _final, iterations
WEIGHT_INIT, WEIGHT_FINAL, WEIGHT_STEPS = 1.0, 0.01, 30_000


class Frame(NamedTuple):
    image: torch.Tensor       # [3, H, W]
    inv_depth: torch.Tensor   # [H, W]
    final_t: torch.Tensor     # [H, W]
    instances: int
    counts: comp.Counts


class StepOut(NamedTuple):
    params: dict
    stats: dict
    opt: dict
    grads: dict
    loss: float
    instances: int
    counts: comp.Counts
    inv_depth: torch.Tensor   # [H, W] the step's rendered inverse depth


def depth_weight(iteration: int, init: float = WEIGHT_INIT,
                 final: float = WEIGHT_FINAL,
                 max_steps: int = WEIGHT_STEPS) -> float:
    """w(t): the log-linear schedule from ``init`` to ``final`` over
    ``max_steps`` iterations (0 before iteration 0, as upstream's)."""
    if iteration < 0 or (init == 0.0 and final == 0.0):
        return 0.0
    s = min(max(iteration / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - s) + math.log(final) * s)


def depth_l1(inv_depth, target, mask):
    """mean(|(D - D̂)·m|), as upstream's train.py writes it."""
    return torch.abs((inv_depth - target) * mask).mean()


def with_inverse_depth(s: Screen) -> Screen:
    """``s`` with 1/z as a fourth colour channel (1 where no tile is
    touched), differentiable in s.depth."""
    vis = s.tiles > 0
    inv = 1.0 / torch.where(vis, s.depth, torch.ones_like(s.depth))
    return s._replace(rgb=torch.cat([s.rgb, inv[:, None]], dim=1))


def _frame(s4: Screen, width: int, height: int, bg: torch.Tensor,
           grad: torch.Tensor | None = None) -> Frame:
    """Composite every tile of ``s4`` (colours and inverse depth); with
    ``grad`` [4, H, W] also backpropagate it, block by block, into s4's
    tensors (``step._frame`` with four channels)."""
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    inst = comp.instances(s4, gx, gy)
    dt = s4.xy.dtype
    dev = s4.xy.device
    bg4 = torch.cat([bg.to(dt), torch.zeros(1, dtype=dt, device=dev)])
    image = bg4[:, None].repeat(1, width * height)
    final_t = torch.ones(width * height, dtype=dt, device=dev)
    ev = co = walk = 0
    for tiles, k in comp.blocks(inst):
        with torch.set_grad_enabled(grad is not None):
            colour, t_final, n = comp.composite_block(s4, inst, tiles, k, gx,
                                                      bg4)
        inside, flat = comp.pixel_index(tiles.to(dev), gx, width, height)
        ev, co, walk = ev + n.evaluated, co + n.composited, \
            walk + n.contrib_walk
        if grad is not None:
            g = grad.reshape(4, -1)[:, flat.clamp(max=width * height - 1)]
            g = torch.where(inside[None], g, torch.zeros_like(g))
            torch.autograd.backward(colour, g.permute(1, 2, 0))
        image[:, flat[inside]] = colour.detach()[inside].T
        final_t[flat[inside]] = t_final.detach()[inside]
    image = image.reshape(4, height, width)
    return Frame(image[:3], image[3], final_t.reshape(height, width),
                 inst.total, comp.Counts(ev, co, walk))


@torch.no_grad()
def render(params: dict, camera: dict, bg: torch.Tensor, *, width: int,
           height: int, sh_degree: int, low_pass: float) -> Frame:
    """One frame of ``params`` with its inverse depth."""
    s = screen(params, camera, width=width, height=height,
               sh_degree=sh_degree, low_pass=low_pass)
    return _frame(with_inverse_depth(s), width, height, bg)


def train_step(params: dict, stats: dict, opt: dict, camera: dict,
               gt: torch.Tensor, bg: torch.Tensor, hp: dict, *, width: int,
               height: int, sh_degree: int, target: torch.Tensor,
               mask: torch.Tensor, weight: float,
               loss_fn=ref.training_loss) -> StepOut:
    """One depth-regularized training step: ``step.train_step`` with the
    loss ``loss_fn(image, gt, λ)[0] + weight · depth_l1(D, target,
    mask)``; ``target`` and ``mask`` [H, W]."""
    ref.no_tf32()
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in ref.LEAVES}
    dt = params["xyz"].dtype
    with torch.enable_grad():
        s = with_inverse_depth(screen(
            leaves, camera, width=width, height=height, sh_degree=sh_degree,
            low_pass=hp["low_pass"]))
        flat = s._replace(**{k: getattr(s, k).detach().requires_grad_(True)
                             for k in ("xy", "conic", "opacity", "rgb")})
        with torch.no_grad():
            fr = _frame(flat, width, height, bg)
        image = fr.image.detach().requires_grad_(True)
        inv = fr.inv_depth.detach().requires_grad_(True)
        loss = loss_fn(image, gt.to(dt), hp["lambda_dssim"])[0] + \
            weight * depth_l1(inv, target.to(dt), mask.to(dt))
        g_image, g_inv = torch.autograd.grad(loss, [image, inv])
        _frame(flat, width, height, bg,
               grad=torch.cat([g_image, g_inv[None]]))
        outs = [s.xy, s.conic, s.opacity, s.rgb]
        grads_2d = [getattr(flat, k).grad for k in ("xy", "conic",
                                                    "opacity", "rgb")]
        keep = [(o, g) for o, g in zip(outs, grads_2d) if g is not None]
        torch.autograd.backward([o for o, _ in keep], [g for _, g in keep])
    grads = {k: leaves[k].grad if leaves[k].grad is not None
             else torch.zeros_like(leaves[k]) for k in ref.LEAVES}
    tap = flat.xy.grad if flat.xy.grad is not None else \
        torch.zeros_like(flat.xy)
    new_stats = ref.densify_stats(stats, tap, s.radii, width, height)
    new_params, new_opt = ref.adam(
        {k: params[k].detach() for k in ref.LEAVES}, grads, opt,
        ref.learning_rates(hp, dt, params["xyz"].device))
    return StepOut(new_params, new_stats, new_opt, grads,
                   float(loss.detach()), fr.instances, fr.counts,
                   fr.inv_depth)
