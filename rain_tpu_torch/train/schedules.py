"""Training schedules: exponential LR decay, SH degree, c2f low-pass.

A copy of rain_tpu/train/schedules.py (pure Python):
- get_expon_lr: log-lerp with sine-delay warmup
  (reference utils/general_utils.py:18-36)
- sh_degree_at: +1 every 1000 iters, delayed to iter >= 5000 under
  ours/ours_new (train.py:79-85)
- c2f_low_pass: max(H*W / N / (9*pi), 0.3), optionally capped, recomputed
  every c2f_every_step iters while densification is on (train.py:95-107)
- xyz LR iteration offset by warmup under ours_new (train.py:73-77)
- depth_l1_weight: the depth term's weight, get_expon_lr from
  depth_l1_weight_init to _final over the run's iterations (upstream
  graphdeco-inria/gaussian-splatting's 2024 train.py; port only)
"""

from __future__ import annotations

import math


def get_expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                 lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) +
                            math.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def xyz_lr_at(iteration: int, opt_cfg, spatial_lr_scale: float,
              ours_new: bool = False, warmup_iter: int = 0) -> float:
    """Scheduled position LR (gaussian_model.py:154-165, train.py:73-77)."""
    sched = get_expon_lr(
        lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps)
    if ours_new:
        if iteration < warmup_iter:
            # reference only updates the LR from iteration >= warmup;
            # before that the LR remains at its init value.
            return sched(1)
        return sched(iteration - warmup_iter)
    return sched(iteration)


def depth_l1_weight(iteration: int, opt_cfg) -> float:
    """The depth term's weight at ``iteration``: log-linear from
    ``opt_cfg.depth_l1_weight_init`` to ``_final`` over
    ``opt_cfg.iterations`` (upstream's ``depth_l1_weight``)."""
    return get_expon_lr(opt_cfg.depth_l1_weight_init,
                        opt_cfg.depth_l1_weight_final,
                        max_steps=opt_cfg.iterations)(iteration)


def sh_degree_at(iteration: int, max_degree: int, ours: bool = False) -> int:
    """Active SH degree at an iteration (train.py:79-85). ``ours`` covers
    both --ours and --ours_new (degree raises only from iter 5000)."""
    if ours:
        ups = max(0, iteration // 1000 - 4) if iteration >= 5000 else 0
    else:
        ups = iteration // 1000
    return min(ups, max_degree)


def c2f_low_pass(iteration: int, *, c2f: bool, c2f_every_step: float,
                 c2f_max_lowpass: float, densify_until_iter: int,
                 height: int, width: int, num_gaussians: int,
                 prev: float = 0.3) -> float:
    """Coarse-to-fine low-pass filter size (train.py:95-107).

    Recomputed at iteration 1 and every c2f_every_step iterations while
    iteration < densify_until_iter; otherwise the previous value is kept.
    """
    if not c2f:
        return 0.3
    if iteration == 1 or (iteration % int(c2f_every_step) == 0
                          and iteration < densify_until_iter):
        low_pass = max(height * width / max(num_gaussians, 1) / (9 * math.pi),
                       0.3)
        if c2f_max_lowpass > 0:
            low_pass = min(low_pass, c2f_max_lowpass)
        return low_pass
    return prev
