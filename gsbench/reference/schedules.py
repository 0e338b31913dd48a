"""The plain reference of a RAIN-GS run's schedules and of the scene's
extent, in plain Python.

From RAIN-GS's train.py:73-107 (Jung et al., 2024; the ``--ours_new``
preset of train.py:261-280) and 3DGS's utils/general_utils.py:18-36 and
scene/dataset_readers.py:34-55 (getNerfppNorm):

- the xyz learning rate: 3DGS's exponential decay from
  ``position_lr_init``·extent to ``position_lr_final``·extent over
  ``position_lr_max_steps``; under ``ours_new`` it stays at its value of
  step 1 until ``warmup_iter`` and then runs from iteration − warmup;
- the active SH degree: one more every 1,000 iterations, and under
  ``ours``/``ours_new`` none before 5,000 (degree (i // 1000) − 4 from
  there), at most the model's;
- the coarse-to-fine low-pass filter: max(H·W / N / (9π), 0.3), capped at
  ``c2f_max_lowpass``, recomputed at iteration 1 and every
  ``c2f_every_step`` iterations while the densification lasts, held in
  between;
- the densification: a round every ``densification_interval`` past
  ``densify_from_iter`` and before ``densify_until_iter`` + warmup, with
  the abe_split pre-pass up to ``warmup_iter`` and the size threshold
  past ``opacity_reset_interval``; an opacity reset every
  ``opacity_reset_interval``.
"""

from __future__ import annotations

import math

import numpy as np

# train.py:136-139: the round's opacity floor and, past the first reset,
# its screen size
MIN_OPACITY = 0.005
SCREEN_SIZE = 20.0


def preset(rain: dict) -> dict:
    """The method values of the ``--ours``/``--ours_new`` flags in
    ``rain`` (train.py:28-32, 261-280)."""
    ours = bool(rain.get("ours") or rain.get("ours_new"))
    return {"ours": ours, "ours_new": bool(rain.get("ours_new")),
            "c2f": ours, "c2f_every_step": 1000, "c2f_max_lowpass": 300.0,
            "warmup_iter": 10_000 if rain.get("ours_new") else 0,
            "divide_ratio": 0.7 if ours else 0.8}


def xyz_lr(iteration: int, opt: dict, extent: float, *, ours_new: bool,
           warmup_iter: int) -> float:
    init = opt["position_lr_init"] * extent
    final = opt["position_lr_final"] * extent
    step = iteration
    if ours_new:
        step = 1 if iteration < warmup_iter else iteration - warmup_iter
    if step < 0 or (init == 0.0 and final == 0.0):
        return 0.0
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def sh_degree(iteration: int, max_degree: int, *, ours: bool) -> int:
    if ours:
        ups = iteration // 1000 - 4 if iteration >= 5000 else 0
    else:
        ups = iteration // 1000
    return min(ups, max_degree)


def low_pass(height: int, width: int, n_gaussians: int,
             max_lowpass: float) -> float:
    """The filter recomputed from ``n_gaussians``."""
    lp = max(height * width / n_gaussians / (9 * math.pi), 0.3)
    return min(lp, max_lowpass) if max_lowpass > 0 else lp


def densify_until(opt: dict, warmup_iter: int) -> int:
    return opt["densify_until_iter"] + warmup_iter


def is_round(iteration: int, opt: dict, warmup_iter: int) -> bool:
    return (opt["densify_from_iter"] < iteration <
            densify_until(opt, warmup_iter) and
            iteration % opt["densification_interval"] == 0)


def round_flags(iteration: int, opt: dict, warmup_iter: int) -> dict:
    """Which parts a round at ``iteration`` runs."""
    return {"abe_split": iteration <= warmup_iter,
            "size_threshold": iteration > opt["opacity_reset_interval"]}


def is_reset(iteration: int, opt: dict, warmup_iter: int) -> bool:
    return (iteration < densify_until(opt, warmup_iter) and
            iteration % opt["opacity_reset_interval"] == 0)


def scene_extent(centers) -> float:
    """getNerfppNorm's radius: 1.1 times the largest distance of a camera
    centre from their mean."""
    c = np.asarray(centers, np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max()) * 1.1
