"""gsbench/work's counts against hand counts on a tiny scene."""

import math

import torch

from gsbench.readers import roofline_pct, step_mfu
from gsbench.reference import composite as comp
from gsbench.reference.preprocess import Screen
from gsbench.trace import Op, Trace
from gsbench.work import OPS_BWD_COMP, OPS_COMP, OPS_EVAL, bound_s, counts


def _one_tile(opacities):
    """Gaussians at one tile's centre, wide enough that e^power is 1 on
    its 256 pixels to f32 rounding, in front-to-back order."""
    n = len(opacities)
    return Screen(
        xy=torch.full((n, 2), 7.5), depth=torch.arange(1.0, n + 1),
        conic=torch.full((n, 3), 1e-12) * torch.tensor([1.0, 0.0, 1.0]),
        rgb=torch.full((n, 3), 0.5), opacity=torch.tensor(opacities),
        radii=torch.ones(n, dtype=torch.int32),
        rect_min=torch.zeros((n, 2), dtype=torch.int64),
        rect_wh=torch.ones((n, 2), dtype=torch.int64),
        tiles=torch.ones(n, dtype=torch.int64))


def test_pairs_of_a_tile_by_hand():
    # T after each: 0.05, 0.0025, 1.25e-4, then 6.25e-6 < 1e-4 stops the
    # pixel at the fourth: 3 composited and 4 evaluated per pixel
    s = _one_tile([0.95] * 5)
    inst = comp.instances(s, 1, 1)
    (tiles, k), = list(comp.blocks(inst))
    colour, t_final, n = comp.composite_block(s, inst, tiles, k, 1,
                                              torch.zeros(3))
    assert n == comp.Counts(4 * 256, 3 * 256, 3 * 256)
    assert math.isclose(float(t_final[0, 0]), 0.05 ** 3, rel_tol=1e-5)
    # a pair below 1/255 is walked, skipped, and the walk goes on
    s = _one_tile([0.5, 0.001, 0.5])
    inst = comp.instances(s, 1, 1)
    (tiles, k), = list(comp.blocks(inst))
    _, _, n = comp.composite_block(s, inst, tiles, k, 1, torch.zeros(3))
    assert n == comp.Counts(3 * 256, 2 * 256, 3 * 256)


def test_kernel_and_step_work_by_hand():
    s = counts.Shape(gaussians=10, params=59, instances=20, tiles=2,
                     pixels=400, composited=1000)
    fwd = counts.composite_fwd(s, frame=False)
    assert fwd == (4 * (9 * 20 + 2 * 2 + 5 * 256 * 2),
                   (OPS_EVAL + OPS_COMP) * 1000)
    assert counts.composite_fwd(s, frame=True).nbytes == \
        4 * (10 * 20 + 2 * 2 + 7 * 256 * 2)
    assert counts.composite_bwd(s) == (4 * (18 * 20 + 2 * 2 + 9 * 256 * 2),
                                       (OPS_EVAL + OPS_BWD_COMP) * 1000)
    step = counts.train_step(s)
    # Adam alone: parameters, gradients and both moments in, three out
    assert step.nbytes > 7 * 4 * 59 * 10 + fwd.nbytes
    assert bound_s(3.35e12, 0) == 1.0 and bound_s(0, 67e12) == 1.0


def test_readers_share_of_the_roofline():
    w = counts.Work(3.35e9, 0)          # 1 ms at the HBM rate
    ops = [Op("composite_fwd_kernel", 0, 4000, True, "gsbench.train_step"),
           Op("copy", 4000, 1000, False, "gsbench.train_step")]
    tr = Trace("train", ops, {"gsbench.train_step": 2}, 0.010, 0.005, [],
               [(w, {"composite_fwd": w})] * 2)
    # 4 ms of B3 over 2 steps: 2 ms per step against 1 ms of work
    assert math.isclose(roofline_pct(tr, "train", "composite_fwd"), 50.0)
    # 10 ms over 2 steps: 5 ms per step against 1 ms
    assert math.isclose(step_mfu(tr, "train"), 20.0)
    assert roofline_pct(tr, "render", "composite_fwd") is None
