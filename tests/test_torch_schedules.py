"""Port parity for the training schedules (train/schedules.py, a copy of
rain_tpu's, pure Python): the same Python floats and ints over a grid of
iterations to 35,000, with ours_new on and off, and the instance-tier
ladder's counterpart of tests/test_model.py:169-189 (in
tests/test_torch_trainer.py)."""

import dataclasses

import pytest

from rain_tpu import config as jcfg
from rain_tpu.train import schedules as jsched
from rain_tpu_torch import config as tcfg
from rain_tpu_torch.train import schedules as tsched

ITERS = sorted(set(range(0, 35_001, 97)) | {
    0, 1, 2, 999, 1000, 1001, 4999, 5000, 5001, 9999, 10_000, 10_001,
    15_000, 25_000, 29_999, 30_000, 30_001, 35_000})


@pytest.mark.parametrize("ours_new", [False, True])
def test_xyz_lr_equal(ours_new):
    jo = jcfg.OptimizationParams()
    to = tcfg.OptimizationParams()
    for it in ITERS:
        a = jsched.xyz_lr_at(it, jo, 3.7, ours_new=ours_new,
                             warmup_iter=10_000 if ours_new else 0)
        b = tsched.xyz_lr_at(it, to, 3.7, ours_new=ours_new,
                             warmup_iter=10_000 if ours_new else 0)
        assert a == b, it


@pytest.mark.parametrize("ours", [False, True])
def test_sh_degree_equal(ours):
    for it in ITERS:
        for deg in (0, 1, 3):
            assert tsched.sh_degree_at(it, deg, ours=ours) == \
                jsched.sh_degree_at(it, deg, ours=ours)


@pytest.mark.parametrize("ours_new", [False, True])
def test_c2f_low_pass_equal(ours_new):
    cfgs = {"model": jcfg.ModelParams(), "rain": jcfg.RainParams(
        ours_new=ours_new, c2f=not ours_new)}
    rain = jcfg.apply_method_presets(cfgs)["rain"]
    prev_j = prev_t = 0.3
    for it in ITERS:
        n = 1000 + 37 * it
        kw = dict(c2f=rain.c2f, c2f_every_step=rain.c2f_every_step,
                  c2f_max_lowpass=rain.c2f_max_lowpass,
                  densify_until_iter=15_000 + rain.warmup_iter,
                  height=840, width=1297, num_gaussians=n)
        prev_j = jsched.c2f_low_pass(it, prev=prev_j, **kw)
        prev_t = tsched.c2f_low_pass(it, prev=prev_t, **kw)
        assert prev_t == prev_j, it
    off = dataclasses.replace(rain, c2f=False)
    assert tsched.c2f_low_pass(1, c2f=off.c2f, c2f_every_step=1000,
                               c2f_max_lowpass=300, densify_until_iter=10,
                               height=8, width=8, num_gaussians=1) == 0.3


def test_expon_lr_edges_equal():
    for args in ((0.0, 0.0), (1e-3, 1e-5, 100, 0.01, 1000),
                 (1.6e-4, 1.6e-6, 0, 0.01, 30_000)):
        j, t = jsched.get_expon_lr(*args), tsched.get_expon_lr(*args)
        for step in (-1, 0, 1, 50, 100, 999, 1000, 40_000):
            assert t(step) == j(step)
