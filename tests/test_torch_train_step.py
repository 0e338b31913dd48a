"""Port parity for the slice as a whole: one training step.

A JAX state with seeded densification statistics (as a few earlier steps
leave them) and its fresh Adam state are carried into the port
(gaussians.from_numpy, adam.from_numpy), and rain_tpu.train.step.train_step
and the port's take one step from that same state, at the exact size and
in a tile bucket (``real_wh``, the counterpart of
tests/test_bucketing.py:66). Tolerances:

- loss and l1 to rtol 1e-5: means over the image summed in another order;
- num_instances, overflow, denom and max_radii2d exactly: integers and
  counts;
- xyz_gradient_accum and Adam's mu and nu at the gradient bar, max-abs
  error / max-abs value < 1e-4 (tests/test_rasterize.py:100);
- the params to rtol 1e-5 / atol 1e-7 wherever the step's gradient is
  above 1e-3 of its leaf's max |g|, and within 2·lr elsewhere: step 1 of
  Adam moves a parameter by lr·sign(g), and a gradient near zero may
  flip its sign when the two gradients differ by their rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.data.cameras import Camera as JCamera
from rain_tpu.model import adam as jadam
from rain_tpu.model import gaussians as jgmod
from rain_tpu.train import step as jstep
from rain_tpu_torch.data.cameras import Camera as TCamera
from rain_tpu_torch.model import adam as tadam
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.ops import render as trender
from rain_tpu_torch.train import step as tstep

torch.set_num_threads(1)

W, H, BW, BH = 61, 45, 64, 48          # true size and its tile bucket
N, CAPACITY, M = 300, 320, 4096
BG = np.array([0.2, 0.1, 0.3], np.float32)
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}
XYZ_LR = 1.6e-4
LRS = dict(xyz=XYZ_LR, features_dc=0.0025, features_rest=0.0025 / 20,
           scaling=0.005, rotation=0.001, opacity=0.05)


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          rng.uniform(2.5, 6.0, (N, 1))], 1)
    return {k: v.astype(np.float32) for k, v in dict(
        xyz=xyz, f_dc=rng.normal(0, 0.4, (N, 1, 3)),
        f_rest=rng.normal(0, 0.1, (N, 15, 3)),
        scaling=rng.uniform(-3.5, -2.0, (N, 3)),
        rotation=rng.normal(size=(N, 4)),
        opacity=rng.normal(0.5, 1.0, (N, 1))).items()}


def _cam(k):
    ang = 0.05 * k
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    return dict(uid=k, image_name=f"c{k}", R=R, T=np.zeros(3), fovx=0.9,
                fovy=0.8, image=None, width=W, height=H)


def _jax_step(state, opt, k, gt, bucketed):
    camera = {key: jnp.asarray(v)
              for key, v in JCamera(**_cam(k)).render_inputs().items()}
    kw = dict(sh_degree=3, max_instances=M, opt_cfg_leaves=OPT)
    if bucketed:
        pad = np.zeros((3, BH, BW), np.float32)
        pad[:, :H, :W] = gt
        kw.update(width=BW, height=BH, real_wh=(jnp.asarray(W, jnp.int32),
                                                jnp.asarray(H, jnp.int32)))
        gt = pad
    else:
        kw.update(width=W, height=H)
    return jstep.train_step(state, opt, camera, jnp.asarray(gt),
                            jnp.asarray(BG), jnp.asarray(0.3, jnp.float32),
                            jnp.asarray(XYZ_LR, jnp.float32), **kw)


def _torch_step(state, opt, k, gt, bucketed):
    camera = TCamera(**_cam(k)).render_inputs(device="cpu")
    kw = dict(sh_degree=3, max_instances=M, opt_cfg_leaves=OPT)
    if bucketed:
        pad = np.zeros((3, BH, BW), np.float32)
        pad[:, :H, :W] = gt
        kw.update(width=BW, height=BH, real_wh=(W, H))
        gt = pad
    else:
        kw.update(width=W, height=H)
    return tstep.train_step(state, opt, camera, torch.from_numpy(gt),
                            torch.from_numpy(BG), 0.3,
                            torch.tensor(XYZ_LR), **kw)


def _carry(jstate, jopt):
    params = {k: np.asarray(v) for k, v in jstate.params._asdict().items()}
    stats = {k: np.asarray(getattr(jstate, k)) for k in tgmod.STAT_FIELDS}
    state = tgmod.from_numpy(params, int(jstate.n_alive), device="cpu",
                             stats=stats)
    opt = tadam.from_numpy(
        {k: np.asarray(v) for k, v in jopt.mu._asdict().items()},
        {k: np.asarray(v) for k, v in jopt.nu._asdict().items()},
        int(jopt.step), device="cpu")
    return state, opt


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bucketed", [False, True])
def test_train_step_matches_jax(bucketed):
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    j1 = jgmod.from_arrays(**_raw(), capacity=CAPACITY)
    live = np.arange(CAPACITY) < N      # dead rows keep zero statistics
    j1 = j1._replace(**{k: jnp.asarray(v * live, jnp.float32) for k, v in (
        ("max_radii2d", rng.integers(0, 6, CAPACITY)),
        ("xyz_gradient_accum", rng.uniform(0, 1e-2, CAPACITY)),
        ("denom", rng.integers(0, 4, CAPACITY)))})
    jo1 = jadam.init(j1.params)
    j2, jo2, ja = _jax_step(j1, jo1, 1, gt, bucketed)

    t1, to1 = _carry(j1, jo1)
    t2, to2, ta = _torch_step(t1, to1, 1, gt, bucketed)

    np.testing.assert_allclose(float(ta.loss), float(ja.loss), rtol=1e-5)
    np.testing.assert_allclose(float(ta.l1), float(ja.l1), rtol=1e-5)
    assert int(ta.num_instances) == int(ja.num_instances) > 0
    assert bool(ta.instance_overflow) == bool(ja.instance_overflow) is False
    assert ta.n_alive == int(ja.n_alive) == N
    assert int(to2.step) == int(jo2.step) == 1
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(t2, k).numpy(),
                                      np.asarray(getattr(j2, k)), err_msg=k)
    assert _rel_err(t2.xyz_gradient_accum, j2.xyz_gradient_accum) < 1e-4
    for name in tgmod.GaussianParams._fields:
        i = tgmod.GaussianParams._fields.index(name)
        assert _rel_err(to2.mu[i], jo2.mu[i]) < 1e-4, name
        assert _rel_err(to2.nu[i], jo2.nu[i]) < 1e-4, name
        # this step's JAX gradient, from its first moment
        g = np.asarray(jo2.mu[i], np.float64) / 0.1
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = t2.params[i].numpy(), np.asarray(j2.params[i])
        np.testing.assert_allclose(got[big], want[big], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert np.abs(got - want)[~big].max(initial=0.0) <= \
            2 * LRS[name], name


def test_train_step_is_deterministic_and_leaves_its_inputs():
    state = tgmod.from_arrays(**_raw(seed=2), capacity=CAPACITY,
                              device="cpu")
    opt = tadam.init(state.params)
    before = [x.clone() for x in list(state.params) + list(opt.mu)]
    gt = np.random.default_rng(3).uniform(0, 1, (3, H, W)).astype(np.float32)
    seen = []
    a = _torch_step(state, opt, 0, gt, False)
    b = tstep.train_step(
        state, opt, TCamera(**_cam(0)).render_inputs(device="cpu"),
        torch.from_numpy(gt), torch.from_numpy(BG), 0.3,
        torch.tensor(XYZ_LR), width=W, height=H, sh_degree=3,
        max_instances=M, opt_cfg_leaves=OPT,
        on_stage=lambda *kv: seen.append(kv[0]))
    for x, y in zip(list(a[0].params) + list(a[1].mu) + list(a[1].nu),
                    list(b[0].params) + list(b[1].mu) + list(b[1].nu)):
        assert torch.equal(x, y)
    for k in tgmod.STAT_FIELDS:
        assert torch.equal(getattr(a[0], k), getattr(b[0], k))
    assert all(torch.equal(x, y) for x, y in zip(
        before, list(state.params) + list(opt.mu)))
    assert all(not x.requires_grad for x in a[0].params)
    assert tuple(seen) == trender.STAGES + ("loss",) + \
        trender.BACKWARD_STAGES + tstep.TRAIN_STAGES[1:]
