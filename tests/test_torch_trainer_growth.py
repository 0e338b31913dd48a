"""Port parity for the Trainer loop across a capacity growth: the port's
Trainer against rain_tpu's on the toy scene, with the harness and the
tolerances of tests/test_torch_trainer.py (see its docstring).

A white background, so the opacity also resets at densify_from_iter; the
first densify round asks for more rows than the capacity of 256 holds,
drops the excess and forces the growth to 4096; training goes on at the
grown capacity through two more rounds and a periodic opacity reset. JAX
compiles train_step at the two capacities, two compilations in all (the
tier of 8192 never overflows). The second test takes a crowded copy of
the scene to the ``max_capacity`` rail: one clamped growth, then every
growth refused, every round's appends dropped; its one more compilation
is the capacity of 2,560.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_trainer import (check_traces, port_scene, run_pair,  # noqa
                                scenes)

RAIL_POINTS = 2500


def test_trainer_trace_across_growth_matches_rain_tpu(monkeypatch, scenes,
                                                      tmp_path):
    jax_run, torch_run = run_pair(
        monkeypatch, scenes, tmp_path,
        opt=dict(iterations=30, densify_from_iter=5,
                 densification_interval=10, densify_until_iter=40,
                 opacity_reset_interval=25),
        system=dict(capacity=256, max_instances=8192, seed=1, log_every=5),
        rain=dict(warmup_iter=12), model=dict(white_background=True))
    events = jax_run[1]["events"]
    resets = [e for e in events if e[0] == "reset"]
    assert [r[1] for r in resets] == [256, 4096]     # at 5 and at 25
    dens = [e for e in events if e[0] == "densify"]
    assert [d[1] for d in dens] == [256, 4096, 4096]
    assert dens[0][5][4] and not dens[1][5][4]       # the first overflowed
    assert [e for e in events if e[0] == "grow"] == [("grow", 256, 4096)]
    assert [d[3] for d in dens] == [True, False, False]     # abe_split
    assert [d[4] for d in dens] == [False, False, True]     # size threshold
    assert not any(s[1] for s in jax_run[1]["steps"])
    late = check_traces(jax_run, torch_run)
    assert np.isfinite(late)



@pytest.fixture(scope="module")
def crowded(scenes):
    """The toy scene with 2,500 init points: the 120 of its init, each
    repeated with jitter (sigma 0.02), so that a few rounds reach the
    rail."""
    jscene, _ = scenes
    rng = np.random.default_rng(4)
    pick = rng.integers(0, jscene.points.shape[0], RAIL_POINTS)
    jscene = dataclasses.replace(
        jscene,
        points=(jscene.points[pick] + rng.normal(
            0, 0.02, (RAIL_POINTS, 3))).astype(np.float32),
        colors=jscene.colors[pick])
    return jscene, port_scene(jscene)


def test_trainer_trace_at_the_capacity_rail_matches_rain_tpu(
        monkeypatch, crowded, tmp_path):
    """max_capacity 4000 (rain_tpu/train/trainer.py:222-244 against
    rain_tpu_torch/train/trainer.py:329-352). 2,500 Gaussians at a
    capacity of 2,560: the round at 3 grows it, clamped to
    round_up(4000, 4096) = 4096 in place of 5,120; every Gaussian with a
    gradient splits (threshold 1e-20; percent_dense 1e-5 puts every scale
    far above the split size), so the round's appends overflow and are
    dropped, and every later growth is refused at the rail ("at
    max_capacity — not growing"), forced or not. Besides the traces, the
    live params at the end within two Adam steps of lr. JAX compiles
    train_step at the capacity 2,560 only: the first test compiled it at
    4,096 and the tier of 8,192 (never overflowed here)."""
    jax_run, torch_run = run_pair(
        monkeypatch, crowded, tmp_path,
        opt=dict(iterations=10, densify_from_iter=1,
                 densification_interval=3, densify_until_iter=100,
                 opacity_reset_interval=1000, densify_grad_threshold=1e-20,
                 percent_dense=1e-5),
        system=dict(capacity=2560, max_instances=8192, seed=2,
                    log_every=5, max_capacity=4000),
        rain=dict(warmup_iter=0))
    events = jax_run[1]["events"]
    assert [e for e in events if e[0] == "grow"] == [("grow", 2560, 4096)]
    dens = [e for e in events if e[0] == "densify"]
    # every round at the rail, and every one's appends dropped
    assert [d[1] for d in dens] == [4096] * 3
    assert all(d[5][4] for d in dens)
    # the round at 9 starts above 0.6 of the capacity, and is refused too
    assert [d[2] for d in dens] == [2500, 1596, 2500]
    assert not any(s[1] for s in jax_run[1]["steps"])
    late = check_traces(jax_run, torch_run)
    assert np.isfinite(late)
    # the live params: split children whose gradient sits at its
    # rounding's level may take Adam steps of another sign, each at most
    # lr·|m̂|/(sqrt(v̂) + eps) ≈ lr; two such steps are the bar
    jt, tt = jax_run[0], torch_run[0]
    opt = tt.opt_cfg
    lrs = dict(xyz=opt.position_lr_init * tt.spatial_lr_scale,
               features_dc=opt.feature_lr, features_rest=opt.feature_lr / 20,
               scaling=opt.scaling_lr, rotation=opt.rotation_lr,
               opacity=opt.opacity_lr)
    n = tt.state.n_alive
    for name, a, b in zip(jt.state.params._fields, jt.state.params,
                          tt.state.params):
        err = np.abs(np.asarray(a)[:n] - b[:n].numpy())
        assert err.max() <= 2 * lrs[name], (name, err.max())
