"""Port parity: Adam, the densification statistics and the state carry-over.

rain_tpu_torch.model.{adam,densify,gaussians} against rain_tpu.model's on
the same seeded arrays (the counterparts of tests/test_model.py:21,44).
Adam is element-wise and written in the JAX order, so it agrees to f32
rounding of its power, square root and division.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.model import adam as jadam
from rain_tpu.model import densify as jdensify
from rain_tpu.model import gaussians as jgmod
from rain_tpu_torch.model import adam as tadam
from rain_tpu_torch.model import densify as tdensify
from rain_tpu_torch.model import gaussians as tgmod

torch.set_num_threads(1)

LRS = (0.01, 0.0025, 0.000125, 0.005, 0.001, 0.05)


def _raw(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(xyz=rng.normal(0, 1, (n, 3)),
                f_dc=rng.normal(0, 0.3, (n, 1, 3)),
                f_rest=rng.normal(0, 0.1, (n, 15, 3)),
                scaling=rng.uniform(-4, -2, (n, 3)),
                rotation=rng.normal(size=(n, 4)),
                opacity=rng.normal(0, 1, (n, 1)))


def _states(n=16, cap=64):
    raw = {k: v.astype(np.float32) for k, v in _raw(n).items()}
    return (jgmod.from_arrays(**raw, capacity=cap),
            tgmod.from_arrays(**raw, capacity=cap, device="cpu"))


def _grads(params, rng, alive=None):
    g = [rng.normal(0, 1, p.shape).astype(np.float32) for p in params]
    if alive is not None:
        for x in g:
            x[alive:] = 0.0
    return g


def test_adam_update_matches_jax_over_steps():
    jstate, tstate = _states()
    jopt, topt = jadam.init(jstate.params), tadam.init(tstate.params)
    jp, tp = jstate.params, tstate.params
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = _grads(jp, rng, alive=16)
        jp, jopt = jadam.update(jp, jgmod.GaussianParams(
            *[jnp.asarray(x) for x in g]), jopt, jgmod.GaussianParams(*LRS))
        tp, topt = tadam.update(tp, tgmod.GaussianParams(
            *[torch.from_numpy(x) for x in g]), topt,
            tgmod.GaussianParams(*LRS))
    assert int(topt.step) == int(jopt.step) == 3
    for name, a, b, m1, m2, v1, v2 in zip(
            tgmod.GaussianParams._fields, tp, jp, topt.mu, jopt.mu, topt.nu,
            jopt.nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(m1.numpy(), np.asarray(m2), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
        np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=1e-6,
                                   atol=1e-12, err_msg=name)
        # dead rows have zero grads and moments: unchanged, bit for bit
        assert torch.equal(a[16:], tstate.params[
            tgmod.GaussianParams._fields.index(name)][16:])


def test_adam_matches_torch_formula_and_leaves_inputs_untouched():
    _, tstate = _states()
    opt = tadam.init(tstate.params)
    before = [p.clone() for p in tstate.params]
    g = tgmod.GaussianParams(*[torch.from_numpy(x) for x in _grads(
        tstate.params, np.random.default_rng(2))])
    new, new_opt = tadam.update(tstate.params, g, opt,
                                tgmod.GaussianParams(*LRS))
    # torch-Adam at t=1 for the xyz leaf (tests/test_model.py:33-40)
    m = 0.1 * g.xyz.numpy()
    v = 0.001 * g.xyz.numpy() ** 2
    want = before[0].numpy() - 0.01 * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-15)
    np.testing.assert_allclose(new.xyz.numpy(), want, rtol=1e-5)
    assert int(new_opt.step) == 1 and int(opt.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tstate.params))
    assert all(torch.all(x == 0.0) for x in opt.mu + opt.nu)


def _adam_inputs(n=16, cap=64, seed=5):
    """A CPU state with seeded gradients and moments on its first ``n``
    rows (the rest dead: zero), at step 6."""
    _, tstate = _states(n, cap)
    rng = np.random.default_rng(seed)

    def leaves(scale, fn=lambda x: x):
        return tgmod.GaussianParams(*[torch.from_numpy(fn(np.where(
            np.arange(cap).reshape((-1,) + (1,) * (p.dim() - 1)) < n,
            rng.normal(0, scale, tuple(p.shape)), 0.0)).astype(np.float32))
            for p in tstate.params])

    opt = tadam.AdamState(mu=leaves(0.1), nu=leaves(0.01, np.square),
                          step=torch.tensor(5, dtype=torch.int32))
    return tstate.params, leaves(1.0), opt


def test_adam_update_on_cpu_is_update_plain_bits():
    params, grads, opt = _adam_inputs()
    lrs = tgmod.GaussianParams(torch.tensor(LRS[0]), *LRS[1:])
    n0 = tadam.update.launches
    got_p, got_opt = tadam.update(params, grads, opt, lrs)
    want_p, want_opt = tadam.update_plain(params, grads, opt, lrs)
    assert tadam.update.launches == n0
    for a, b in zip(list(got_p) + list(got_opt.mu) + list(got_opt.nu),
                    list(want_p) + list(want_opt.mu) + list(want_opt.nu)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got_opt.step) == int(want_opt.step) == 6
    for a, b in zip(got_p, params):     # dead rows unchanged
        assert torch.equal(a[16:].view(torch.int32), b[16:].view(torch.int32))


def _bad_adam_input(case):
    """(params, grads, state, lrs) with one thing the kernel does not take."""
    params, grads, opt = _adam_inputs()
    lrs = tgmod.GaussianParams(*LRS)
    if case == "non-contiguous":
        grads = grads._replace(features_rest=grads.features_rest.transpose(
            1, 2).contiguous().transpose(1, 2))
    elif case == "float64":
        opt = opt._replace(nu=opt.nu._replace(scaling=opt.nu.scaling.double()))
    elif case == "shape":
        grads = grads._replace(opacity=grads.opacity[:-1])
    elif case == "mixed-device":
        opt = opt._replace(mu=opt.mu._replace(
            rotation=torch.empty_like(opt.mu.rotation, device="meta")))
    elif case == "learning-rate":
        lrs = lrs._replace(xyz=torch.tensor(LRS[0], dtype=torch.float64))
    elif case == "step-device":
        opt = opt._replace(step=torch.empty((), dtype=torch.int32,
                                            device="meta"))
    return params, grads, opt, lrs


@pytest.mark.parametrize("case", ["non-contiguous", "float64", "shape",
                                  "mixed-device", "learning-rate",
                                  "step-device"])
def test_adam_update_rejects_what_the_kernel_does_not_take(case):
    args = _bad_adam_input(case)
    n0 = tadam.update.launches
    with pytest.raises(ValueError):
        tadam.update(*args)
    assert tadam.update.launches == n0


def test_compiled_counts_adam_launches():
    from rain_tpu_torch.train import compiled
    assert compiled.COUNTED[-1] == (tadam.update, "launches")
    assert compiled.launch_counts()[-1] == tadam.update.launches


def test_adam_from_numpy_and_zero_moments_for():
    jstate, _ = _states()
    jopt = jadam.init(jstate.params)
    g = jgmod.GaussianParams(*[jnp.asarray(x) for x in _grads(
        jstate.params, np.random.default_rng(3))])
    _, jopt = jadam.update(jstate.params, g, jopt, jgmod.GaussianParams(*LRS))
    topt = tadam.from_numpy(
        {k: np.asarray(v) for k, v in jopt.mu._asdict().items()},
        {k: np.asarray(v) for k, v in jopt.nu._asdict().items()},
        int(jopt.step), device="cpu")
    for a, b in zip(topt.mu + topt.nu, jopt.mu + jopt.nu):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(topt.step) == 1 and topt.step.dtype == torch.int32
    z = tadam.zero_moments_for(topt, "opacity")
    assert torch.all(z.mu.opacity == 0.0) and torch.all(z.nu.opacity == 0.0)
    assert torch.equal(z.mu.xyz, topt.mu.xyz) and torch.all(topt.mu.opacity
                                                            != 0.0)


def test_learning_rates_match_jax():
    cfg = types.SimpleNamespace(feature_lr=0.0025, opacity_lr=0.05,
                                scaling_lr=0.005, rotation_lr=0.001)
    want = jadam.learning_rates(cfg, 1.6e-4)
    got = tadam.learning_rates(cfg, 1.6e-4)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g == w, name


@pytest.mark.parametrize("width,height", [(64, 48), (61, 45)])
def test_add_densification_stats_matches_jax(width, height):
    jstate, tstate = _states(n=40, cap=48)
    rng = np.random.default_rng(4)
    for _ in range(2):
        tap = rng.normal(0, 1e-3, (48, 2)).astype(np.float32)
        radii = rng.integers(-2, 9, 48).clip(0).astype(np.int32)
        jstate = jdensify.add_densification_stats(
            jstate, jnp.asarray(tap), jnp.asarray(radii), width, height)
        tstate = tdensify.add_densification_stats(
            tstate, torch.from_numpy(tap), torch.from_numpy(radii), width,
            height)
    for k in tgmod.STAT_FIELDS:
        np.testing.assert_allclose(getattr(tstate, k).numpy(),
                                   np.asarray(getattr(jstate, k)),
                                   rtol=1e-6, atol=0.0, err_msg=k)
    assert float(tstate.denom.max()) == 2.0


def test_from_numpy_carries_the_statistics():
    jstate, _ = _states(n=20, cap=24)
    rng = np.random.default_rng(5)
    jstate = jstate._replace(
        max_radii2d=jnp.asarray(rng.uniform(0, 9, 24), jnp.float32),
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 1, 24), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 5, 24), jnp.float32))
    stats = {k: np.asarray(getattr(jstate, k)) for k in tgmod.STAT_FIELDS}
    t = tgmod.from_numpy(
        {k: np.asarray(v) for k, v in jstate.params._asdict().items()}, 20,
        device="cpu", stats=stats)
    for k in tgmod.STAT_FIELDS:
        np.testing.assert_array_equal(getattr(t, k)[:20].numpy(),
                                      stats[k][:20])
        assert torch.all(getattr(t, k)[20:] == 0.0)
    plain = tgmod.from_numpy(
        {k: np.asarray(v) for k, v in jstate.params._asdict().items()}, 20,
        device="cpu")
    assert all(torch.all(getattr(plain, k) == 0.0)
               for k in tgmod.STAT_FIELDS)
