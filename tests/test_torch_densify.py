"""Port parity for the model's state management: create_from_pcd,
grow_capacity, reset_opacity and densify_and_prune, the counterparts of
tests/test_model.py:58-123,143-152.

A JAX state (create_from_pcd, then rows set as each case needs) is carried
into the port with ``from_numpy``; its Adam state with ``adam.from_numpy``.
rain_tpu draws the split noise inside densify_and_prune from
``jax.random.normal(key, (2, C, 3))``; the port takes it as an argument,
and JAX's own draw of that key is fed in.

Every field is compared over the whole capacity. DensifyInfo, n_alive,
the row order, Adam's moments and the statistics are held exactly; the
params bit for bit where no transcendental function touches them and at
rtol 1e-6 / atol 1e-7 otherwise: XLA's CPU exp, log and sigmoid are not
correctly rounded (about one value in ten sits an ulp from torch's), which
moves the split children's offsets (rotation · noise · exp(scale)), their
log-space scales (− log(divide_ratio · 2)), the reset opacities and the
KNN scales (log(sqrt(d²))) by an ulp. The children's xyz get atol 1e-5:
XLA's CPU backend also contracts the rotation matrix's products and the
offset's einsum into fused multiply-adds, which moves a rotation entry by
up to 4.8e-7, and the offsets here are up to ~20 long (scales up to e²).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.model import adam as jadam
from rain_tpu.model import densify as jdens
from rain_tpu.model import gaussians as jgmod
from rain_tpu_torch.model import adam as tadam
from rain_tpu_torch.model import densify as tdens
from rain_tpu_torch.model import gaussians as tgmod

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
# the split children's xyz: rotation · noise · exp(scale) with scales up
# to e² here, so offsets up to ~20 long
XYZ_ATOL = 1e-5
KW = dict(max_grad=0.5, min_opacity=0.005, extent=100.0,
          percent_dense=0.01, divide_ratio=0.8)


def points(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def mkstate(n=16, cap=64, seed=0):
    pts, cols = points(n, seed)
    return jgmod.create_from_pcd(pts, cols, sh_degree=3, capacity=cap,
                                 knn_window=8)


def carry(js, jo):
    state = tgmod.from_numpy(
        {k: np.asarray(v) for k, v in js.params._asdict().items()},
        int(js.n_alive), device="cpu",
        stats={k: np.asarray(getattr(js, k)) for k in tgmod.STAT_FIELDS})
    opt = tadam.from_numpy(
        {k: np.asarray(v) for k, v in jo.mu._asdict().items()},
        {k: np.asarray(v) for k, v in jo.nu._asdict().items()},
        int(jo.step), device="cpu")
    return state, opt


def compare(js, ts, jo=None, to=None, exact=()):
    assert ts.n_alive == int(js.n_alive)
    assert ts.capacity == js.capacity
    for name, a, b in zip(tgmod.GaussianParams._fields, js.params,
                          ts.params):
        a, b = np.asarray(a), b.numpy()
        if name in exact:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(
                b, a, rtol=RTOL, atol=XYZ_ATOL if name == "xyz" else ATOL,
                err_msg=name)
    for k in tgmod.STAT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    if jo is not None:
        assert int(to.step) == int(jo.step)
        for a, b in zip(list(jo.mu) + list(jo.nu), list(to.mu) + list(to.nu)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def moments(js, seed=3):
    """A JAX Adam state with seeded moments on the live rows."""
    rng = np.random.default_rng(seed)
    live = np.arange(js.capacity) < int(js.n_alive)

    def fill(x):
        shape = x.shape
        v = rng.normal(0, 1, shape).astype(np.float32)
        return jnp.asarray(v * live.reshape((-1,) + (1,) * (len(shape) - 1)))

    opt = jadam.init(js.params)
    return jadam.AdamState(mu=jax.tree.map(fill, opt.mu),
                           nu=jax.tree.map(lambda x: jnp.abs(fill(x)),
                                           opt.nu),
                           step=jnp.asarray(7, jnp.int32))


@pytest.mark.parametrize("knn_window", [8, 0])
def test_create_from_pcd_matches(knn_window):
    pts, cols = points(300, seed=4)
    js = jgmod.create_from_pcd(pts, cols, sh_degree=3, capacity=320,
                               knn_window=knn_window)
    ts = tgmod.create_from_pcd(pts, cols, sh_degree=3, capacity=320,
                               knn_window=knn_window, device="cpu")
    compare(js, ts, exact=("xyz", "features_dc", "features_rest",
                           "rotation", "opacity"))


def test_grow_capacity_matches():
    js = mkstate(n=16, cap=32)
    js = js._replace(denom=js.denom.at[:16].set(2.0))
    ts, _ = carry(js, jadam.init(js.params))
    jg, tg = jgmod.grow_capacity(js, 64), tgmod.grow_capacity(ts, 64)
    compare(jg, tg, exact=tgmod.GaussianParams._fields)
    assert tgmod.grow_capacity(tg, 64) is tg
    with pytest.raises(ValueError):
        tgmod.grow_capacity(tg, 32)


def test_reset_opacity_matches():
    js = mkstate(n=16, cap=32)
    op = js.params.opacity.at[:6].set(jnp.asarray(
        np.linspace(-8.0, 3.0, 6, dtype=np.float32)[:, None]))
    js = js._replace(params=js.params._replace(opacity=op))
    jo = moments(js)
    ts, to = carry(js, jo)
    j2, jo2 = jdens.reset_opacity(js, jo)
    t2, to2 = tdens.reset_opacity(ts, to)
    compare(j2, t2, jo2, to2, exact=("xyz", "features_dc", "features_rest",
                                     "scaling", "rotation"))
    assert float(torch.sigmoid(t2.params.opacity).max()) <= 0.0101
    assert float(to2.mu.opacity.abs().max()) == 0.0


def _case(name):
    """(JAX state, kwargs) of each densify case."""
    js = mkstate()
    rng = np.random.default_rng(5)
    rot = js.params.rotation.at[:16].set(jnp.asarray(
        rng.normal(size=(16, 4)).astype(np.float32)))
    js = js._replace(params=js.params._replace(rotation=rot),
                     denom=js.denom.at[:16].set(2.0))
    kw = dict(KW)

    def grads(rows):
        return js.xyz_gradient_accum.at[rows].set(3.0)

    if name == "clone":
        js = js._replace(xyz_gradient_accum=grads(slice(0, 4)))
    elif name in ("split", "abe"):
        # rows 0..1 big and rows 2..3 small, all four high-gradient: both
        # clones and splits, in the reference's append order
        sc = js.params.scaling.at[:2].set(2.0)
        js = js._replace(params=js.params._replace(scaling=sc),
                         xyz_gradient_accum=grads(slice(0, 4)))
        kw["abe_split"] = name == "abe"
    elif name == "transparent":
        op = js.params.opacity.at[5:8].set(jgmod.inverse_sigmoid(0.001))
        js = js._replace(params=js.params._replace(opacity=op))
    elif name == "size":
        sc = js.params.scaling.at[9].set(3.0)           # > 0.1 · extent
        js = js._replace(params=js.params._replace(scaling=sc),
                         max_radii2d=js.max_radii2d.at[3].set(30.0))
        kw["use_size_threshold"] = True
    elif name == "overflow":
        js = mkstate(n=16, cap=20)
        sc = js.params.scaling.at[:4].set(2.0)
        js = js._replace(params=js.params._replace(scaling=sc),
                         xyz_gradient_accum=js.xyz_gradient_accum.at[:4]
                         .set(1.0),
                         denom=js.denom.at[:16].set(1.0))
    return js, kw


@pytest.mark.parametrize("name", ["clone", "split", "abe", "transparent",
                                  "size", "overflow"])
def test_densify_and_prune_matches(name):
    js, kw = _case(name)
    jo = moments(js)
    key = jax.random.key(11)
    j2, jo2, jinfo = jdens.densify_and_prune(js, jo, key, **kw)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (2, js.capacity, 3))))
    ts, to = carry(js, jo)
    before = [x.clone() for x in ts.params]
    t2, to2, tinfo = tdens.densify_and_prune(ts, to, noise, **kw)
    assert tinfo == tdens.DensifyInfo(
        n_cloned=int(jinfo.n_cloned), n_split=int(jinfo.n_split),
        n_pruned=int(jinfo.n_pruned), n_alive=int(jinfo.n_alive),
        overflow=bool(jinfo.overflow))
    compare(j2, t2, jo2, to2, exact=("features_dc", "features_rest",
                                     "rotation", "opacity"))
    assert all(torch.equal(a, b) for a, b in zip(before, ts.params))
    expected = {"clone": (4, 0, 0, 20, False), "split": (2, 2, 2, 20, False),
                "abe": (2, 2, 2, 22, False),
                "transparent": (0, 0, 3, 13, False),
                "size": (0, 0, 2, 14, False),
                "overflow": (0, 4, 4, 16, True)}[name]
    assert tuple(tinfo) == expected


def test_densify_rejects_wrong_noise():
    js, kw = _case("split")
    ts, to = carry(js, moments(js))
    with pytest.raises(ValueError, match="noise"):
        tdens.densify_and_prune(ts, to, torch.zeros(2, 8, 3), **kw)
