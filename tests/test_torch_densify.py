"""Port parity for the model's state management: create_from_pcd,
grow_capacity, reset_opacity and densify_and_prune, the counterparts of
tests/test_model.py:58-123,143-152.

A JAX state (create_from_pcd, then rows set as each case needs) is carried
into the port with ``from_numpy``; its Adam state with ``adam.from_numpy``.
rain_tpu draws the split noise inside densify_and_prune from
``jax.random.normal(key, (2, C, 3))``; the port takes it as an argument,
and JAX's own draw of that key is fed in.

The six densify cases run twice: through ``densify_and_prune`` with
Python numbers, and through the fixed-shape ``densify_round`` with
n_alive and the six scalars as 0-d tensors, as the compiled round takes
them. A dispatch mode shows that the round and ``reset_opacity`` read
nothing back from the device and make no shape from data, and the
round's output shapes follow from its key alone.

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
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from rain_tpu.model import adam as jadam
from rain_tpu.model import densify as jdens
from rain_tpu.model import gaussians as jgmod
from rain_tpu_torch.model import adam as tadam
from rain_tpu_torch.model import densify as tdens
from rain_tpu_torch.model import gaussians as tgmod
from rain_tpu_torch.train.compiled import ROUND_SCALARS

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


CASES = ["clone", "split", "abe", "transparent", "size", "overflow"]


def _as_tensors(state, kw):
    """(state, kw) with n_alive a 0-d int32 tensor and the six scalars 0-d
    f32 tensors (size_threshold at its default where kw has none)."""
    kw = dict(kw)
    for k in ROUND_SCALARS:
        kw[k] = torch.tensor(kw.get(k, 20.0), dtype=torch.float32)
    return state._replace(n_alive=torch.tensor(state.n_alive,
                                               dtype=torch.int32)), kw


@pytest.mark.parametrize("inputs", ["numbers", "tensors"])
@pytest.mark.parametrize("name", CASES)
def test_densify_and_prune_matches(name, inputs):
    js, kw = _case(name)
    jo = moments(js)
    key = jax.random.key(11)
    j2, jo2, jinfo = jdens.densify_and_prune(js, jo, key, **kw)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (2, js.capacity, 3))))
    ts, to = carry(js, jo)
    before = [x.clone() for x in ts.params]
    if inputs == "numbers":
        t2, to2, tinfo = tdens.densify_and_prune(ts, to, noise, **kw)
    else:
        state, tkw = _as_tensors(ts, kw)
        t2, to2, packed = tdens.densify_round(state, to, noise, **tkw)
        assert packed.dtype == torch.int32 and packed.shape == (5,)
        assert t2.n_alive.shape == ()
        tinfo = tdens.unpack_info(packed)
        assert int(t2.n_alive) == tinfo.n_alive
        t2 = t2._replace(n_alive=tinfo.n_alive)
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


class NoHostRead(TorchDispatchMode):
    """Fails on an operator that reads a value back to the host or makes a
    shape from data: ``_local_scalar_dense`` (``.item()``, ``int()``,
    ``bool()``), ``nonzero``, ``masked_select`` and ``index`` with a bool
    index. Records every operator it lets through."""

    FORBIDDEN = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
                 torch.ops.aten.masked_select)

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in self.FORBIDDEN or (
                packet is torch.ops.aten.index and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1])):
            raise AssertionError(f"{func} reads the device or makes a "
                                 f"shape from data")
        self.ops.add(packet)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", CASES)
def test_round_and_reset_make_no_host_read(name):
    js, kw = _case(name)
    ts, to = carry(js, moments(js))
    state, kw = _as_tensors(ts, kw)
    noise = torch.zeros(2, ts.capacity, 3)
    mode = NoHostRead()
    with mode:
        tdens.densify_round(state, to, noise, **kw)
        tdens.reset_opacity(state, to)
    assert torch.ops.aten.searchsorted in mode.ops
    assert torch.ops.aten.index in mode.ops     # the gathers, by int index
    # the mode catches what the round must not do
    for bad in (lambda: int(state.denom.sum()),
                lambda: torch.nonzero(state.denom),
                lambda: state.denom[state.denom > 0]):
        with pytest.raises(AssertionError, match="reads the device"):
            with NoHostRead():
                bad()


@pytest.mark.parametrize("abe_split,use_size_threshold",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_round_output_shapes_follow_the_key(abe_split, use_size_threshold):
    """Rounds of one key on cases that select, append and prune different
    rows give outputs of one set of shapes: the params' and moments' of
    the capacity, a 0-d n_alive, a [5] info."""
    shapes = set()
    for name in ("clone", "split", "transparent", "size"):
        js, kw = _case(name)
        ts, to = carry(js, moments(js))
        kw.update(abe_split=abe_split, use_size_threshold=use_size_threshold)
        state, kw = _as_tensors(ts, kw)
        s2, o2, info = tdens.densify_round(state, to, torch.zeros(
            2, ts.capacity, 3), **kw)
        shapes.add(tuple(tuple(x.shape) for x in (
            list(s2.params) + [getattr(s2, k) for k in tgmod.STAT_FIELDS] +
            list(o2.mu) + list(o2.nu) + [o2.step, s2.n_alive, info])))
    assert len(shapes) == 1
    (got,) = shapes
    want = tuple(tuple(x.shape) for x in (
        list(ts.params) + [getattr(ts, k) for k in tgmod.STAT_FIELDS] +
        list(to.mu) + list(to.nu) + [to.step])) + ((), (5,))
    assert got == want


def test_densify_rejects_wrong_noise():
    js, kw = _case("split")
    ts, to = carry(js, moments(js))
    with pytest.raises(ValueError, match="noise"):
        tdens.densify_and_prune(ts, to, torch.zeros(2, 8, 3), **kw)
