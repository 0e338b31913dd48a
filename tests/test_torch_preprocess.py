"""ops.preprocess on the CPU: the entry's plain route and the kernels' math.

The entry (``preprocess``, ``render.render_params``) runs the plain version
on a CPU state, so ``train_step`` and ``eval_render`` give today's outputs
and raw-leaf gradients bit for bit: those of ``gaussians.activate``
followed by ``render.render``. Calls with activated tensors or an override
keep the plain ops and never touch the kernels' counters.

The kernels themselves run only on a card
(tests/test_torch_preprocess_kernel.py). Their arithmetic is held here
through tests/torch_preprocess_mirror.py, a line-by-line copy in torch: its
backward against autograd through the plain version in float64 (the
chain rule, to 1e-10) and in float32 (rounding, to the card tests' 1e-6),
its forward against the plain version, and the rows a render culls (behind
the near plane, a zero determinant, opacity under 1/255, dead rows, a
mean at the camera centre), whose zero cotangents must give zero
gradients and no NaN. No JAX here.
"""

import numpy as np
import pytest
import torch

import torch_preprocess_mirror as mirror
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import preprocess as prep_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.train import step

torch.set_num_threads(1)

W, H, M = 96, 64, 1 << 14
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}
OUTS = ("xy", "depth", "conic", "rgb", "opacity")


def _camera(dtype=torch.float32, yaw=0.0):
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    cam = Camera(uid=0, image_name="t", R=R, T=np.array([0.1, 0.0, 0.0]),
                 fovx=1.0, fovy=0.7, image=None, width=W,
                 height=H).render_inputs("cpu")
    return {k: v.to(dtype) for k, v in cam.items()}


def _arrays(n=2000, rest=15, seed=0, special=False):
    """A seeded scene in front of the camera; ``special`` adds the rows a
    render culls: 40 behind the near plane, 40 whose scales are 0 (a zero
    determinant at low_pass 0), 40 of opacity under 1/255, one at the
    camera centre (the first)."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(2, 8, (n, 1))], 1)
    scaling = rng.uniform(-4.5, -2.5, (n, 3))
    opacity = rng.normal(0, 1.5, (n, 1))
    if special:
        xyz[1:41, 2] = rng.uniform(-3, 0.2, 40)
        scaling[41:81] = -np.inf
        opacity[81:121] = -8.0
    return [xyz, rng.normal(0, 0.5, (n, 1, 3)),
            rng.normal(0, 0.3, (n, rest, 3)), scaling,
            rng.normal(size=(n, 4)), opacity]


def _params(arrays, dtype, requires_grad=False):
    p = gmod.GaussianParams(*[torch.tensor(np.array(a), dtype=dtype)
                              for a in arrays])
    if requires_grad:
        p = gmod.GaussianParams(*[t.requires_grad_(True) for t in p])
    return p


def _cotangents(prep, seed=5):
    """Seeded cotangents of the float outputs, zero on culled rows (as a
    render's are: a culled Gaussian has no instance)."""
    rng = np.random.default_rng(seed)
    vis = prep.tiles_touched > 0
    out = []
    for f in OUTS:
        t = getattr(prep, f)
        c = torch.tensor(rng.normal(size=t.shape), dtype=t.dtype)
        out.append(c * vis.view(-1, *[1] * (c.dim() - 1)))
    return out


def _gap(a, b):
    nb = float(b.double().norm())
    d = float((a.double() - b.double()).norm())
    return d / nb if nb > 0 else d


def _autograd(arrays, dtype, camera, deg, *, width=W, height=H, grid=None,
              low_pass=0.3, scale_modifier=1.0, alive=None):
    leaves = _params(arrays, dtype, requires_grad=True)
    n = leaves.xyz.shape[0]
    alive = torch.ones(n, dtype=torch.bool) if alive is None else alive
    prep = prep_ops.preprocess_torch(
        leaves, alive, sh_degree=deg, camera=camera, width=width,
        height=height, grid=grid, low_pass=low_pass,
        scale_modifier=scale_modifier)
    cots = _cotangents(prep)
    grads = torch.autograd.grad([getattr(prep, f) for f in OUTS],
                                list(leaves), cots)
    return prep, cots, grads


@pytest.mark.parametrize("deg,rest", [(0, 15), (1, 15), (2, 15), (3, 15),
                                      (3, 24), (4, 24)])
@pytest.mark.parametrize("scale_modifier", [1.0, 1.7])
def test_mirror_backward_is_autograd_through_the_plain_version(
        deg, rest, scale_modifier):
    """The kernels' chain rule, in float64: each leaf's gradient within
    1e-10 of autograd's through preprocess_torch, features_rest zero past
    the degree's rows."""
    arrays = _arrays(rest=rest, seed=deg)
    cam = _camera(torch.float64, yaw=0.05)
    alive = torch.arange(2000) < 1900
    _, cots, want = _autograd(arrays, torch.float64, cam, deg, alive=alive,
                              scale_modifier=scale_modifier)
    got = mirror.backward(_params(arrays, torch.float64), cam, W, H, 0.3,
                          scale_modifier, deg, *cots)
    for name, a, b in zip(gmod.GaussianParams._fields, got, want):
        assert _gap(a, b) <= 1e-10, (name, _gap(a, b))
    k = (deg + 1) ** 2 - 1
    assert not bool(got[2][:, k:].any())


def test_mirror_backward_in_float32_is_within_rounding():
    """In float32, as the kernels run, each leaf within a relative norm gap
    of 1e-6 of autograd's float32 gradients (the card tests' bar), with
    anisotropic scales and random rotations so that every leaf takes a
    gradient."""
    arrays = _arrays(n=20000, seed=3)
    cam = _camera(torch.float32)
    _, cots, want = _autograd(arrays, torch.float32, cam, 3)
    got = mirror.backward(_params(arrays, torch.float32), cam, W, H, 0.3,
                          1.0, 3, *cots)
    for name, a, b in zip(gmod.GaussianParams._fields, got, want):
        assert float(b.norm()) > 0, name
        assert _gap(a, b) <= 1e-6, (name, _gap(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_culled_rows_take_zero_gradients_and_no_nan(dtype):
    """Rows behind the near plane, with a zero determinant (zero scales at
    low_pass 0), with opacity under 1/255, dead, or at the camera centre:
    culled by the forward (no tile), so their cotangents are zero, and the
    kernels' math gives them zero gradients and no NaN anywhere, as
    autograd does."""
    arrays = _arrays(special=True, seed=4)
    cam = _camera(dtype)
    arrays[0][0] = cam["camera_center"].double().numpy()
    alive = torch.arange(2000) < 1950
    prep, cots, want = _autograd(arrays, dtype, cam, 3, low_pass=0.0,
                                 alive=alive)
    det = prep.conic.abs().sum(1) == 0          # det_inv = 0
    culled = torch.zeros(2000, dtype=torch.bool)
    culled[1:121] = True
    culled[1950:] = True
    assert not bool((prep.tiles_touched[culled] > 0).any())
    assert bool(det[41:81].all())
    assert not bool((prep.radii[1:41] > 0).any())
    assert bool((prep.radii[81:121] > 0).any())    # in view, yet culled
    got = mirror.backward(_params(arrays, dtype), cam, W, H, 0.0, 1.0, 3,
                          *cots)
    for name, a, b in zip(gmod.GaussianParams._fields, got, want):
        assert bool(torch.isfinite(a).all()), name
        assert not bool(a[culled].any()), name
        assert not bool(b[culled].any()), name
        tol = 1e-10 if dtype == torch.float64 else 1e-6
        assert _gap(a, b) <= tol, (name, _gap(a, b))


@pytest.mark.parametrize("case", ["exact", "bucketed", "scale_modifier",
                                  "no_tight"])
def test_mirror_forward_is_the_plain_version(case):
    """The forward kernel's body against preprocess_torch in float64: the
    integer outputs equal, the floats within 1e-12. ``bucketed`` takes a
    true size under the grid's (0-d int32 tensors), as a bucketed step."""
    arrays = _arrays(special=True, seed=6)
    cam = _camera(torch.float64, yaw=-0.04)
    alive = torch.arange(2000) < 1950
    width, height, grid = W, H, ((W + 15) // 16, (H + 15) // 16)
    sm, tight = 1.0, True
    if case == "bucketed":
        width, height = (torch.tensor(v, dtype=torch.int32)
                         for v in (W - 13, H - 7))
    elif case == "scale_modifier":
        sm = torch.tensor(0.6, dtype=torch.float64)
    elif case == "no_tight":
        tight = False
    p = _params(arrays, torch.float64)
    want = prep_ops.preprocess_torch(
        p, alive, sh_degree=3, camera=cam, width=width, height=height,
        grid=grid, scale_modifier=sm, tight_opacity_culling=tight)
    got = mirror.forward(p, alive, cam, width, height, 0.3, sm, 3, grid,
                         tight=tight)
    for f in ("radii", "rect_min", "rect_wh", "tiles_touched"):
        assert torch.equal(got[f], getattr(want, f)), f
    for f in OUTS:
        torch.testing.assert_close(got[f], getattr(want, f), rtol=1e-12,
                                   atol=1e-12)
    assert int(want.tiles_touched.sum()) > 0


def _state(arrays, n_alive):
    return gmod.from_arrays(*arrays, device="cpu")._replace(n_alive=n_alive)


def _old_render(params, alive, **kw):
    """ops.render from the activated tensors: the path before the entry."""
    scales, quats, opac, shs = gmod.activate(params)
    return render_ops.render(params.xyz, scales, quats, opac, shs, alive,
                             **kw)


@pytest.mark.parametrize("bucketed", [False, True])
def test_train_step_on_cpu_gives_the_activated_paths_gradients(bucketed):
    """train_step on a CPU state (through render_params and the plain
    route): its gradients (the "grads" stage) and results equal, bit for
    bit, autograd through gaussians.activate and render.render, the path
    the step took before; no kernel launch is counted."""
    arrays = _arrays(rest=15, seed=8)
    arrays[5] = np.abs(arrays[5])
    st = _state(arrays, 1900)
    cam = _camera()
    gt = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (3, H, W)).astype(np.float32))
    bg = torch.tensor([0.2, 0.3, 0.1])
    real_wh = (torch.tensor(W - 5, dtype=torch.int32),
               torch.tensor(H - 3, dtype=torch.int32)) if bucketed else None
    seen = {}
    n0 = (prep_ops.preprocess_forward.launches,
          prep_ops.preprocess_backward.launches)
    _, _, aux = step.train_step(
        st, adam_mod.init(st.params), cam, gt, bg, 0.3, 1.6e-4, width=W,
        height=H, sh_degree=3, max_instances=M, opt_cfg_leaves=OPT,
        real_wh=real_wh, on_stage=seen.__setitem__)
    assert (prep_ops.preprocess_forward.launches,
            prep_ops.preprocess_backward.launches) == n0
    grads, tap_grad = seen["grads"]

    params = gmod.GaussianParams(*[p.detach().requires_grad_(True)
                                   for p in st.params])
    tap = torch.zeros((st.capacity, 2), requires_grad=True)
    out = _old_render(params, gmod.alive_mask(st), camera=cam, width=W,
                      height=H, sh_degree=3, bg=bg, low_pass=0.3,
                      max_instances=M, xy_tap=tap, need_depth=False,
                      render_wh=real_wh)
    if real_wh is None:
        loss, _ = loss_ops.training_loss(out.render, gt, 0.2)
    else:
        loss, _ = loss_ops.masked_training_loss(out.render, gt, real_wh[0],
                                                real_wh[1], 0.2)
    *want, want_tap = torch.autograd.grad(loss, [*params, tap])
    assert torch.equal(aux.loss, loss.detach())
    assert torch.equal(tap_grad, want_tap)
    for name, a, b in zip(gmod.GaussianParams._fields, grads, want):
        assert torch.equal(a, b), name
    assert float(grads.rotation.abs().sum()) > 0


def test_eval_render_on_cpu_is_the_activated_path():
    """eval_render on a CPU state equals render.render from the activated
    tensors, every output bit for bit, at a scale_modifier of 0.8."""
    arrays = _arrays(rest=15, seed=10)
    st = _state(arrays, 1800)
    cam = _camera(yaw=0.03)
    bg = torch.tensor([0.0, 0.5, 1.0])
    sm = torch.tensor(0.8)
    got = step.eval_render(st, cam, bg, 0.3, sm, width=W, height=H,
                           sh_degree=2, max_instances=M)
    want = _old_render(st.params, gmod.alive_mask(st), camera=cam, width=W,
                       height=H, sh_degree=2, bg=bg, low_pass=0.3,
                       max_instances=M, scale_modifier=sm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got.num_instances) > 0


def test_preprocess_entry_on_cpu_is_preprocess_torch():
    """The entry on CPU leaves returns preprocess_torch's outputs and
    autograd graph: outputs and the six leaves' gradients bit for bit."""
    arrays = _arrays(seed=11)
    cam = _camera()
    alive = torch.arange(2000) < 1990
    outs = []
    for fn in (prep_ops.preprocess, prep_ops.preprocess_torch):
        leaves = _params(arrays, torch.float32, requires_grad=True)
        prep = fn(leaves, alive, sh_degree=3, camera=cam, width=W, height=H,
                  grid=((W + 15) // 16, (H + 15) // 16))
        cots = _cotangents(prep)
        outs.append((prep, torch.autograd.grad(
            [getattr(prep, f) for f in OUTS], list(leaves), cots)))
    (p1, g1), (p2, g2) = outs
    for a, b in zip(list(p1) + list(g1), list(p2) + list(g2)):
        assert torch.equal(a, b)


def test_override_route_takes_the_plain_ops():
    """render.render with a colour and a covariance override (the sharded
    step's call) runs projection.preprocess's plain ops: the overrides
    reach the output and the kernels' counters stay where they were."""
    arrays = _arrays(seed=12)
    st = _state(arrays, 2000)
    cam = _camera()
    scales, quats, opac, shs = gmod.activate(st.params)
    n0 = (prep_ops.preprocess_forward.launches,
          prep_ops.preprocess_backward.launches)
    colours = torch.rand((2000, 3), generator=torch.Generator().manual_seed(0))
    kw = dict(camera=cam, width=W, height=H, sh_degree=3,
              bg=torch.zeros(3), max_instances=M)
    base = render_ops.render(st.params.xyz, scales, quats, opac, shs,
                             gmod.alive_mask(st), **kw)
    over = render_ops.render(st.params.xyz, scales, quats, opac, shs,
                             gmod.alive_mask(st), colors_override=colours,
                             **kw)
    assert not torch.equal(base.render, over.render)
    assert torch.equal(base.radii, over.radii)
    assert (prep_ops.preprocess_forward.launches,
            prep_ops.preprocess_backward.launches) == n0


@pytest.mark.parametrize("fault,match", [
    ("dtype", "contiguous"), ("layout", "contiguous"),
    ("degree", "SH degree"), ("rest", "SH degree"), ("alive", "alive"),
    ("device", "run on CUDA")])
def test_wrappers_raise_on_what_the_kernels_do_not_take(fault, match):
    """The kernel wrappers check their inputs before any launch: float32,
    contiguous, the leaves' shapes, a degree of 0..4 with the rows it
    needs, a bool alive mask, CUDA tensors; ValueError naming the fault
    otherwise."""
    p = _params(_arrays(n=64), torch.float32)
    alive = torch.ones(64, dtype=torch.bool)
    deg = 3
    if fault == "dtype":
        p = p._replace(scaling=p.scaling.double())
    elif fault == "layout":
        p = p._replace(rotation=p.rotation.T.contiguous().T)
    elif fault == "degree":
        deg = 5
    elif fault == "rest":
        deg = 4
    elif fault == "alive":
        alive = alive.float()
    vals = prep_ops.CallValues(*[torch.zeros(s) for s in
                                 ((4, 4), (4, 4), (3,))],
                               *[torch.zeros(()) for _ in range(4)],
                               *[torch.zeros((), dtype=torch.int32)] * 2)
    with pytest.raises(ValueError, match=match):
        prep_ops.preprocess_forward(p, alive, vals, sh_degree=deg,
                                    grid=(6, 4))
    if fault != "alive":
        with pytest.raises(ValueError, match=match):
            prep_ops.preprocess_backward(p, vals, sh_degree=deg, d_xy=None,
                                         d_depth=None, d_conic=None,
                                         d_rgb=None, d_opacity=None)


def test_call_values_are_device_tensors():
    """call_values: numbers become 0-d tensors (f32; the size int32), the
    camera's tensors are taken as they are; a matrix of another shape
    raises ValueError."""
    cam = _camera()
    vals = prep_ops.call_values(cam, W, torch.tensor(H - 1,
                                                     dtype=torch.int32),
                                0.3, 1.0, torch.device("cpu"))
    assert vals.width.dtype == torch.int32 and int(vals.width) == W
    assert int(vals.height) == H - 1
    assert vals.low_pass.dtype == torch.float32 and vals.low_pass.dim() == 0
    assert torch.equal(vals.world_view, cam["world_view"])
    bad = dict(cam, world_view=cam["world_view"][:3])
    with pytest.raises(ValueError):
        prep_ops.call_values(bad, W, H, 0.3, 1.0, torch.device("cpu"))
