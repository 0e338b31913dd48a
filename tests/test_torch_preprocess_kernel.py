"""Preprocess's two kernels against their plain version on a CUDA card
(skipped without).

Run on a machine with a card: ``python -m pytest --noconftest
tests/test_torch_preprocess_kernel.py``. chip_smoke.py makes the same
checks, timed, at the benchmark's two sizes.

The forward kernel (``ops.preprocess.preprocess_forward``) equals
``preprocess_torch`` on the card bit for bit, every output: it rounds as
PyTorch's element-wise kernels, cuBLAS's depth-4 products and torch.sum's
small reductions do there (csrc/preprocess.cuh). The backward kernel
(``preprocess_backward``) sums in an order of its own: its gradients are
held to autograd's through the plain version at the bars of
tests/torch_preprocess_cases.py (1e-6 per leaf by the relative norm of the
difference, 1e-3 of the leaf's largest gradient per element).
tests/torch_preprocess_mirror.py, the copy of the kernels' arithmetic that
the CPU tests hold to autograd, is held here to the kernels themselves.
"""

import json
from pathlib import Path

import pytest
import torch

import torch_preprocess_cases as cases
import torch_preprocess_mirror as mirror
from gsbench import camera as gcam
from gsbench import scene as gscene
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import preprocess as prep_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step

CONFIGS = Path(__file__).resolve().parents[1] / "gsbench" / "configs"
SEED = 4195000001
W, H, M = 160, 112, 1 << 15
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(params, n_alive):
    n = params.xyz.shape[0]
    return gmod.GaussianState(params, n_alive, *[
        torch.zeros(n, device=params.xyz.device) for _ in gmod.STAT_FIELDS])


@pytest.mark.parametrize("name", ["garden_4m", "garden_init_262k"])
def test_kernels_match_plain_on_the_benchmark_scenes(cuda, name):
    """The benchmark's two configurations at the pan's five poses: every
    forward output bit for bit, the gradients within the bars."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    params = gmod.GaussianParams(**gscene.make_params(cfg, SEED, cuda))
    alive = torch.ones(cfg["n_gaussians"], dtype=torch.bool, device=cuda)
    cams = gcam.stack([gcam.pan_pose(k) for k in range(gcam.N_POSES)], cuda)
    grid = ((cfg["width"] + 15) // 16, (cfg["height"] + 15) // 16)
    for k in range(gcam.N_POSES):
        rec = cases.check_kernels(params, alive, gcam.pick(cams, k),
                                  deg=cfg["sh_degree"], width=cfg["width"],
                                  height=cfg["height"], grid=grid)
        assert rec["visible"] > 0


@pytest.mark.parametrize("deg,rest", [(0, 15), (1, 15), (2, 15), (3, 15),
                                      (4, 24)])
def test_kernels_at_every_degree_bucketed_scaled_with_dead_rows(cuda, deg,
                                                                rest):
    """SH degrees 0-4 on anisotropic, rotated Gaussians with 500 dead rows:
    the exact size, then a bucketed step's (the true size as 0-d int32
    tensors under the bucket's grid) with a scale_modifier of 1.7 as a 0-d
    tensor."""
    params = cases.small_params(cuda, rest=rest, seed=deg)
    alive = torch.arange(params.xyz.shape[0], device=cuda) < 19500
    cam = cases.camera(cuda, W, H, yaw=0.04)
    grid = (W // 16, H // 16)
    cases.check_kernels(params, alive, cam, deg=deg, width=W, height=H,
                        grid=grid)
    w, h = (torch.full((), v, dtype=torch.int32, device=cuda)
            for v in (W - 9, H - 5))
    cases.check_kernels(params, alive, cam, deg=deg, width=w, height=h,
                        grid=grid,
                        scale_modifier=torch.full((), 1.7, device=cuda))


def test_culled_rows_take_zero_gradients_and_no_nan(cuda):
    """Rows behind the near plane, with a zero determinant and with
    opacity under 1/255: the forward culls them as the plain version does
    (bit for bit), and with their zero cotangents the backward gives them
    zero gradients and no NaN."""
    params = cases.small_params(cuda, special=True)
    alive = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=cuda)
    rec = cases.check_kernels(params, alive, cases.camera(cuda, W, H),
                              deg=3, width=W, height=H,
                              grid=(W // 16, H // 16), low_pass=0.0)
    plain = rec["plain"]
    assert not bool((plain.tiles_touched[:600] > 0).any())
    assert not bool(plain.conic[200:400].any())          # det_inv = 0
    for name, g in zip(gmod.GaussianParams._fields, rec["grads"]):
        assert not bool(g[:600].any()), name


def test_kernels_without_tight_opacity_culling(cuda):
    """tight_opacity_culling off (no path of the port turns it off; the
    kernels take it as a launch flag, as projection.preprocess does): the
    rows of opacity under 1/255 keep their tiles and every rect its full
    3-sigma size, as in the plain version, bit for bit, with the gradients
    within the bars on those rows too."""
    params = cases.small_params(cuda, special=True)
    alive = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=cuda)
    kw = dict(deg=3, width=W, height=H, grid=(W // 16, H // 16))
    cam = cases.camera(cuda, W, H)
    loose = cases.check_kernels(params, alive, cam, tight=False, **kw)
    tight = cases.check_kernels(params, alive, cam, **kw)
    faint = slice(400, 600)
    assert bool((loose["plain"].tiles_touched[faint] > 0).any())
    assert not bool((tight["plain"].tiles_touched[faint] > 0).any())
    assert bool((loose["plain"].rect_wh >= tight["plain"].rect_wh).all())
    assert bool(loose["grads"].opacity[faint].any())


@pytest.mark.parametrize("deg,rest,tight", [(0, 15, True), (3, 15, True),
                                            (4, 24, True), (3, 15, False)])
def test_the_mirror_is_the_kernels_arithmetic(cuda, deg, rest, tight):
    """tests/torch_preprocess_mirror.py against the kernels, on the same
    float32 leaves with 500 dead rows and the culled rows of
    ``small_params``. The mirror runs in float64, so what parts the two is
    the kernels' float32 rounding alone. Forward: the integer outputs
    equal on all but 1 row in 2,000 (a rect edge or a radius can flip
    where the float32 and the float64 value straddle a whole number), the
    float outputs of the visible rows within a relative norm gap of
    GRAD_GAP per output.
    Backward: each leaf within GRAD_GAP of the mirror's, zero on the culled
    rows. A change to one of the two that the other does not follow fails
    here."""
    params = cases.small_params(cuda, rest=rest, seed=10 + deg, special=True)
    n = params.xyz.shape[0]
    alive = torch.arange(n, device=cuda) < n - 500
    cam = cases.camera(cuda, W, H, yaw=0.02)
    grid = (W // 16, H // 16)
    vals = prep_ops.call_values(cam, W, H, 0.3, 1.0, cuda)
    got = prep_ops.preprocess_forward(params, alive, vals, sh_degree=deg,
                                      grid=grid, tight_opacity_culling=tight)
    p64 = gmod.GaussianParams(*[t.double() for t in params])
    want = mirror.forward(p64, alive, cam, W, H, 0.3, 1.0, deg, grid,
                          tight=tight)
    for f in ("radii", "rect_min", "rect_wh", "tiles_touched"):
        a, b = getattr(got, f), want[f]
        flips = int((a != b).view(n, -1).any(1).sum())
        assert flips <= n // 2000, (f, flips)
    vis = got.tiles_touched > 0
    assert int(vis.sum()) > n // 4
    for f in cases.OUTS:
        a, b = getattr(got, f)[vis].double(), want[f][vis]
        assert float((a - b).norm()) <= cases.GRAD_GAP * float(b.norm()), f
    cots = cases.cotangents(got)
    grads = prep_ops.preprocess_backward(
        params, vals, sh_degree=deg, d_xy=cots[0], d_depth=cots[1],
        d_conic=cots[2], d_rgb=cots[3], d_opacity=cots[4])
    ref = mirror.backward(p64, cam, W, H, 0.3, 1.0, deg,
                          *[c.double() for c in cots])
    for name, a, b in zip(gmod.GaussianParams._fields, grads, ref):
        assert bool(torch.isfinite(a).all()), name
        assert not bool(a[~vis].any()), name
        a = a.double()
        gap = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert gap <= cases.GRAD_GAP, (name, gap)


def test_steps_through_the_kernels_match_the_plain_route(cuda):
    """eval_render and train_step on the card (render_params: the kernels)
    against render.render from gaussians.activate (the plain ops): every
    render output and the loss bit for bit, each leaf's gradient within
    1e-6."""
    params = cases.small_params(cuda, n=3000)
    st = _state(params, 2900)
    cam = cases.camera(cuda, W, H, yaw=-0.03)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    gt = torch.rand((3, H, W), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    scales, quats, opac, shs = gmod.activate(params)
    want = render_ops.render(params.xyz, scales, quats, opac, shs,
                             gmod.alive_mask(st), camera=cam, width=W,
                             height=H, sh_degree=3, bg=bg, max_instances=M)
    got = step.eval_render(st, cam, bg, 0.3, width=W, height=H, sh_degree=3,
                           max_instances=M)
    for a, b in zip(got, want):
        assert cases.same_bits(a, b)

    seen = {}
    _, _, aux = step.train_step(
        st, adam_mod.init(params), cam, gt, bg, 0.3, 1.6e-4, width=W,
        height=H, sh_degree=3, max_instances=M, opt_cfg_leaves=OPT,
        on_stage=seen.__setitem__)
    grads, _ = seen["grads"]
    leaves = gmod.GaussianParams(*[p.detach().requires_grad_(True)
                                   for p in params])
    scales, quats, opac, shs = gmod.activate(leaves)
    out = render_ops.render(leaves.xyz, scales, quats, opac, shs,
                            gmod.alive_mask(st), camera=cam, width=W,
                            height=H, sh_degree=3, bg=bg, max_instances=M,
                            need_depth=False,
                            xy_tap=torch.zeros((3000, 2), device=cuda))
    loss, _ = loss_ops.training_loss(out.render, gt, 0.2)
    assert cases.same_bits(aux.loss, loss.detach())
    ref = torch.autograd.grad(loss, list(leaves))
    for name, a, b in zip(gmod.GaussianParams._fields, grads, ref):
        gap = float((a - b).norm()) / float(b.norm())
        assert gap <= cases.GRAD_GAP, (name, gap)


def test_compiled_step_launches_each_kernel_once_per_replay(cuda):
    """A CompiledStep's captured train_step launches the forward and the
    backward kernel once per call (the warm-up, then each replay), its
    captured eval_render the forward alone; each replay equals the eager
    step bit for bit."""
    params = cases.small_params(cuda, n=3000)
    st = _state(params, 2900)
    opt = adam_mod.init(params)
    cam = cases.camera(cuda, W, H)
    bg = torch.zeros(3, device=cuda)
    gt = torch.rand((3, H, W), generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda)
    steps = compiled.CompiledStep()
    fwd, bwd = prep_ops.preprocess_forward, prep_ops.preprocess_backward
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M,
              opt_cfg_leaves=OPT)
    for _ in range(3):
        want = step.train_step(st, opt, cam, gt, bg, 0.3, 1.6e-4, **kw)
        n0 = (fwd.launches, bwd.launches)
        got = steps.train_step(st, opt, cam, gt, bg, 0.3, 1.6e-4, **kw)
        assert (fwd.launches - n0[0], bwd.launches - n0[1]) == (1, 1)
        for a, b in zip(got[0].params, want[0].params):
            assert cases.same_bits(a, b)
    ekw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    for _ in range(3):
        n0 = (fwd.launches, bwd.launches)
        out = steps.eval_render(st, cam, bg, 0.3, **ekw)
        assert (fwd.launches - n0[0], bwd.launches - n0[1]) == (1, 0)
        assert cases.same_bits(out.render, step.eval_render(
            st, cam, bg, 0.3, **ekw).render)
    assert len(steps.graphs) == 2
