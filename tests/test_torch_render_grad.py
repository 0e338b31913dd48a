"""Port parity: gradients of preprocess and of the whole render.

The port's autograd through ops.projection.preprocess, and through
ops.render.render (preprocess, the sorted pack's VJP with kernel B2's
plain version, the compositor's backward with kernel B4's plain version),
against ``jax.grad`` of rain_tpu's, on the same seeded scene, at
rain_tpu's oracle-gradient bar (tests/test_rasterize.py:100): max-abs
error / max-abs value < 1e-4 per input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import projection as jproj
from rain_tpu.ops import render as jrender
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import expand as texp
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.ops import render as trender
from rain_tpu_torch.ops import tile_render as ttr
from tests.conftest import make_camera, make_scene

torch.set_num_threads(1)

W, H = 48, 64
BG = np.array([0.1, 0.2, 0.3], np.float32)
NAMES = ("means", "scales", "quats", "opac", "shs")


def _t(x):
    return torch.from_numpy(np.array(x))


def _tcam():
    return Camera(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3),
                  fovx=0.8, fovy=0.6, image=None, width=W,
                  height=H).render_inputs(device="cpu")


def _assert_grads_close(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        assert np.isfinite(g.numpy()).all(), name
        scale = np.abs(w).max()
        assert scale > 0.0, name
        assert np.abs(g.numpy() - w).max() / scale < 1e-4, name


def _prep_kw(cam, low_pass):
    return dict(sh_degree=3, world_view=cam["world_view"],
                full_proj=cam["full_proj"],
                camera_center=cam["camera_center"],
                tan_fovx=cam["tanfovx"], tan_fovy=cam["tanfovy"],
                width=W, height=H, low_pass=low_pass)


def test_preprocess_gradients_match_jax():
    # Gaussians beyond the 1.3·tan(fov) clamp, and 2/3 of them below the
    # 1/255 opacity that the tight culling drops
    scene = make_scene(n=200, seed=4, opac_bias=-6.5)
    rng = np.random.default_rng(4)
    means = np.asarray(scene["means"]).copy()
    means[:40, 0] *= 8.0
    scene["means"] = jnp.asarray(means)
    opac = np.asarray(scene["opac"])
    assert (opac < 1 / 255).sum() >= 120
    outs = ("xy", "depth", "conic", "rgb", "opacity")
    wts = {k: rng.normal(size=s).astype(np.float32) for k, s in
           (("xy", (200, 2)), ("depth", (200,)), ("conic", (200, 3)),
            ("rgb", (200, 3)), ("opacity", (200,)))}
    args = [scene[k] for k in NAMES]

    def jloss(*a):
        p = jproj.preprocess(*a, scene["alive"],
                             **_prep_kw(make_camera(W, H), 0.3))
        return sum(jnp.sum(getattr(p, k) * wts[k]) for k in outs), p

    (_, jp), want = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(*args)
    xs = [_t(a).requires_grad_(True) for a in args]
    p = tproj.preprocess(*xs, _t(scene["alive"]), **_prep_kw(_tcam(), 0.3))
    sum(torch.sum(getattr(p, k) * _t(wts[k])) for k in outs).backward()
    # the clamp and the culling are reached, and the integers agree
    assert np.asarray(jp.tiles_touched).min() == 0
    np.testing.assert_array_equal(p.tiles_touched.numpy(),
                                  np.asarray(jp.tiles_touched))
    np.testing.assert_array_equal(p.radii.numpy(), np.asarray(jp.radii))
    limx = 1.3 * float(_tcam()["tanfovx"])
    assert (np.abs(means[:, 0] / means[:, 2]) > limx).any()
    _assert_grads_close([x.grad for x in xs], want, NAMES)


def _jax_render_loss(scene, tgt):
    cam = make_camera(W, H)

    def loss(means, scales, quats, opac, shs, tap):
        out = jrender.render(means, scales, quats, opac, shs, scene["alive"],
                             camera=cam, width=W, height=H, sh_degree=3,
                             bg=jnp.asarray(BG), low_pass=0.3,
                             max_instances=2048, xy_tap=tap)
        return jnp.abs(out.render - tgt).mean()
    return loss


def test_render_gradients_match_jax():
    # the counterpart of tests/test_rasterize.py:73-100
    scene = make_scene(n=150, seed=1, opac_bias=0.5)
    tgt = np.random.default_rng(2).uniform(0, 1, (3, H, W)).astype(np.float32)
    args = [scene[k] for k in NAMES] + [jnp.zeros((150, 2), jnp.float32)]
    want = jax.grad(_jax_render_loss(scene, jnp.asarray(tgt)),
                    argnums=tuple(range(6)))(*args)
    xs = [_t(a).requires_grad_(True) for a in args]
    out = trender.render(*xs[:5], _t(scene["alive"]), camera=_tcam(),
                         width=W, height=H, sh_degree=3, bg=_t(BG),
                         low_pass=0.3, max_instances=2048, xy_tap=xs[5])
    torch.abs(out.render - _t(tgt)).mean().backward()
    _assert_grads_close([x.grad for x in xs], want, NAMES + ("tap",))


def test_backward_reports_b4_then_b2_on_their_inputs():
    scene = {k: _t(v) for k, v in make_scene(n=150, seed=5).items()}
    seen = []
    xs = [scene[k].requires_grad_(True) for k in NAMES]
    out = trender.render(*xs, scene["alive"], camera=_tcam(), width=W,
                         height=H, sh_degree=3, bg=_t(BG), low_pass=0.3,
                         max_instances=2048, need_depth=False,
                         on_stage=lambda *kv: seen.append(kv))
    assert tuple(k for k, _ in seen) == trender.STAGES
    out.render.square().sum().backward()
    assert tuple(k for k, _ in seen[len(trender.STAGES):]) == \
        trender.BACKWARD_STAGES
    stages = dict(seen)
    args, d_pack = stages["composite_bwd_B4"]
    assert torch.equal(d_pack, ttr.composite_backward_torch(*args))
    d_rank, exc, tiles, d_depth = stages["reduce_B2"]
    assert torch.equal(d_depth, texp.reduce_instances_torch(d_rank, exc,
                                                            tiles))
    assert torch.all(stages["tile_sort_gather"][ttr.ROW_DEPTH] == 0.0)
    assert all(torch.isfinite(x.grad).all() for x in xs)


@pytest.mark.parametrize("real_wh", [(45, 61), (48, 64)])
def test_bucketed_render_matches_exact_render(real_wh):
    """render_wh: a true size inside the bucket renders as the exact size
    does, in the top-left of the bucket."""
    w, h = real_wh
    scene = {k: _t(v) for k, v in make_scene(n=150, seed=6).items()}
    cam = Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.6, image=None, width=w,
                 height=h).render_inputs(device="cpu")
    kw = dict(camera=cam, sh_degree=3, bg=_t(BG), low_pass=0.3,
              max_instances=2048)
    args = [scene[k] for k in NAMES] + [scene["alive"]]
    exact = trender.render(*args, width=w, height=h, **kw)
    bucket = trender.render(*args, width=W, height=H, render_wh=(w, h), **kw)
    assert bucket.render.shape == (3, H, W)
    torch.testing.assert_close(bucket.render[:, :h, :w], exact.render,
                               rtol=0.0, atol=0.0)
    assert torch.equal(bucket.radii, exact.radii)
    assert int(bucket.num_instances) == int(exact.num_instances)
