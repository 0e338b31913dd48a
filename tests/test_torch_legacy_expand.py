"""Port parity: the legacy expansion and the scatter reduction (A/B paths).

The counterparts of tests/test_expand.py:84 and :175 on the port: the
legacy path (bin_gaussians, the [16, N+1] pack gather and its per-Gaussian
sum) renders the fused path's image, n_contrib and instance count bit for
bit, and with reduce="scatter" the two give the same gradients bit for
bit; the scatter reduction's gradients equal kernel B2's (plain version
here) at 1e-6. Against rain_tpu: its legacy render (RAIN_TPU_EXPAND=legacy)
and its scatter reduction (RAIN_TPU_REDUCE=scatter), images at rtol 1e-4 /
atol 3e-5 and gradients at the oracle bar 1e-4. Two JAX compilations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.data.cameras import Camera as JCamera
from rain_tpu.ops import binning as jbin
from rain_tpu.ops import render as jrender
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import binning as tbin
from rain_tpu_torch.ops import render as trender

torch.set_num_threads(1)

W, H, M = 160, 112, 2048
BG = np.array([0.1, 0.2, 0.3], np.float32)
NAMES = ("xyz", "scales", "quats", "opac", "shs", "tap")


def _scene(n=700, seed=0):
    """tests/test_expand.py's scene: post-activation arrays and the view."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(1.5, 9.0, (n, 1))], 1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.2, -2.4, (n, 3))).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    shs = rng.uniform(-0.4, 0.6, (n, 16, 3)).astype(np.float32)
    alive = np.ones((n,), bool)
    alive[::13] = False
    return [pts, scales, quats, opac, shs, np.zeros((n, 2), np.float32)], \
        alive


def _cam_kw():
    return dict(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3), fovx=1.1,
                fovy=0.8, image=None, width=W, height=H)


def _weights(fn=np.cos):
    """The loss weights of tests/test_expand.py: cos (:84) or sin (:175) of
    the pixel index."""
    return fn(np.arange(3 * H * W, dtype=np.float32)).reshape(3, H, W)


def _torch_run(arrays, alive, wts, **paths):
    """The port's render of the scene, and the gradients of sum(render·w)
    in every input."""
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    seen = []
    out = trender.render(
        *xs[:5], torch.from_numpy(alive),
        camera=Camera(**_cam_kw()).render_inputs("cpu"), width=W, height=H,
        sh_degree=2, bg=torch.from_numpy(BG), low_pass=0.3, max_instances=M,
        xy_tap=xs[5], on_stage=lambda *kv: seen.append(kv), **paths)
    (out.render * torch.from_numpy(wts)).sum().backward()
    return out, [x.grad for x in xs], [k for k, _ in seen]


def _jax_run(arrays, alive, wts):
    camera = {k: jnp.asarray(v)
              for k, v in JCamera(**_cam_kw()).render_inputs().items()}

    def loss(*a):
        out = jrender.render(
            *a[:5], jnp.asarray(alive), camera=camera, width=W, height=H,
            sh_degree=2, bg=jnp.asarray(BG), low_pass=0.3, max_instances=M,
            xy_tap=a[5])
        return jnp.sum(out.render * wts), out

    return jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in arrays])


def _assert_grads_close(got, want, bar):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g.numpy()).all(), name
        scale = np.abs(w).max()
        assert scale > 0.0, name
        assert np.abs(g.numpy() - w).max() / scale < bar, name


def test_fused_render_and_grads_match_legacy():
    """The counterpart of tests/test_expand.py:84: with the scatter
    reduction, the fused and the legacy path agree bit for bit in image,
    n_contrib, instance count and every gradient."""
    arrays, alive = _scene(seed=3)
    wts = _weights()
    legacy, g_legacy, stages = _torch_run(arrays, alive, wts,
                                          expand="legacy")
    fused, g_fused, _ = _torch_run(arrays, alive, wts, reduce="scatter")
    assert stages == list(trender.LEGACY_STAGES) + ["loss_bwd",
                                                    "composite_bwd_B4"]
    assert int(legacy.num_instances) == int(fused.num_instances) > 700
    for f in ("render", "depth", "alpha", "final_t", "n_contrib"):
        assert torch.equal(getattr(legacy, f), getattr(fused, f)), f
    for name, a, b in zip(NAMES, g_legacy, g_fused):
        assert torch.equal(a, b), name


def test_kernel_reduce_grads_match_scatter():
    """The counterpart of tests/test_expand.py:175: the scatter reduction
    and kernel B2 (its plain version on the CPU) give the same gradients,
    at 1e-6 of each input's largest."""
    arrays, alive = _scene(seed=9)
    wts = _weights(np.sin)
    out_k, g_kernel, stages = _torch_run(arrays, alive, wts)
    out_s, g_scatter, _ = _torch_run(arrays, alive, wts, reduce="scatter")
    assert "reduce_B2" in stages
    assert torch.equal(out_k.render, out_s.render)
    _assert_grads_close(g_kernel, [g.numpy() for g in g_scatter], 1e-6)


def test_legacy_path_matches_rain_tpu(monkeypatch):
    """The port's legacy render and gradients against rain_tpu's legacy
    path (bin_gaussians, the pack gather, its scatter-add transpose)."""
    monkeypatch.setattr(jrender, "EXPAND_IMPL", "legacy")
    arrays, alive = _scene(seed=3)
    wts = _weights()
    (_, jout), want = _jax_run(arrays, alive, wts)
    out, got, _ = _torch_run(arrays, alive, wts, expand="legacy")
    np.testing.assert_allclose(out.render.detach().numpy(),
                               np.asarray(jout.render), rtol=1e-4, atol=3e-5)
    np.testing.assert_array_equal(out.n_contrib.numpy(),
                                  np.asarray(jout.n_contrib))
    assert int(out.num_instances) == int(jout.num_instances)
    _assert_grads_close(got, want, 1e-4)


def test_scatter_reduction_matches_rain_tpu(monkeypatch):
    """The port's fused path with reduce="scatter" against rain_tpu's
    RAIN_TPU_REDUCE=scatter gradients, on the scene of the legacy test
    (on test_expand.py:175's seed-9 scene rain_tpu's own f32 gradients
    lie 1.2e-4 from an f64 evaluation: tests/test_torch_grad_f64.py)."""
    monkeypatch.setattr(jbin, "REDUCE_IMPL", "scatter")
    arrays, alive = _scene(seed=3)
    wts = _weights(np.sin)
    (_, jout), want = _jax_run(arrays, alive, wts)
    out, got, stages = _torch_run(arrays, alive, wts, reduce="scatter")
    assert "reduce_B2" not in stages
    np.testing.assert_allclose(out.render.detach().numpy(),
                               np.asarray(jout.render), rtol=1e-4, atol=3e-5)
    _assert_grads_close(got, want, 1e-4)


def test_owner_sum_adds_in_column_order():
    """owner_sum equals a loop adding each column to its owner from 0.0 in
    column order, bit for bit, and drops owners outside [0, n)."""
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(3, 500)).astype(np.float32) * \
        np.exp(rng.uniform(-8, 8, 500)).astype(np.float32)
    owner = rng.integers(0, 45, 500)           # 40..44 are dropped
    want = np.zeros((3, 40), np.float32)
    for j in range(500):
        if owner[j] < 40:
            want[:, owner[j]] = want[:, owner[j]] + vals[:, j]
    got = tbin.owner_sum(torch.from_numpy(vals), torch.from_numpy(owner), 40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_take_backward_is_the_gather_transpose():
    """pack_take's backward: each instance's cotangent summed to its
    Gaussian's column, a zero dump column."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(16, 31)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 31, 200))
    g = torch.from_numpy(rng.normal(size=(16, 200)).astype(np.float32))
    table.requires_grad_(True)
    pack = trender.pack_take(table, idx)
    assert torch.equal(pack, table.detach()[:, idx])
    pack.backward(g)
    want = np.zeros((16, 31), np.float32)
    for j, i in enumerate(idx.tolist()):
        if i < 30:
            want[:, i] += g[:, j].numpy()
    np.testing.assert_array_equal(table.grad.numpy(), want)


@pytest.mark.parametrize("kw", [{"expand": "mxu"}, {"reduce": "mxu"}])
def test_unknown_path_raises(kw):
    arrays, alive = _scene(n=50)
    with pytest.raises(ValueError, match=f"{next(iter(kw))}="):
        _torch_run(arrays, alive, _weights(), **kw)
