"""Where the port's render gradients and rain_tpu's part, which is nearer
the exact value.

On tests/test_expand.py:175's scene (700 Gaussians, seed 9, loss weights
sin of the pixel index) the port's f32 gradients and rain_tpu's differ by
more than the oracle bar (1e-4 of the largest) in the quaternions. An f64
evaluation of the same render (the port's main path with the plain
versions of kernels B1-B4, whose sums keep their input's dtype) settles
it: the port's f32 gradients lie within the bar of it, rain_tpu's further
away. One JAX compilation.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rain_tpu.data.cameras import Camera as JCamera
from rain_tpu.ops import render as jrender
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import render as trender
import torch_gt_images as gt_images

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


def _torch_run(arrays, alive, wts):
    """The port's render of the scene, and the gradients of sum(render·w)
    in every input."""
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = trender.render(
        *xs[:5], torch.from_numpy(alive),
        camera=Camera(**_cam_kw()).render_inputs("cpu"), width=W, height=H,
        sh_degree=2, bg=torch.from_numpy(BG), low_pass=0.3, max_instances=M,
        xy_tap=xs[5])
    (out.render * torch.from_numpy(wts)).sum().backward()
    return out, [x.grad for x in xs]


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


def _f64_grads(arrays, alive, wts):
    xs = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
          for a in arrays]
    cam = {k: v.double() for k, v in Camera(**_cam_kw())
           .render_inputs("cpu").items()}
    with gt_images.plain_kernels():
        out = trender.render(
            *xs[:5], torch.from_numpy(alive), camera=cam, width=W, height=H,
            sh_degree=2, bg=torch.from_numpy(BG).double(), low_pass=0.3,
            max_instances=M, xy_tap=xs[5])
        assert out.render.dtype == torch.float64
        (out.render * torch.from_numpy(wts).double()).sum().backward()
    return [x.grad.numpy() for x in xs]


def test_port_gradients_are_nearer_f64_than_rain_tpus():
    arrays, alive = _scene(seed=9)
    wts = _weights(np.sin)
    _, want = _jax_run(arrays, alive, wts)
    _, got = _torch_run(arrays, alive, wts)
    exact = _f64_grads(arrays, alive, wts)
    far = []
    for name, g, j, e in zip(NAMES, got, want, exact):
        scale = np.abs(e).max()
        port = np.abs(g.numpy() - e).max() / scale
        ref = np.abs(np.asarray(j) - e).max() / scale
        assert port < 5e-5, name
        far.append((ref, name))
        if np.abs(g.numpy() - np.asarray(j)).max() / scale >= 1e-4:
            assert ref > port, name
    assert max(far)[0] >= 1e-4, far
