"""Where the port's render gradients and rain_tpu's part, which is nearer
the exact value.

On tests/test_expand.py:175's scene (700 Gaussians, seed 9, loss weights
sin of the pixel index) the port's f32 gradients and rain_tpu's differ by
more than the oracle bar (1e-4 of the largest) in the quaternions. An f64
evaluation of the same render (the port's plain path, the legacy
expansion, whose sums take any dtype) settles it: the port's f32
gradients lie within the bar of it, rain_tpu's further away. The
reductions are not the cause: the port's kernel and scatter reductions
agree bit for bit (tests/test_torch_legacy_expand.py). One JAX
compilation.
"""

import numpy as np
import torch

from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import render as trender
from rain_tpu_torch.ops import tile_render
from tests import test_torch_legacy_expand as legacy

torch.set_num_threads(1)


def _f64_grads(arrays, alive, wts, monkeypatch):
    # the wrappers take f32 only; their plain versions take any dtype
    monkeypatch.setattr(tile_render, "composite_forward",
                        tile_render.composite_forward_torch)
    monkeypatch.setattr(tile_render, "composite_backward",
                        tile_render.composite_backward_torch)
    xs = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
          for a in arrays]
    cam = {k: v.double() for k, v in Camera(**legacy._cam_kw())
           .render_inputs("cpu").items()}
    out = trender.render(
        *xs[:5], torch.from_numpy(alive), camera=cam, width=legacy.W,
        height=legacy.H, sh_degree=2,
        bg=torch.from_numpy(legacy.BG).double(), low_pass=0.3,
        max_instances=legacy.M, xy_tap=xs[5], expand="legacy")
    assert out.render.dtype == torch.float64
    (out.render * torch.from_numpy(wts).double()).sum().backward()
    return [x.grad.numpy() for x in xs]


def test_port_gradients_are_nearer_f64_than_rain_tpus(monkeypatch):
    arrays, alive = legacy._scene(seed=9)
    wts = legacy._weights(np.sin)
    _, want = legacy._jax_run(arrays, alive, wts)
    _, got, _ = legacy._torch_run(arrays, alive, wts)
    exact = _f64_grads(arrays, alive, wts, monkeypatch)
    far = []
    for name, g, j, e in zip(legacy.NAMES, got, want, exact):
        scale = np.abs(e).max()
        port = np.abs(g.numpy() - e).max() / scale
        ref = np.abs(np.asarray(j) - e).max() / scale
        assert port < 5e-5, name
        far.append((ref, name))
        if np.abs(g.numpy() - np.asarray(j)).max() / scale >= 1e-4:
            assert ref > port, name
    assert max(far)[0] >= 1e-4, far
