"""Port parity: rain_tpu_torch preprocess and SH against rain_tpu.

The same seeded numpy scene goes through the JAX package and the PyTorch
port on the CPU. Float fields agree to f32 rounding (the two frameworks
order a few products differently); the integer tile rects, radii and tile
counts are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.ops import projection as jproj
from rain_tpu.ops import sh as jsh
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.ops import sh as tsh
from tests.conftest import make_camera, make_scene

torch.set_num_threads(1)

W, H = 48, 64


def _torch_camera(width, height):
    return Camera(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3),
                  fovx=0.8, fovy=0.6, image=None, width=width,
                  height=height).render_inputs(device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("low_pass", [0.3, 30.0])
def test_preprocess_matches_jax(seed, low_pass):
    scene = make_scene(n=300, seed=seed, opac_bias=3.0 if seed == 7 else 0.0)
    scene["alive"] = scene["alive"].at[::11].set(False)
    jcam = make_camera(W, H)
    tcam = _torch_camera(W, H)
    ref = jproj.preprocess(
        scene["means"], scene["scales"], scene["quats"], scene["opac"],
        scene["shs"], scene["alive"], sh_degree=3,
        world_view=jcam["world_view"], full_proj=jcam["full_proj"],
        camera_center=jcam["camera_center"], tan_fovx=jcam["tanfovx"],
        tan_fovy=jcam["tanfovy"], width=W, height=H, low_pass=low_pass)
    out = tproj.preprocess(
        _t(scene["means"]), _t(scene["scales"]), _t(scene["quats"]),
        _t(scene["opac"]), _t(scene["shs"]), _t(scene["alive"]),
        sh_degree=3, world_view=tcam["world_view"],
        full_proj=tcam["full_proj"], camera_center=tcam["camera_center"],
        tan_fovx=tcam["tanfovx"], tan_fovy=tcam["tanfovy"], width=W,
        height=H, low_pass=low_pass)
    for name in ("xy", "depth", "conic", "rgb", "opacity"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("radii", "rect_min", "rect_wh", "tiles_touched"):
        got = getattr(out, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(out.tiles_touched.gt(0).sum()) > 100


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 200
    sh = rng.normal(0, 0.4, (n, 16, 3)).astype(np.float32)
    means = rng.normal(0, 2, (n, 3)).astype(np.float32)
    means[0] = 0.5                       # exactly at the camera centre
    campos = np.full(3, 0.5, np.float32)
    ref = jsh.sh_to_rgb(degree, jnp.asarray(sh), jnp.asarray(means),
                        jnp.asarray(campos))
    out = tsh.sh_to_rgb(degree, _t(sh), _t(means), _t(campos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert np.all(out.numpy() >= 0.0)
