"""The focal length's rounding (C.1) and features_rest's learning rate, the
port against rain_tpu's jitted expressions on the CPU, bit for bit.

rain_tpu computes ``width / (2.0 * tan_fovx)`` under ``jax.jit``
(rain_tpu/ops/projection.py:191-192): one f32 division. torch takes a
Python number over a tensor as the number times the tensor's reciprocal,
two roundings, which part from the division in about a quarter of the
cameras; ``projection.focal_lengths`` divides a 0-d f32 tensor of the size
instead, for an int size and for a bucketed step's 0-d int32 size alike.

XLA compiles rain_tpu's ``feature_lr / 20.0`` (rain_tpu/train/step.py:89)
into a product with the constant's f32 reciprocal, which is what CUDA
makes of a tensor over a number, where the CPU divides:
``step.learning_rates`` multiplies, so both devices give rain_tpu's bits.

Cases: 20,000 seeded tan(fov/2) at widths 1297, 96 and 840
(tests/torch_focal_cases.py, which chip_smoke.py holds the card to), and a
camera at which both focal lengths of the two forms part, where
rain_tpu's jitted preprocess and the port's agree on every radius, rect
and tile count. No Pallas kernel is compiled.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import projection as jproj
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.train import step as tstep
from tests.conftest import make_camera, make_scene
import torch_focal_cases as cases

torch.set_num_threads(1)

W, H = 48, 80     # neither a power of two: both focal lengths can part
LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
          "rotation_lr": 0.001}


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _rain_tpu_focal(size, tan, traced: bool) -> np.ndarray:
    """rain_tpu/ops/projection.py:191's ``width / (2.0 * tan_fovx)`` under
    jax.jit, the size static (an int) or traced (a 0-d int32)."""
    if traced:
        return np.asarray(jax.jit(lambda w, t: w / (2.0 * t))(
            jnp.int32(size), jnp.asarray(tan)))
    return np.asarray(jax.jit(lambda t: size / (2.0 * t))(jnp.asarray(tan)))


@pytest.mark.parametrize("traced", [False, True], ids=["int", "int32"])
@pytest.mark.parametrize("width", cases.WIDTHS)
def test_focal_lengths_equal_rain_tpu_jitted(width, traced):
    tan = cases.tans()
    t = torch.from_numpy(tan)
    size = torch.tensor(width, dtype=torch.int32) if traced else width
    fx, fy = tproj.focal_lengths(t, 2.0 * t, size, size)
    assert fx.dtype == torch.float32 and fx.shape == (cases.N_TAN,)
    want = _rain_tpu_focal(width, tan, traced)
    assert np.array_equal(_bits(fx.numpy()), _bits(want))
    assert np.array_equal(_bits(fy.numpy()),
                          _bits(_rain_tpu_focal(width, 2.0 * tan, traced)))
    # the reciprocal form parts from rain_tpu's in about a quarter of them
    parted = (cases.reciprocal_form(t, width).numpy() != want).mean()
    assert 0.2 < parted < 0.4, parted


def test_preprocess_at_a_parting_camera_matches_rain_tpu():
    """A camera at which both focal lengths of the reciprocal form part
    from the division's: the port's focal lengths are rain_tpu's jitted
    ones bit for bit, and its preprocess against rain_tpu's jitted one
    gives the same radii, rects and tile counts, the float outputs within
    tests/test_torch_projection.py's tolerances."""
    fovx, fovy = cases.parting_fovs(W, H)
    jcam = make_camera(W, H, fovx, fovy)
    tcam = Camera(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3),
                  fovx=fovx, fovy=fovy, image=None, width=W,
                  height=H).render_inputs(device="cpu")
    fx, fy = tproj.focal_lengths(tcam["tanfovx"], tcam["tanfovy"], W, H)
    for got, size, tan in ((fx, W, tcam["tanfovx"]), (fy, H,
                                                      tcam["tanfovy"])):
        want = _rain_tpu_focal(size, tan.numpy(), traced=False)
        assert _bits(got.numpy()) == _bits(want)
        assert not torch.equal(got, cases.reciprocal_form(tan, size))

    scene = make_scene(n=300, seed=5)
    scene["alive"] = scene["alive"].at[::13].set(False)
    keys = ("means", "scales", "quats", "opac", "shs", "alive")

    @jax.jit
    def rain_tpu_preprocess(means, scales, quats, opac, shs, alive):
        return jproj.preprocess(
            means, scales, quats, opac, shs, alive, sh_degree=3,
            world_view=jcam["world_view"], full_proj=jcam["full_proj"],
            camera_center=jcam["camera_center"], tan_fovx=jcam["tanfovx"],
            tan_fovy=jcam["tanfovy"], width=W, height=H, low_pass=0.3)

    ref = rain_tpu_preprocess(*[scene[k] for k in keys])
    out = tproj.preprocess(
        *[torch.from_numpy(np.array(scene[k])) for k in keys], sh_degree=3,
        world_view=tcam["world_view"], full_proj=tcam["full_proj"],
        camera_center=tcam["camera_center"], tan_fovx=tcam["tanfovx"],
        tan_fovy=tcam["tanfovy"], width=W, height=H, low_pass=0.3)
    for name in ("xy", "depth", "conic", "rgb", "opacity"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("radii", "rect_min", "rect_wh", "tiles_touched"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(out.tiles_touched.gt(0).sum()) > 100


@pytest.mark.parametrize("feature_lr", [0.0025, 0.005, 0.05])
def test_features_rest_lr_equals_rain_tpu_jitted(feature_lr):
    """features_rest's learning rate, for a number and a 0-d f32 tensor,
    against rain_tpu's jitted ``feature_lr / 20.0``; at 0.0025 (the
    default) and 0.005 the CPU's division rounds otherwise."""
    want = np.asarray(jax.jit(lambda x: x / 20.0)(jnp.float32(feature_lr)))
    for given in (feature_lr, torch.tensor(feature_lr)):
        lrs = tstep.learning_rates(dict(LEAVES, feature_lr=given), 1e-4,
                                   torch.device("cpu"))
        assert _bits(lrs.features_rest.numpy()) == _bits(want), given
        assert _bits(lrs.features_dc.numpy()) == _bits(feature_lr)
