"""Port parity: rain_tpu_torch preprocess and SH against rain_tpu.

The same seeded numpy scene goes through the JAX package and the PyTorch
port on the CPU. Float fields agree to f32 rounding (the two frameworks
order a few products differently); the integer tile rects, radii and tile
counts are exact. At bench.py's 1m tier, where rain_tpu compiled (XLA
fuses the pixel transform and rounds a few means one ulp apart) counts
other tiles than the port for a Gaussian, that Gaussian's rect edge lies
on a tile edge within that ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import projection as jproj
from rain_tpu.model import gaussians as jgmod
from rain_tpu.ops import sh as jsh
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.ops import sh as tsh
from rain_tpu_torch.scripts import probe_scale
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


def test_bench_1m_tier_compiled_rects_differ_only_at_tile_edges():
    """bench.py's 1m tier (1,048,576 Gaussians) at its camera and
    1297x840: rain_tpu's compiled preprocess against the port's. Every
    Gaussian that touches another number of tiles has the same radius,
    means one f32 ulp apart on the axis whose rect differs, an integer
    pixel between them, and a rect edge x - r or x + r + 15 (r a whole
    number of pixels up to the radius) on a tile edge there: the rect
    differs by one tile. Such Gaussians are why counts differ across
    backends (port 1,644,591, BENCH_r05.json's TPU run 1,644,592)."""
    n, _, log_scale = probe_scale.TIERS["1m"]
    ts = probe_scale.build_tier_state(n, log_scale, device="cpu")
    w, h = probe_scale.WIDTH, probe_scale.HEIGHT
    grid = ((w + 15) // 16, (h + 15) // 16)
    scales, quats, opac, shs = gmod.activate(ts.state.params)
    cam = ts.camera
    out = tproj.preprocess(
        ts.state.params.xyz, scales, quats, opac, shs[:, :1],
        gmod.alive_mask(ts.state), sh_degree=0,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        camera_center=cam["camera_center"], tan_fovx=cam["tanfovx"],
        tan_fovy=cam["tanfovy"], width=w, height=h, grid=grid,
        low_pass=probe_scale.LOW_PASS)
    js = jgmod.from_arrays(*[p.numpy() for p in ts.state.params],
                           capacity=n)
    jcam = {k: jnp.asarray(v.numpy()) for k, v in cam.items()}

    @jax.jit
    def compiled(params, alive):
        scales, quats, opac, shs = jgmod.activate(params)
        return jproj.preprocess(
            params.xyz, scales, quats, opac, shs[:, :1], alive,
            sh_degree=0, world_view=jcam["world_view"],
            full_proj=jcam["full_proj"],
            camera_center=jcam["camera_center"],
            tan_fovx=jcam["tanfovx"], tan_fovy=jcam["tanfovy"], width=w,
            height=h, tile_bounds=(0, 0) + grid,
            low_pass=probe_scale.LOW_PASS)

    ref = compiled(js.params, jgmod.alive_mask(js))
    tt, tt_ref = out.tiles_touched.numpy(), np.asarray(ref.tiles_touched)
    assert tt.sum() == probe_scale.preprocess_instances(ts)
    x0, x0_ref = out.rect_min.numpy(), np.asarray(ref.rect_min)
    x1 = x0 + out.rect_wh.numpy()
    x1_ref = x0_ref + np.asarray(ref.rect_wh)
    xy, xy_ref = out.xy.numpy(), np.asarray(ref.xy)
    radii, radii_ref = out.radii.numpy(), np.asarray(ref.radii)
    for i in np.flatnonzero(tt != tt_ref):
        assert radii[i] == radii_ref[i] > 0, i
        for a in np.flatnonzero((x0[i] != x0_ref[i]) | (x1[i] != x1_ref[i])):
            lo, hi = sorted((xy[i, a], xy_ref[i, a]))
            assert hi - lo <= np.spacing(np.float32(hi)), (i, a, lo, hi)
            k = np.ceil(lo)                     # the integer pixel
            assert k <= hi, (i, a, lo, hi)
            for e, e_ref, r_of in ((x0, x0_ref, lambda t: k - 16 * t),
                                   (x1, x1_ref, lambda t: 16 * t - 15 - k)):
                if e[i, a] != e_ref[i, a]:
                    assert abs(int(e[i, a]) - int(e_ref[i, a])) == 1
                    r = r_of(max(e[i, a], e_ref[i, a]))
                    assert 1 <= r <= radii[i], (i, a, r, radii[i])


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
