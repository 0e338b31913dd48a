"""Port parity: the forward tile compositor.

rain_tpu_torch's plain compositor (the plain version of kernel B3) against
rain_tpu's Pallas compositor (interpret mode) on the same JAX-built pack,
at rain_tpu's own oracle tolerances (tests/test_rasterize.py:44-61): the
TPU kernel evaluates the Gaussian power as a tile-local quadratic-basis
matmul and the port in the direct form, so floats agree to f32 rounding
and n_contrib exactly. The port's compositor is also held to the port's
sequential oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.ops import binning as jbin
from rain_tpu.ops import projection as jproj
from rain_tpu.ops import tile_render as jtr
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.ops import render as trender
from rain_tpu_torch.ops import tile_render as ttr
from rain_tpu_torch.ops.reference_composite import composite_reference
from tests.conftest import make_camera, make_scene

torch.set_num_threads(1)

W, H = 48, 64
GRID_X, GRID_Y = (W + 15) // 16, (H + 15) // 16
N_TILES = GRID_X * GRID_Y
M = 2048
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_pack(scene):
    cam = make_camera(W, H)
    prep = jproj.preprocess(
        scene["means"], scene["scales"], scene["quats"], scene["opac"],
        scene["shs"], scene["alive"], sh_degree=3,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        camera_center=cam["camera_center"], tan_fovx=cam["tanfovx"],
        tan_fovy=cam["tanfovy"], width=W, height=H, low_pass=0.3)
    table10 = jnp.stack([
        prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
        prep.xy[:, 0], prep.xy[:, 1], prep.opacity,
        prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2],
        prep.depth], axis=0)
    pack, total, ovf = jbin.sorted_pack(
        table10, prep.tiles_touched, prep.rect_min, prep.rect_wh,
        jnp.asarray(0, jnp.int32), GRID_X, N_TILES, M)
    assert not bool(ovf)
    start, end = jbin.tile_ranges(prep.rect_min, prep.rect_wh,
                                  prep.tiles_touched > 0, GRID_X, N_TILES,
                                  0, M)
    return pack, start, end


def _assert_tiles_close(got, want):
    for ch in (ttr.CH_R, ttr.CH_G, ttr.CH_B, ttr.CH_ALPHA, ttr.CH_T):
        np.testing.assert_allclose(got[..., ch], want[..., ch], rtol=1e-4,
                                   atol=3e-5, err_msg=f"channel {ch}")
    np.testing.assert_allclose(got[..., ttr.CH_DEPTH], want[..., ttr.CH_DEPTH],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[..., ttr.CH_NCONTRIB],
                                  want[..., ttr.CH_NCONTRIB])
    assert np.all(got[..., ttr.CH_PAD] == 0.0)


@pytest.mark.parametrize("seed,opac_bias", [(0, 0.0), (7, 3.0)])
def test_composite_forward_torch_matches_jax(seed, opac_bias):
    # opac_bias=3 → near-opaque Gaussians → exercises early termination
    scene = make_scene(n=300, seed=seed, opac_bias=opac_bias)
    pack, start, end = _jax_pack(scene)
    want = np.asarray(jtr.composite(pack, start, end,
                                    jnp.zeros((1,), jnp.int32), GRID_X))
    got = ttr.composite_forward_torch(_t(pack), _t(start), _t(end), 0, GRID_X)
    assert got.shape == (N_TILES, ttr.P, 8)
    _assert_tiles_close(got.numpy(), want)
    # the CPU wrapper takes the plain path
    np.testing.assert_array_equal(
        ttr.composite_forward(_t(pack), _t(start), _t(end), 0,
                              GRID_X).numpy(), got.numpy())
    if opac_bias:
        assert got[..., ttr.CH_T].min() < 1e-2     # some pixels terminated


@pytest.mark.parametrize("seed,opac_bias", [(0, 0.0), (7, 3.0)])
def test_composite_forward_matches_port_oracle(seed, opac_bias):
    scene = {k: _t(v) for k, v in
             make_scene(n=300, seed=seed, opac_bias=opac_bias).items()}
    cam = Camera(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.6, image=None, width=W,
                 height=H).render_inputs(device="cpu")
    bg = _t(BG)
    kw = dict(camera=cam, width=W, height=H, sh_degree=3, bg=bg,
              low_pass=0.3)
    out = trender.render(scene["means"], scene["scales"], scene["quats"],
                         scene["opac"], scene["shs"], scene["alive"],
                         max_instances=M, **kw)
    prep = tproj.preprocess(
        scene["means"], scene["scales"], scene["quats"], scene["opac"],
        scene["shs"], scene["alive"], sh_degree=3,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        camera_center=cam["camera_center"], tan_fovx=cam["tanfovx"],
        tan_fovy=cam["tanfovy"], width=W, height=H, low_pass=0.3)
    ref = composite_reference(prep, W, H, bg)
    np.testing.assert_allclose(out.render.numpy(), ref["render"].numpy(),
                               rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(out.final_t.numpy(), ref["final_T"].numpy(),
                               rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(out.depth.numpy(), ref["depth"].numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(out.n_contrib.numpy(),
                                  ref["n_contrib"].numpy())


def test_composite_work_counts():
    scene = make_scene(n=300, seed=7, opac_bias=3.0)
    pack, start, end = (_t(x) for x in _jax_pack(scene))
    n_eval, n_comp = ttr.composite_work(pack, start, end, 0, GRID_X)
    lengths = (end - start).to(torch.int64)
    # early termination evaluates fewer pairs than the ranges hold
    assert 0 < n_comp < n_eval < int(lengths.sum()) * ttr.P
    tiles = ttr.composite_forward_torch(pack, start, end, 0, GRID_X)
    assert n_comp >= int(tiles[..., ttr.CH_NCONTRIB].gt(0).sum())


def test_pack_rows_matches_jax():
    rng = np.random.default_rng(5)
    xy, conic, color = (rng.normal(size=(40, k)).astype(np.float32)
                        for k in (2, 3, 3))
    opacity, depth = (rng.uniform(size=(40,)).astype(np.float32)
                      for _ in range(2))
    want = np.asarray(jtr.pack_rows(xy, conic, opacity, color, depth))
    got = ttr.pack_rows(_t(xy), _t(conic), _t(opacity), _t(color), _t(depth))
    assert got.shape == (ttr.KERNEL_ROWS, 40)
    np.testing.assert_array_equal(got.numpy(), want[:ttr.KERNEL_ROWS])
    assert np.all(want[ttr.KERNEL_ROWS:] == 0.0)
