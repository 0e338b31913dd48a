"""Port parity: instance expansion, sorted pack and tile ranges.

rain_tpu_torch's expansion (the plain version of kernel B1), sorted pack
and tile ranges against rain_tpu's on the same seeded scene. The JAX
expansion kernel runs in Pallas interpret mode, as the JAX package's own
tests run it. The pack is a selection and a permutation of the same f32
values, so it must agree bit for bit, and so must every integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.data.cameras import Camera
from rain_tpu.ops import binning as jbin
from rain_tpu.ops import expand as jexp
from rain_tpu.ops import projection as jproj
from rain_tpu_torch.ops import binning as tbin
from rain_tpu_torch.ops import expand as texp

torch.set_num_threads(1)

W, H = 160, 112
GRID_X, GRID_Y = (W + 15) // 16, (H + 15) // 16
N_TILES = GRID_X * GRID_Y


def _prep(n=700, seed=0):
    """JAX preprocess of a seeded scene (tests/test_expand.py:_scene)."""
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
    cam = Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=1.1, fovy=0.8, image=None, width=W, height=H)
    camera = {k: jnp.asarray(v) for k, v in cam.render_inputs().items()}
    return jproj.preprocess(
        jnp.asarray(pts), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(opac), jnp.asarray(shs), jnp.asarray(alive),
        sh_degree=2, world_view=camera["world_view"],
        full_proj=camera["full_proj"], camera_center=camera["camera_center"],
        tan_fovx=camera["tanfovx"], tan_fovy=camera["tanfovy"],
        width=W, height=H, low_pass=0.3, scale_modifier=1.0)


def _table10(prep):
    return jnp.stack([
        prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
        prep.xy[:, 0], prep.xy[:, 1], prep.opacity,
        prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2],
        prep.depth], axis=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_expand(d, max_instances):
    """rain_tpu's expand_instances on the port's depth-ordered inputs, with
    its operands built as rain_tpu/ops/binning.py:_sorted_pack_fwd does."""
    n = d.table.shape[1]
    C = jbin._expand_chunk(max_instances)
    tiles = d.tiles.numpy()
    offs = d.offs.numpy()
    exc = offs - tiles
    ktable = np.concatenate([
        d.table.numpy() * (tiles > 0)[None, :],
        (exc >> 12)[None], (exc & 0xFFF)[None],
        np.maximum(d.rect_w.numpy(), 1)[None], d.rect_base.numpy()[None],
        d.order.numpy()[None], np.arange(n)[None]], 0).astype(np.float32)
    npad = (n // C + 2) * C
    ktable = np.pad(ktable, ((0, 0), (0, npad - n)))
    exc_p = np.pad(exc, (0, npad - n))[None].astype(np.int32)
    tiles_p = np.pad(tiles, (0, npad - n))[None].astype(np.int32)
    kidx = np.minimum(np.arange(max_instances // C) * C,
                      max(int(offs[-1]) - 1, 0))
    wblk = np.clip(np.searchsorted(offs, kidx, side="right") // C,
                   0, npad // C - 2).astype(np.int32)
    return np.asarray(jexp.expand_instances(
        jnp.asarray(ktable), jnp.asarray(exc_p), jnp.asarray(tiles_p),
        jnp.asarray(wblk), C=C))


def test_expand_instances_torch_matches_jax():
    M = 2048
    prep = _prep()
    d = tbin.depth_order(_t(_table10(prep)), _t(prep.tiles_touched),
                         _t(prep.rect_min), _t(prep.rect_wh), GRID_X)
    cols, keys = texp.expand_instances_torch(
        d.table, d.tiles, d.offs, d.rect_w, d.rect_base, grid_x=GRID_X,
        tile_offset=0, n_tiles=N_TILES, max_instances=M)
    ex = _jax_expand(d, M)
    total = int(d.offs[-1])
    assert 0 < total < M
    cols, keys = cols.numpy(), keys.numpy()
    np.testing.assert_array_equal(cols[:, :total], ex[:10, :total])
    rank = keys[:total] & 0xFFFFFFFF
    np.testing.assert_array_equal(rank, ex[15, :total].astype(np.int64))
    # the tile half of the key: binning.py:418-426 on the JAX columns
    exc_i = (ex[10].astype(np.int64) << 12) | ex[11].astype(np.int64)
    local = np.arange(M) - exc_i
    w_i = np.maximum(ex[12].astype(np.int64), 1)
    tile = ex[13].astype(np.int64) + (local // w_i) * GRID_X + local % w_i
    np.testing.assert_array_equal(keys[:total] >> 32, tile[:total])
    assert np.all(cols[:, total:] == 0.0)
    assert np.all(keys[total:] == N_TILES << 32)


@pytest.mark.parametrize("max_instances,need_depth", [
    (2048, True), (2048, False), (4096, True),
    (256, True),   # far below the instance count: overflow
])
def test_sorted_pack_matches_jax(max_instances, need_depth):
    prep = _prep()
    table10 = _table10(prep)
    pack, total, ovf = jbin.sorted_pack(
        table10, prep.tiles_touched, prep.rect_min, prep.rect_wh,
        jnp.asarray(0, jnp.int32), GRID_X, N_TILES, max_instances,
        need_depth)
    tpack, ttotal, tovf = tbin.sorted_pack(
        _t(table10), _t(prep.tiles_touched), _t(prep.rect_min),
        _t(prep.rect_wh), 0, GRID_X, N_TILES, max_instances, need_depth)
    assert tpack.shape == (16, max_instances)
    np.testing.assert_array_equal(tpack.numpy(), np.asarray(pack))
    assert int(ttotal) == int(total)
    assert bool(tovf) == bool(ovf) == (int(total) > max_instances)
    assert np.isfinite(tpack.numpy()).all()


@pytest.mark.parametrize("max_instances,band", [
    (2048, None), (256, None),           # 256 overflows: clamped ranges
    (2048, (2, 3)),                      # tile rows [2, 5) of the grid
])
def test_tile_ranges_match_jax(max_instances, band):
    prep = _prep(seed=3)
    ty0, n_rows = band or (0, GRID_Y)
    visible = prep.tiles_touched > 0
    start, end = jbin.tile_ranges(prep.rect_min, prep.rect_wh, visible,
                                  GRID_X, n_rows * GRID_X, ty0 * GRID_X,
                                  max_instances)
    tstart, tend = tbin.tile_ranges(_t(prep.rect_min), _t(prep.rect_wh),
                                    _t(visible), GRID_X, n_rows * GRID_X,
                                    ty0 * GRID_X, max_instances)
    assert tstart.dtype == tend.dtype == torch.int32
    np.testing.assert_array_equal(tstart.numpy(), np.asarray(start))
    np.testing.assert_array_equal(tend.numpy(), np.asarray(end))
    assert int(tend.max()) <= max_instances
