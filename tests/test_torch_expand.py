"""Port parity: instance expansion, sorted pack and tile ranges.

rain_tpu_torch's expansion (the plain version of kernel B1), sorted pack
and tile ranges against rain_tpu's on the same seeded scene. The JAX
expansion kernel runs in Pallas interpret mode, as the JAX package's own
tests run it. The pack is a selection and a permutation of the same f32
values, so it must agree bit for bit, and so must every integer.

The expansion's contract at its edge cases (tests/torch_expand_cases.py):
the plain version, and a Python copy of kernel B1's block schedule
(csrc/expand.cu: the warp search, the staged window in pieces, the walk),
against a loop over instances written from the contract's words.
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
from torch_expand_cases import CASES, expand_case

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
        _t(prep.rect_wh), 0, GRID_X, N_TILES, max_instances,
        "z" if need_depth else None)
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


N_CASE, M_CASE = 3000, 16_384


def _contract(table, tiles, offs, rect_w, rect_base, *, grid_x, tile_offset,
              n_tiles, max_instances):
    """The contract's words as a loop: Gaussian g's k-th instance exc[g] + k
    (if below M) holds g's rows and the key of the k-th tile of its rect in
    row-major order; every other column is zero with key n_tiles << 32."""
    cols = np.zeros((10, max_instances), np.float32)
    keys = np.full(max_instances, int(n_tiles) << 32, np.int64)
    for g in np.flatnonzero(tiles):
        w = max(int(rect_w[g]), 1)
        exc = int(offs[g]) - int(tiles[g])
        for k in range(min(int(tiles[g]), max_instances - exc)):
            tile = int(rect_base[g]) + k // w * grid_x + k % w - tile_offset
            cols[:, exc + k] = table[:, g]
            keys[exc + k] = tile << 32 | int(g)
    return cols, keys


def _warp_owner(offs, target):
    """csrc/expand.cu:warp_owner: 32 lanes probe 32 points and a ballot
    cuts the range per round. Returns (first g with offs[g] > target,
    rounds)."""
    lo, hi, rounds = 0, len(offs) - 1, 0
    while lo < hi:
        step = (hi - lo + 31) >> 5
        p = lo + np.arange(32) * step
        above = (p >= hi) | (offs[np.minimum(p, hi)] > target)
        if not above.any():
            lo += 31 * step + 1
        else:
            j = int(np.argmax(above))
            hi = min(lo + j * step, hi)
            if j > 0:
                lo += (j - 1) * step + 1
        rounds += 1
    return lo, rounds


def _block_schedule(table, tiles, offs, rect_w, rect_base, *, grid_x,
                    tile_offset, n_tiles, max_instances, threads=16, v=4,
                    window=16):
    """csrc/expand.cu's schedule in Python, at a small block and window:
    per chunk of threads * v instances, the owners of its first and last
    live instance by the warp search, then the window between them in
    pieces of `window` Gaussians; thread t searches its first column's owner
    in the piece and walks on (the next tile, or the next owner's first)."""
    m = max_instances
    cols = np.zeros((10, m), np.float32)
    keys = np.full(m, int(n_tiles) << 32, np.int64)
    live = min(int(offs[-1]) if len(offs) else 0, m)
    for i0 in range(0, live, threads * v):
        end = min(i0 + threads * v, live)
        g0, g1 = _warp_owner(offs, i0)[0], _warp_owner(offs, end - 1)[0]
        lo = i0
        for a in range(g0, g1 + 1, window):
            w_offs = offs[a:min(a + window, g1 + 1)]
            hi = int(w_offs[-1])
            for c0 in range(i0, end, v):
                j = None
                for i in range(max(c0, lo), min(c0 + v, hi, end)):
                    if j is None:
                        j = int(np.searchsorted(w_offs, i, side="right"))
                        local = i - (int(w_offs[j]) - int(tiles[a + j]))
                        wd = max(int(rect_w[a + j]), 1)
                        dy, dx = divmod(local, wd)
                    elif w_offs[j] > i:
                        dx += 1
                        if dx == wd:
                            dx, dy = 0, dy + 1
                    else:
                        while w_offs[j] <= i:
                            j += 1
                        wd = max(int(rect_w[a + j]), 1)
                        dx = dy = 0
                    tile = int(rect_base[a + j]) + dy * grid_x + dx - \
                        tile_offset
                    cols[:, i] = table[:, a + j]
                    keys[i] = tile << 32 | (a + j)
            lo = hi
    return cols, keys


def _assert_bitwise(cols, keys, want_cols, want_keys):
    np.testing.assert_array_equal(keys, want_keys)
    assert cols.shape == want_cols.shape
    np.testing.assert_array_equal(cols.view(np.int32),
                                  want_cols.view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_expansion_follows_the_contract(case):
    args, kw = expand_case(case, N_CASE, M_CASE)
    cols, keys = texp.expand_instances(*args, **kw)
    _assert_bitwise(cols.numpy(), keys.numpy(),
                    *_contract(*(a.numpy() for a in args), **kw))


@pytest.mark.parametrize("case", CASES)
def test_b1_block_schedule_follows_the_contract(case):
    args, kw = expand_case(case, N_CASE, M_CASE)
    arrays = [a.numpy() for a in args]
    _assert_bitwise(*_block_schedule(*arrays, **kw), *_contract(*arrays, **kw))


@pytest.mark.parametrize("case", CASES)
def test_plain_expansion_keeps_f64(case):
    """The plain version copies in its table's dtype: from an f64 table
    its columns are the f32 run's converted to f64, bit for bit, with the
    same keys (the f64 oracles of tests/test_torch_grad_f64.py and
    tests/torch_gt_images.py rely on it)."""
    (table, *rest), kw = expand_case(case, N_CASE, M_CASE)
    cols, keys = texp.expand_instances_torch(table, *rest, **kw)
    cols64, keys64 = texp.expand_instances_torch(table.double(), *rest, **kw)
    assert cols64.dtype == torch.float64
    np.testing.assert_array_equal(keys64.numpy(), keys.numpy())
    np.testing.assert_array_equal(cols64.numpy().view(np.int64),
                                  cols.double().numpy().view(np.int64))


@pytest.mark.parametrize("n", [1, 2, 33, 1025, 262_144, 2**21 + 3])
def test_warp_owner_search_takes_log32_rounds(n):
    rng = np.random.default_rng(n)
    offs = np.cumsum(rng.integers(0, 4, n) * (rng.random(n) < 0.8))
    offs[-1] += 1   # at least one instance
    targets = rng.integers(0, offs[-1], 64)
    for t in np.concatenate([[0, offs[-1] - 1], targets]):
        owner, rounds = _warp_owner(offs, t)
        assert owner == np.searchsorted(offs, t, side="right")
        assert 32 ** rounds < 32 * n   # rounds <= ceil(log_32 n)


def test_expansion_rejects_counts_past_int32():
    args, kw = expand_case("one_rect_spans_chunks", 50, 64)
    with pytest.raises(ValueError):
        texp.expand_instances(*args, **dict(kw, max_instances=2**31))
