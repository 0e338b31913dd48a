"""Port parity: the VJP of the sorted pack.

The gradient of rain_tpu_torch.ops.binning.sorted_pack in its attribute
table (un-permute through the tile sort, kernel B2's plain version,
un-permute through the depth order) against ``jax.vjp`` of
rain_tpu.ops.binning.sorted_pack (its reduction kernel in interpret mode)
on the same table and cotangent. The two sum each Gaussian's instances in
another order, hence the tolerance of tests/test_expand.py:171.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import binning as jbin
from rain_tpu_torch.ops import binning as tbin
from rain_tpu_torch.ops import tile_render as ttr
from tests.test_torch_expand import GRID_X, N_TILES, _prep, _t, _table10

torch.set_num_threads(1)


@pytest.mark.parametrize("max_instances,need_depth", [
    (2048, False),
    (256, True),     # far below the instance count: overflow
])
def test_sorted_pack_vjp_matches_jax(max_instances, need_depth):
    prep = _prep()
    table10 = _table10(prep)
    rng = np.random.default_rng(3)
    ct = rng.standard_normal((16, max_instances)).astype(np.float32)

    def pack_of(t):
        return jbin.sorted_pack(t, prep.tiles_touched, prep.rect_min,
                                prep.rect_wh, jnp.asarray(0, jnp.int32),
                                GRID_X, N_TILES, max_instances, need_depth)[0]

    pack, vjp = jax.vjp(pack_of, table10)
    (want,) = vjp(jnp.asarray(ct))

    t10 = _t(table10).requires_grad_(True)
    tpack, total, overflow = tbin.sorted_pack(
        t10, _t(prep.tiles_touched), _t(prep.rect_min), _t(prep.rect_wh), 0,
        GRID_X, N_TILES, max_instances, need_depth)
    assert bool(overflow) == (int(total) > max_instances) == \
        (max_instances == 256)
    np.testing.assert_array_equal(tpack.detach().numpy(), np.asarray(pack))
    tpack.backward(torch.from_numpy(ct))
    got = t10.grad.numpy()
    assert got.shape == (ttr.KERNEL_ROWS, table10.shape[1])
    assert np.all(got[ttr.ROW_DEPTH] == 0.0)      # depth takes no gradient
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    # culled Gaussians own no instances and get no gradient
    culled = np.asarray(prep.tiles_touched) == 0
    assert culled.any() and np.all(got[:, culled] == 0.0)


def test_sorted_pack_bwd_reports_b2_and_inverts_both_permutations():
    prep = _prep(seed=2)
    args = (_t(_table10(prep)), _t(prep.tiles_touched), _t(prep.rect_min),
            _t(prep.rect_wh), 0, GRID_X, N_TILES, 2048)
    (pack, total, _), res = tbin.sorted_pack_fwd(*args)
    # a cotangent equal to the pack itself: each Gaussian's column of the
    # table cotangent is then its attributes times its instance count
    seen = {}
    d_table = tbin.sorted_pack_bwd(res, pack.clone(), seen.__setitem__)
    d_rank, exc, tiles, d_depth = seen["reduce_B2"]
    assert d_rank.shape == (ttr.GRAD_ROWS, 2048)
    assert torch.all(d_rank[:, int(total):] == 0.0)
    assert torch.equal(exc, res.exc) and torch.equal(tiles, res.tiles)
    count = prep.tiles_touched
    want = np.asarray(_table10(prep))[:ttr.GRAD_ROWS] * np.asarray(count)
    np.testing.assert_allclose(d_table[:ttr.GRAD_ROWS].numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert torch.all(d_table[ttr.ROW_DEPTH] == 0.0)
    assert d_depth.shape == (ttr.GRAD_ROWS, len(count))
