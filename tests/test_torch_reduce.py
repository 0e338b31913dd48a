"""Port parity: the instance reduction (kernel B2's plain version).

rain_tpu_torch.ops.expand.reduce_instances_torch against rain_tpu's
reduce_instances (its Pallas kernel in interpret mode, as
tests/test_expand.py runs it) on the cases of
tests/test_expand.py:127-134, at that test's tolerance: the two sum each
segment in another order (one thread in instance order here, a one-hot
matmul there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.ops import expand as jexp
from rain_tpu_torch.ops import expand as texp

torch.set_num_threads(1)

C = 128


def _segments(n, m, kill, seed=11):
    """Depth-ordered tile counts (visible Gaussians first) and rank-ordered
    gradient columns, zero past the instance count."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 5, n).astype(np.int32)
    tiles[rng.random(n) < kill] = 0
    tiles = np.sort(tiles)[::-1].copy()
    offs = np.cumsum(tiles)
    d = rng.standard_normal((9, m)).astype(np.float32)
    d[:, int(offs[-1]):] = 0.0
    return d, offs - tiles, tiles


def _jax_reduce(d, exc, tiles):
    """rain_tpu's reduce_instances with its operands built as
    rain_tpu/ops/binning.py:_sorted_pack_fwd builds them."""
    n, m = tiles.shape[0], d.shape[1]
    offs = exc + tiles
    npad = (n // C + 2) * C
    exc_p = np.zeros((1, npad), np.int32)
    exc_p[0, :n] = exc
    tiles_p = np.zeros((1, npad), np.int32)
    tiles_p[0, :n] = tiles
    kidx = np.minimum(np.arange(m // C) * C, max(int(offs[-1]) - 1, 0))
    wblk = np.clip(np.searchsorted(offs, kidx, side="right") // C,
                   0, npad // C - 2).astype(np.int32)
    out = jexp.reduce_instances(jnp.asarray(d), jnp.asarray(exc_p),
                                jnp.asarray(tiles_p), jnp.asarray(wblk), C=C)
    return np.asarray(out)[:, :n]


@pytest.mark.parametrize("n,m,kill", [(300, 512, 0.3), (1200, 2048, 0.9)])
def test_reduce_instances_torch_matches_jax(n, m, kill):
    d, exc, tiles = _segments(n, m, kill)
    assert int((exc + tiles)[-1]) < m
    got = texp.reduce_instances_torch(torch.from_numpy(d),
                                      torch.from_numpy(exc.astype(np.int64)),
                                      torch.from_numpy(tiles))
    assert got.shape == (9, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_reduce(d, exc, tiles),
                               rtol=1e-6, atol=1e-6)


def test_reduce_instances_sums_each_segment_in_order():
    d, exc, tiles = _segments(300, 512, 0.3, seed=4)
    args = (torch.from_numpy(d), torch.from_numpy(exc.astype(np.int64)),
            torch.from_numpy(tiles))
    got = texp.reduce_instances_torch(*args)
    # the segment sum, added left to right from 0.0 as the kernel does
    want = np.zeros((9, 300), np.float32)
    for g in range(300):
        for i in range(exc[g], exc[g] + tiles[g]):
            want[:, g] += d[:, i]
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper takes the plain path
    assert torch.equal(texp.reduce_instances(*args), got)


def test_reduce_instances_clips_segments_to_capacity():
    # overflow: the last segments run past M and are cut there
    tiles = np.array([3, 4, 5, 0], np.int32)
    exc = (np.cumsum(tiles) - tiles).astype(np.int64)
    d = np.arange(2 * 9, dtype=np.float32).reshape(2, 9)
    got = texp.reduce_instances_torch(torch.from_numpy(d),
                                      torch.from_numpy(exc),
                                      torch.from_numpy(tiles))
    want = np.stack([d[:, 0:3].sum(1), d[:, 3:7].sum(1), d[:, 7:9].sum(1),
                     np.zeros(2, np.float32)], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reduce_instances_rejects_wrong_inputs():
    d = torch.zeros((9, 16))
    exc = torch.zeros(4, dtype=torch.int64)
    tiles = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        texp.reduce_instances(d.double(), exc, tiles)
    with pytest.raises(ValueError):
        texp.reduce_instances(d, exc.int(), tiles)
    with pytest.raises(ValueError):
        texp.reduce_instances(d, exc, tiles[:3])
