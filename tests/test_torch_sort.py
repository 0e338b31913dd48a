"""Port parity: the bitonic sorts and the legacy instance list.

rain_tpu_torch.ops.sort against np.sort and a lexicographic sort (the
counterparts of tests/test_sort.py), bin_gaussians with the torch and the
bitonic sort against each other and against rain_tpu's bin_gaussians bit
for bit, on a conftest-size scene (the same Preprocessed fed to both), in
the packed-key and in the pair-sort branch.
"""

import numpy as np
import pytest
import torch

from rain_tpu.ops import binning as jbin
from rain_tpu.ops import projection as jproj
from rain_tpu_torch.ops import binning as tbin
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.ops import sort as tsort
from tests.conftest import make_camera, make_scene

torch.set_num_threads(1)

W, H = 80, 64
GX, GY = (W + 15) // 16, (H + 15) // 16


@pytest.mark.parametrize("n", [1, 128, 1000, 4096, 65536])
def test_bitonic_sort_matches_numpy(n):
    k = np.random.default_rng(n).integers(0, 1 << 30, n, dtype=np.int32)
    got = tsort.bitonic_sort(torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.sort(k))


def test_bitonic_sort_int64_keys_and_padding():
    """int64 keys (the port's instance keys) sort as np.sort does, with
    the I32_MAX padding of a length that is not a power of two."""
    k = np.random.default_rng(3).integers(0, tsort.I32_MAX, 3001)
    got = tsort.bitonic_sort(torch.from_numpy(k))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.sort(k))


@pytest.mark.parametrize("n,key_range", [(1000, 1 << 30), (4096, 60),
                                         (65536, 1 << 20)])
def test_bitonic_pairs_lexicographic(n, key_range):
    """Pairs sort by (key, value) lexicographically: the order of the
    packed (tile << bits | rank) key."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, key_range, n, dtype=np.int32)
    v = rng.integers(0, 1 << 20, n, dtype=np.int32)
    gk, gv = tsort.bitonic_sort_pairs(torch.from_numpy(k),
                                      torch.from_numpy(v))
    perm = np.lexsort((v, k))
    np.testing.assert_array_equal(gk.numpy(), k[perm])
    np.testing.assert_array_equal(gv.numpy(), v[perm])


def _prep(seed=5, n=300):
    """rain_tpu's Preprocessed of a conftest scene, and the same arrays as
    the port's Preprocessed."""
    s = make_scene(n=n, seed=seed)
    cam = make_camera(W, H)
    jp = jproj.preprocess(
        s["means"], s["scales"], s["quats"], s["opac"], s["shs"],
        s["alive"], sh_degree=3, world_view=cam["world_view"],
        full_proj=cam["full_proj"], camera_center=cam["camera_center"],
        tan_fovx=cam["tanfovx"], tan_fovy=cam["tanfovy"], width=W,
        height=H, low_pass=0.3)
    tp = tproj.Preprocessed(*(torch.from_numpy(np.array(x)) for x in jp))
    return jp, tp


def _assert_same(got, want):
    for name, a, b in zip(tbin.Binning._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("m", [2048, 700])
def test_bin_gaussians_matches_rain_tpu(m):
    """Every field of the Binning, bit for bit, with room to spare and
    with an overflow (M below the instance count)."""
    jp, tp = _prep()
    want = jbin.bin_gaussians(jp, GX, GY, m)
    for sort in tbin.SORTS:
        _assert_same(tbin.bin_gaussians(tp, GX, GY, m, sort=sort), want)
    assert bool(want.overflow) == (m == 700)
    assert int(want.num_instances) > 700


def test_bin_gaussians_pair_branch(monkeypatch):
    """Past the packed key's limit the instances are sorted as (tile, rank)
    pairs, by either sort, with the packed branch's result (and
    rain_tpu's)."""
    jp, tp = _prep(seed=6)
    want = jbin.bin_gaussians(jp, GX, GY, 2048)
    monkeypatch.setattr(tbin, "PACKED_KEY_LIMIT", 0)
    for sort in tbin.SORTS:
        _assert_same(tbin.bin_gaussians(tp, GX, GY, 2048, sort=sort), want)


def test_bin_gaussians_rejects_an_unknown_sort():
    _, tp = _prep()
    with pytest.raises(ValueError, match="sort="):
        tbin.bin_gaussians(tp, GX, GY, 2048, sort="lax")
