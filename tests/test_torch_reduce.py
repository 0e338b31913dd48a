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
from torch_reduce_cases import CASES, contract, reduce_case

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


# --- kernel B2's contract and schedule at its edge cases ------------------

N_CASE, M_CASE = 3000, 16_384


def _warp_lower_bound(exc, target):
    """csrc/reduce.cu:warp_lower_bound in Python: the first g with
    exc[g] >= target (or N) by 32-way probes; returns (g, rounds)."""
    lo, hi, rounds = 0, len(exc), 0
    while lo < hi:
        rounds += 1
        step = (hi - lo + 31) >> 5
        p = lo + np.arange(32) * step
        above = (p >= hi) | (exc[np.minimum(p, hi - 1)] >= target)
        if not above.any():
            lo += 31 * step + 1
        else:
            j = int(np.argmax(above))
            hi = min(hi, lo + j * step)
            if j > 0:
                lo += (j - 1) * step + 1
    return lo, rounds


def _sum_from(acc, cols):
    """acc plus cols' columns, added left to right in float32."""
    seq = np.concatenate([acc[:, None], cols], axis=1)
    return np.cumsum(seq, axis=1, dtype=np.float32)[:, -1]


def _block_schedule(d, exc, tiles, chunk=1024, tail=1024):
    """csrc/reduce.cu's schedule in Python: per chunk of instances below
    the live count, the Gaussians whose segments start there and below
    the live count (two warp searches, then a stop at the first one past
    it), each summed from the staged chunk and, for the one that runs past
    it, on through the next chunks; then the tail blocks' zeros. Returns
    (out, how many times each column was written)."""
    rows, m = d.shape
    n = len(exc)
    out = np.full((rows, n), np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    if n == 0:
        return out, writes
    live = min(int(exc[-1]) + int(tiles[-1]), m)
    for i0 in range(0, m, chunk):
        if i0 >= live:
            break
        cend = min(i0 + chunk, live)    # the block stages [i0, cend)
        lo = _warp_lower_bound(exc, i0)[0]
        hi = _warp_lower_bound(exc, i0 + chunk)[0]
        for g in range(lo, hi):
            b = int(exc[g])
            if b >= live:
                break
            e = min(b + int(tiles[g]), m)
            j_end = min(e, i0 + chunk)
            assert i0 <= b and j_end <= cend
            acc = _sum_from(np.zeros(rows, np.float32), d[:, b:j_end])
            for p in range(i0 + chunk, e, chunk):   # the carried segment
                acc = _sum_from(acc, d[:, p:min(p + chunk, e)])
            out[:, g] = acc
            writes[g] += 1
    for t0 in range(0, n, tail):
        t1 = min(t0 + tail, n)
        if exc[t1 - 1] < live:
            continue
        for g in range(t0, t1):
            if exc[g] >= live:
                out[:, g] = 0.0
                writes[g] += 1
    return out, writes


@pytest.mark.parametrize("case", CASES)
def test_reduction_follows_the_contract(case):
    d, exc, tiles = reduce_case(case, N_CASE, M_CASE)
    got = texp.reduce_instances(d, exc, tiles)
    want = contract(d.numpy(), exc.numpy(), tiles.numpy())
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_plain_reduction_keeps_f64(case):
    """The plain version sums in its input's dtype: f64 columns give the
    contract's f64 sums bit for bit (the f64 oracles of
    tests/test_torch_grad_f64.py and tests/torch_gt_images.py rely on
    it)."""
    d, exc, tiles = reduce_case(case, N_CASE, M_CASE)
    got = texp.reduce_instances_torch(d.double(), exc, tiles)
    assert got.dtype == torch.float64
    want = contract(d.numpy().astype(np.float64), exc.numpy(), tiles.numpy())
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))


@pytest.mark.parametrize("chunk,tail", [(1024, 1024), (64, 32)])
@pytest.mark.parametrize("case", CASES)
def test_b2_block_schedule_follows_the_contract(case, chunk, tail):
    d, exc, tiles = (a.numpy() for a in reduce_case(case, N_CASE, M_CASE))
    got, writes = _block_schedule(d, exc, tiles, chunk, tail)
    # every column written once, bit for bit the contract's
    assert np.all(writes == 1)
    np.testing.assert_array_equal(got.view(np.int32),
                                  contract(d, exc, tiles).view(np.int32))


def test_reduce_cases_reach_their_edges():
    sizes = {}
    for case in CASES:
        d, exc, tiles = reduce_case(case, N_CASE, M_CASE)
        total = int(tiles.sum())
        sizes[case] = (exc.shape[0], d.shape[1], total, int(tiles.max())
                       if tiles.numel() else 0)
    assert sizes["long_segment"][3] > 3 * 1024
    assert sizes["whole_grid"][3] == 82 * 53
    n, m, total, _ = sizes["clipped_at_m"]
    assert total > m and m % 2 == 1
    assert sizes["crossing_chunks"][3] >= 20
    assert sizes["ragged_m"][1] % 4 != 0 and sizes["no_instances"][2] == 0
    assert sizes["no_gaussians"][0] == 0
    assert all(sizes[c][2] <= sizes[c][1] for c in CASES
               if c != "clipped_at_m")


@pytest.mark.parametrize("n", [1, 2, 33, 1025, 786_432])
def test_warp_lower_bound_takes_log32_rounds(n):
    rng = np.random.default_rng(n)
    tiles = rng.integers(0, 30, n) * (rng.random(n) < 0.6)
    exc = np.cumsum(tiles) - tiles
    total = int(tiles.sum())
    for t in np.concatenate([[0, total, total + 1],
                             rng.integers(0, total + 1, 64)]):
        g, rounds = _warp_lower_bound(exc, t)
        assert g == np.searchsorted(exc, t, side="left")
        assert 32 ** rounds < 32 * (n + 1)   # rounds <= ceil(log_32(n + 1))
