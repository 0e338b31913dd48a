"""Port parity for the KNN scale initialisation (ops/knn.py).

The same seeded clouds go through rain_tpu.ops.knn and its port: a normal
cloud of 500 points, a clustered cloud with exact duplicate points (ties in
the Morton codes, which the stable argsort orders as jnp.argsort does, and
zero distances) and N = 1, 3, 4.

- Morton codes: exactly equal.
- The window search (windows 8, 16, 64), the exact search and the O(N²)
  oracle: bit for bit. The port computes the sums of three squares as the
  fused multiply-adds XLA's CPU backend emits, and the mean as a product
  with the reciprocal of 3, so it rounds as rain_tpu does here.
- N < 5: rain_tpu's exact search merges its running top 4 with an initial
  (−inf, index 0) block, so a row with fewer than four other points takes
  point 0 as a candidate more than once and counts its distance twice
  (rain_tpu/ops/knn.py:147-149). The port does not copy that: its exact
  values equal the window search, which is exact once the window spans
  the cloud (ROADMAP.md C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.ops import knn as jknn
from rain_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)


def normal_cloud(n=500, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 3)).astype(
        np.float32)


def clustered_cloud(seed=1):
    """40 tight clusters of 10 points, then 100 of those points again."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (40, 3))
    pts = (centers[:, None, :] +
           rng.normal(0, 0.01, (40, 10, 3))).reshape(-1, 3)
    pts = np.concatenate([pts, pts[rng.permutation(len(pts))[:100]]])
    return pts.astype(np.float32)


CLOUDS = {"normal": normal_cloud, "clustered": clustered_cloud}


def both(fn_name, pts, **kw):
    j = np.asarray(getattr(jknn, fn_name)(jnp.asarray(pts), **kw))
    t = getattr(tknn, fn_name)(torch.from_numpy(pts), **kw).numpy()
    return j, t


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_morton_codes_equal(cloud):
    pts = CLOUDS[cloud]()
    j, t = both("morton_codes", pts)
    np.testing.assert_array_equal(t, j.astype(np.int64))
    if cloud == "clustered":
        assert len(np.unique(t)) < len(t)   # ties to order


@pytest.mark.parametrize("n", [1, 3, 4])
def test_morton_codes_tiny(n):
    j, t = both("morton_codes", normal_cloud(n))
    np.testing.assert_array_equal(t, j.astype(np.int64))


@pytest.mark.parametrize("window", [8, 16, 64])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_window_search_bitwise(cloud, window):
    j, t = both("mean_dist3", CLOUDS[cloud](), window=window)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_exact_search_bitwise(cloud):
    pts = CLOUDS[cloud]()
    j, t = both("mean_dist3_matmul", pts)
    np.testing.assert_array_equal(t, j)
    jo, to = both("mean_dist3_exact", pts, block=512)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(t, to)
    # the row block is free: any one gives the same bits
    small = tknn.mean_dist3_matmul(torch.from_numpy(pts), row_block=7)
    np.testing.assert_array_equal(small.numpy(), t)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_tiny_clouds(n):
    pts = normal_cloud(n)
    jw, tw = both("mean_dist3", pts, window=8)
    np.testing.assert_array_equal(tw, jw)
    exact = tknn.mean_dist3_matmul(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(exact, tw)
    # the true mean over the available neighbours (missing ones count 0)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1).astype(np.float64)
    np.fill_diagonal(d2, np.inf)
    want = np.sort(d2, axis=1)[:, :3]
    want = np.where(np.isfinite(want), want, 0.0).mean(axis=1)
    np.testing.assert_allclose(exact, want, rtol=1e-6)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_auto_and_upper_bound(cloud):
    pts = torch.from_numpy(CLOUDS[cloud]())
    exact = tknn.mean_dist3_matmul(pts)
    assert torch.equal(tknn.mean_dist3_auto(pts), exact)
    j = np.asarray(jknn.mean_dist3_auto(jnp.asarray(pts.numpy())))
    np.testing.assert_array_equal(exact.numpy(), j)
    # past the limit: the window search, an upper bound of the exact one
    approx = tknn.mean_dist3_auto(pts, exact_limit=len(pts) - 1)
    assert torch.equal(approx, tknn.mean_dist3(pts))
    assert bool((approx >= exact).all())


def test_exact_search_far_from_the_origin_is_exact():
    """A cloud 300 units from the origin (|p|² ~ 2.7e5 against squared
    neighbour distances of ~1e-4): the matmul form in f32 ranks the
    neighbours by its rounding, so rain_tpu's search misses true
    neighbours on most rows; the port picks its candidates in f64 and
    equals the O(N²) oracle bit for bit."""
    rng = np.random.default_rng(5)
    pts = (300.0 + rng.normal(0, 0.05, (600, 3))).astype(np.float32)
    oracle = tknn.mean_dist3_exact(torch.from_numpy(pts)).numpy()
    got = tknn.mean_dist3_matmul(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, oracle)
    j = np.asarray(jknn.mean_dist3_matmul(jnp.asarray(pts)))
    assert (j > oracle).mean() > 0.1    # rain_tpu's misses
