"""The compositor kernels' culling and B4's reduction order, on the CPU.

Kernel B3 (rain_tpu_torch/csrc/tile_render_fwd.cu) skips a pair whose
power lies below ``power_floor(op)``, and B3 and B4 (tile_render_bwd.cu)
skip, for a warp, an instance whose ``block_mask`` bit for the warp's
8x4 pixel block is clear; their plain versions walk every pair, and the
two must agree bit for bit. So neither predicate
may reject a pair that composites: power <= 0 and min(0.99, op·e^power) >=
1/255 under the kernels' f32 arithmetic, which the plain versions share.
These tests hold the plain copies of the predicates (ops/tile_render.py) to
that on seeded random instances and on adversarial ones: thin ellipses,
large opacities, ellipses whose edge lies on a block's edge and opacities
at the edge of 1/255. They also pin B4's pixel-sum order (``_pixel_sum``)
to a plain loop in the order documented in tile_render_bwd.cu.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rain_tpu_torch.ops import tile_render as ttr

torch.set_num_threads(1)

# a tile far from the origin, where pixel coordinates near 1000 round
TX0, TY0 = 1280, 832


def _pixels(tx0=TX0, ty0=TY0):
    p = torch.arange(ttr.P)
    return ((tx0 + p % ttr.TILE).to(torch.float32),
            (ty0 + p // ttr.TILE).to(torch.float32))


def _composites(a, b, c, xg, yg, op, tx0=TX0, ty0=TY0):
    """[n, 256] bool: pair (instance, pixel) passes power <= 0 and alpha >=
    1/255, in the kernels' f32 operations and order; and the power."""
    px, py = _pixels(tx0, ty0)
    a, b, c, xg, yg, op = (v[:, None] for v in (a, b, c, xg, yg, op))
    dx = xg - px
    dy = yg - py
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ttr.ALPHA_CLAMP)
    return (power <= 0.0) & (alpha >= ttr.ALPHA_MIN), power


def _check_never_rejects(a, b, c, xg, yg, op, tx0=TX0, ty0=TY0):
    """Every composited pair passes the floor and its warp's bit; returns
    (share of failing pairs the floor rejects, share of (instance, warp)
    pairs with no composited pixel that the mask culls)."""
    active, power = _composites(a, b, c, xg, yg, op, tx0, ty0)
    floor = ttr.power_floor(op)
    mask = ttr.block_mask(a, b, c, xg, yg, floor, tx0, ty0)
    below = power < floor[:, None]
    assert not bool((active & below).any()), "the floor rejects a pair"
    p = torch.arange(ttr.P)
    warp = 2 * (p // ttr.TILE // 4) + p % ttr.TILE // 8
    bit = ((mask[:, None] >> warp) & 1).bool()
    assert not bool((active & ~bit).any()), "the block mask culls a pair"
    warp_active = active[:, ttr.thread_pixels()].reshape(
        -1, ttr.WARPS, ttr.WARP).any(-1)
    culled = ((mask[:, None] >> torch.arange(ttr.WARPS)) & 1) == 0
    idle = ~warp_active
    return (float((below & ~active).sum() / max(int((~active).sum()), 1)),
            float((culled & idle).sum() / max(int(idle.sum()), 1)))


def _conics(rng, n, sigma_lo, sigma_hi, low_pass):
    """Conics (a, b, c) of random rotated ellipses with axes in
    [sigma_lo, sigma_hi] px, plus `low_pass` on the covariance diagonal."""
    s1 = np.exp(rng.uniform(np.log(sigma_lo), np.log(sigma_hi), n))
    s2 = np.exp(rng.uniform(np.log(sigma_lo), np.log(sigma_hi), n))
    th = rng.uniform(0, np.pi, n)
    co, si = np.cos(th), np.sin(th)
    cxx = co * co * s1 ** 2 + si * si * s2 ** 2 + low_pass
    cyy = si * si * s1 ** 2 + co * co * s2 ** 2 + low_pass
    cxy = co * si * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    return [torch.from_numpy(v.astype(np.float32))
            for v in (cyy / det, -cxy / det, cxx / det)]


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("seed,sigma_hi,low_pass", [
    (0, 8.0, 0.3),      # the garden proxy's sizes, with the low-pass
    (1, 40.0, 0.3),     # large footprints
    (2, 200.0, 0.0),    # thin, up to 1:2000, no low-pass
])
def test_predicates_never_reject_a_composited_pair(seed, sigma_hi, low_pass):
    rng = np.random.default_rng(seed)
    n = 6000
    a, b, c = _conics(rng, n, 0.1, sigma_hi, low_pass)
    xg = _f32(TX0 + rng.uniform(-30, 46, n))
    yg = _f32(TY0 + rng.uniform(-30, 46, n))
    op = _f32(np.where(rng.uniform(size=n) < 0.8, rng.uniform(0, 1, n),
                       rng.choice([ttr.ALPHA_MIN, 0.99, 1.0, 5.0, 1e4], n)))
    floor_share, cull_share = _check_never_rejects(a, b, c, xg, yg, op)
    # and they do skip work: most failing pairs never reach the exponential
    assert floor_share > 0.5
    assert cull_share > 0.2


@pytest.mark.parametrize("opacity", [ttr.ALPHA_MIN * (1 + 1e-6),
                                     ttr.ALPHA_MIN * 1.01, 0.5, 0.99, 1.0,
                                     50.0])
def test_ellipse_edge_on_a_block_edge(opacity):
    # axis-aligned ellipses whose alpha = 1/255 boundary touches a pixel
    # row or column exactly (yg = row ± the exact half-height, or xg =
    # column ± the half-width), at every block edge, for thin and round
    # shapes, nudged by ±1 ulp-scale offsets
    rows = TY0 + np.arange(16)
    cs = np.array([1e-3, 0.02, 0.5, 3.0, 40.0])
    L = np.log(opacity / np.float64(np.float32(ttr.ALPHA_MIN)))
    ry = np.sqrt(2 * L / cs)
    yg = (rows[:, None, None] + np.array([-1, 1])[None, :, None] *
          ry[None, None, :]).reshape(-1)
    yg = (yg[:, None] + np.array([-2e-4, 0.0, 2e-4])).reshape(-1)
    k = yg.shape[0]
    c = np.tile(np.repeat(cs, 3), k // (3 * len(cs)) + 1)[:k]
    for a_scale in (1.0, 1e-3, 1e3):
        a = c * a_scale
        centre = np.full(k, TX0 + 7.3)
        op = _f32(np.full(k, opacity))
        # the edge in y, then the same shapes turned by 90 degrees
        _check_never_rejects(_f32(a), _f32(np.zeros(k)), _f32(c),
                             _f32(centre), _f32(yg), op)
        _check_never_rejects(_f32(c), _f32(np.zeros(k)), _f32(a),
                             _f32(yg - TY0 + TX0), _f32(centre - TX0 + TY0),
                             op)


def test_opacity_at_the_edge_of_alpha_min():
    # op set so that one pixel's alpha is 1/255 up to rounding: the
    # floor's margin must keep it
    rng = np.random.default_rng(5)
    n = 4000
    a, b, c = _conics(rng, n, 0.5, 6.0, 0.3)
    xg = _f32(TX0 + rng.uniform(0, 16, n))
    yg = _f32(TY0 + rng.uniform(0, 16, n))
    p = torch.from_numpy(rng.integers(0, ttr.P, n))
    px, py = _pixels()
    dx, dy = xg - px[p], yg - py[p]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    op = (ttr.ALPHA_MIN / torch.exp(power.double()) *
          (1 + torch.from_numpy(rng.uniform(-1e-6, 1e-6, n)))).float()
    active, _ = _composites(a, b, c, xg, yg, op)
    assert int(active[torch.arange(n), p].sum()) > n // 4
    _check_never_rejects(a, b, c, xg, yg, op)


def test_degenerate_instances_keep_every_block():
    # not an ellipse, non-finite or zero opacity: nothing is culled that
    # could composite, and op = 0 (alpha 0) culls everything
    nan, inf = float("nan"), float("inf")
    a = _f32([0.1, -0.1, 0.1, 0.1, nan, 0.1, 0.1, 0.1])
    b = _f32([0.1, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0])
    c = _f32([0.1, 0.1, 0.0, 0.1, 0.1, 0.1, 0.1, 0.1])
    op = _f32([0.5, 0.5, 0.5, inf, 0.5, nan, -0.5, 0.0])
    n = a.shape[0]
    xg, yg = _f32(np.full(n, TX0 + 3.0)), _f32(np.full(n, TY0 + 3.0))
    _check_never_rejects(a, b, c, xg, yg, op)
    floor = ttr.power_floor(op)
    mask = ttr.block_mask(a, b, c, xg, yg, floor, TX0, TY0)
    assert mask[:5].tolist() == [0xff] * 5      # singular, not PD, NaN, inf
    assert int(mask[-1]) == 0                   # op = 0: floor = +inf


@settings(derandomize=True, max_examples=300, deadline=None, database=None)
@given(st.floats(0.05, 500.0), st.floats(0.05, 500.0), st.floats(0.0, 3.14),
       st.floats(-40.0, 56.0), st.floats(-40.0, 56.0),
       st.floats(1e-3, 1e3), st.floats(0.0, 0.3))
def test_predicates_hold_for_any_ellipse(s1, s2, th, x, y, op, low_pass):
    cxx = np.cos(th) ** 2 * s1 ** 2 + np.sin(th) ** 2 * s2 ** 2 + low_pass
    cyy = np.sin(th) ** 2 * s1 ** 2 + np.cos(th) ** 2 * s2 ** 2 + low_pass
    cxy = np.cos(th) * np.sin(th) * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    if not det > 0:
        return
    _check_never_rejects(_f32([cyy / det]), _f32([-cxy / det]),
                         _f32([cxx / det]), _f32([TX0 + x]), _f32([TY0 + y]),
                         _f32([op]))


def _documented_order(x, keep):
    """tile_render_bwd.cu's phase B, as a loop: for each partial s of 8,
    from +0.0, add the pixels of threads s, s + 8, ..., s + 248 whose pair
    composited (`keep`) in turn, skipping the others; then s += s + 4,
    s += s + 2, s += s + 1. Thread 32 w + l holds pixel (x, y) = (8 (w mod
    2) + l mod 8, 4 (w // 2) + l // 8)."""
    out = np.zeros(x.shape[0], np.float32)
    for t in range(x.shape[0]):
        acc = [np.float32(0.0)] * ttr.SPLIT
        for s in range(ttr.SPLIT):
            for i in range(ttr.P // ttr.SPLIT):
                th = s + ttr.SPLIT * i
                w, lane = th // 32, th % 32
                p = 16 * (4 * (w // 2) + lane // 8) + 8 * (w % 2) + lane % 8
                if keep[t, p]:
                    acc[s] = np.float32(acc[s] + x[t, p])
        half = ttr.SPLIT // 2
        while half:
            acc = [np.float32(acc[s] + acc[s + half]) for s in range(half)]
            half //= 2
        out[t] = acc[0]
    return out


@pytest.mark.parametrize("seed,density", [(0, 0.5), (1, 0.05), (2, 1.0)])
def test_pixel_sum_follows_the_documented_order(seed, density):
    rng = np.random.default_rng(seed)
    n = 24
    x = (rng.standard_normal((n, ttr.P)) *
         np.exp(rng.uniform(-2, 2, (n, ttr.P)))).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.05] = -0.0      # e.g. dx = 0 exactly
    keep = rng.uniform(size=x.shape) < density
    # whole warps with a zero ballot word, and whole instances
    by_thread = keep[:, ttr.thread_pixels().numpy()]
    by_thread.reshape(n, ttr.WARPS, 32)[
        rng.uniform(size=(n, ttr.WARPS)) < 0.3] = False
    keep[:, ttr.thread_pixels().numpy()] = by_thread
    keep[0] = False
    x[0, :7] = -0.0
    want = _documented_order(x, keep)
    # the plain version adds +0 where the kernel skips
    masked = torch.where(torch.from_numpy(keep), torch.from_numpy(x), 0.0)
    got = ttr._pixel_sum(masked[..., None])[:, 0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.signbit(got[0])                   # +0, never -0
    # the order shows in the bits: pixel order gives other sums
    plain = masked.numpy().sum(axis=1, dtype=np.float32)
    assert np.any(plain.view(np.int32) != want.view(np.int32))
