"""Port parity: the backward tile compositor (kernel B4's plain version).

rain_tpu_torch.ops.tile_render.composite_backward_torch against
``jax.vjp`` of rain_tpu.ops.tile_render.composite (its Pallas kernels in
interpret mode) on the same JAX-built pack and cotangent, at rain_tpu's
oracle-gradient bar (tests/test_rasterize.py:100): max-abs error /
max-abs value < 1e-4 per gradient row. The TPU kernel differentiates its
tile-local quadratic basis through moment sums, the port the direct-form
power per pixel, so the two agree to f32 rounding, not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import tile_render as jtr
from rain_tpu_torch.ops import tile_render as ttr
from tests.conftest import make_scene
from tests.test_torch_tile_render import GRID_X, N_TILES, _jax_pack, _t

torch.set_num_threads(1)


def _cotangent(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N_TILES, ttr.P, 8)).astype(np.float32)


@pytest.mark.parametrize("seed,opac_bias", [(0, 0.0), (7, 3.0)])
def test_composite_backward_torch_matches_jax(seed, opac_bias):
    # opac_bias=3 → near-opaque Gaussians: early termination, and the
    # 0.99 clamp, which passes the gradient in both
    scene = make_scene(n=300, seed=seed, opac_bias=opac_bias)
    pack, start, end = _jax_pack(scene)
    g = _cotangent()
    tiles, vjp = jax.vjp(
        lambda p: jtr.composite(p, start, end, jnp.zeros((1,), jnp.int32),
                                GRID_X), pack)
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    ttiles = ttr.composite_forward_torch(_t(pack), _t(start), _t(end), 0,
                                         GRID_X)
    got = ttr.composite_backward_torch(_t(pack), _t(start), _t(end), 0,
                                       GRID_X, ttiles, torch.from_numpy(g))
    assert got.shape == (ttr.PACK_ROWS, pack.shape[1])
    got = got.numpy()
    for row in range(ttr.GRAD_ROWS):
        scale = np.abs(want[row]).max()
        assert scale > 0.0
        assert np.abs(got[row] - want[row]).max() / scale < 1e-4, row
    assert np.all(got[ttr.GRAD_ROWS:] == 0.0)     # depth and padding rows
    assert np.all(got[:, int(np.asarray(end).max()):] == 0.0)
    if opac_bias:
        assert float(np.asarray(tiles)[..., ttr.CH_T].min()) < 1e-2
        assert float(np.asarray(pack)[ttr.ROW_OP].max()) > ttr.ALPHA_CLAMP
    # the CPU wrapper takes the plain path
    np.testing.assert_array_equal(
        ttr.composite_backward(_t(pack), _t(start), _t(end), 0, GRID_X,
                               ttiles, torch.from_numpy(g)).numpy(), got)


def test_composite_autograd_runs_b3_forward_and_b4_backward():
    pack, start, end = (_t(x) for x in
                        _jax_pack(make_scene(n=300, seed=3, opac_bias=1.0)))
    g = torch.from_numpy(_cotangent(seed=2))
    seen = {}
    p = pack.clone().requires_grad_(True)
    tiles = ttr.composite(p, start, end, 0, GRID_X, seen.__setitem__)
    assert torch.equal(tiles.detach(), ttr.composite_forward_torch(
        pack, start, end, 0, GRID_X))
    tiles.backward(g)
    args, d_pack = seen["composite_bwd_B4"]
    assert torch.equal(p.grad, d_pack)
    assert torch.equal(d_pack, ttr.composite_backward_torch(*args))
    # only r, g, b and final_T take a cotangent
    g2 = g.clone()
    g2[..., [ttr.CH_DEPTH, ttr.CH_ALPHA, ttr.CH_NCONTRIB, ttr.CH_PAD]] = 7.0
    assert torch.equal(ttr.composite_backward_torch(*args[:6], g2), d_pack)


def test_alpha_clamp_passes_the_gradient():
    # one opaque Gaussian on one tile: alpha = min(0.99, e^power) clamps at
    # the pixels near its centre, and d opacity = Σ_p dL/dalpha_p · G_p
    # there too (the reference's backward.cu:528,544), where autograd
    # through the clamp would give 0
    pack = torch.zeros((ttr.PACK_ROWS, 4))
    pack[:, 0] = torch.tensor([0.05, 0.0, 0.05, 7.3, 8.1, 1.0, 1.0, 0.0,
                               0.0, 2.0] + [0.0] * 6)
    starts = torch.tensor([0], dtype=torch.int32)
    ends = torch.tensor([1], dtype=torch.int32)
    tiles = ttr.composite_forward_torch(pack, starts, ends, 0, 1)
    g = torch.zeros((1, ttr.P, 8))
    g[..., ttr.CH_R] = 1.0
    d = ttr.composite_backward_torch(pack, starts, ends, 0, 1, tiles, g)
    p = torch.arange(ttr.P)
    dx = 7.3 - (p % 16).to(torch.float32)
    dy = 8.1 - (p // 16).to(torch.float32)
    G = torch.exp(-0.5 * (0.05 * dx * dx + 0.05 * dy * dy))
    assert float(G.max()) > ttr.ALPHA_CLAMP          # the clamp is reached
    active = torch.clamp(G, max=ttr.ALPHA_CLAMP) >= ttr.ALPHA_MIN
    # single instance, g_T = 0: dL/dalpha = colour·g = 1 at each pixel
    torch.testing.assert_close(d[ttr.ROW_OP, 0], G[active].sum(),
                               rtol=1e-6, atol=0.0)
    torch.testing.assert_close(
        d[ttr.ROW_R, 0], torch.clamp(G, max=ttr.ALPHA_CLAMP)[active].sum(),
        rtol=1e-6, atol=0.0)
    assert torch.all(d[:, 1:] == 0.0)
