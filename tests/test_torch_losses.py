"""Port parity: training losses and image metrics.

rain_tpu_torch.ops.losses against rain_tpu.ops.losses on the same seeded
images, and the gradient of ``training_loss`` at rain_tpu's gradient bar
(max-abs error / max-abs value < 1e-4). Both blur with the same shifted
slices in the same order, so the SSIM maps agree to a few f32 ulps. The
scalar losses are means over 10^3-10^4 pixels that torch and XLA sum in
different orders; the f32 rounding of such a sum is ~1e-6 of its value,
hence rtol 2e-6 for them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rain_tpu.ops import losses as jloss
from rain_tpu_torch.ops import losses as tloss

torch.set_num_threads(1)

RTOL_MEAN = 2e-6


def _images(shape=(3, 45, 61), seed=0):
    """An image and a noisy copy of it, as a render and its target are:
    their SSIM is far from 0, so its mean carries no cancellation."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "ssim", "psnr"])
@pytest.mark.parametrize("shape", [(3, 45, 61), (2, 3, 16, 20)])
def test_metric_matches_jax(name, shape):
    a, b = _images(shape)
    want = np.asarray(getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tloss, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_MEAN)


def test_ssim_map_matches_jax():
    a, b = _images((3, 33, 40), seed=1)
    want = np.asarray(jloss.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    got = tloss.ssim_map(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (1, 3, 33, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_training_loss_and_its_gradient_match_jax():
    img, gt = _images(seed=2)
    (want, want_l1), want_g = jax.value_and_grad(
        jloss.training_loss, has_aux=True)(jnp.asarray(img), jnp.asarray(gt))
    x = torch.from_numpy(img).requires_grad_(True)
    loss, l1 = tloss.training_loss(x, torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL_MEAN)
    np.testing.assert_allclose(l1.item(), float(want_l1), rtol=RTOL_MEAN)
    want_g = np.asarray(want_g)
    err = np.abs(x.grad.numpy() - want_g).max() / np.abs(want_g).max()
    assert err < 1e-4


def test_masked_loss_matches_jax_and_the_cropped_loss():
    rng = np.random.default_rng(1)
    h, w, bh, bw = 45, 61, 48, 64
    img = rng.uniform(0, 1, (3, bh, bw)).astype(np.float32)
    gt = np.zeros((3, bh, bw), np.float32)
    gt[:, :h, :w] = rng.uniform(0, 1, (3, h, w))
    want = jloss.masked_training_loss(jnp.asarray(img), jnp.asarray(gt), w, h)
    got = tloss.masked_training_loss(torch.from_numpy(img),
                                     torch.from_numpy(gt), w, h)
    crop = tloss.training_loss(torch.from_numpy(img[:, :h, :w]),
                               torch.from_numpy(gt[:, :h, :w]))
    for g, j, c in zip(got, want, crop):
        np.testing.assert_allclose(float(g), float(j), rtol=RTOL_MEAN)
        np.testing.assert_allclose(float(g), float(c), rtol=RTOL_MEAN)
