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


# -- the dispatching ssim_map: the plain version on the CPU ------------------

def _counters():
    return tloss.ssim_map.launches_fwd, tloss.ssim_map.launches_bwd


@pytest.mark.parametrize("shape", [(3, 33, 40), (2, 3, 16, 20), (3, 5, 7)])
def test_ssim_map_on_cpu_is_the_plain_version_bit_for_bit(shape):
    a, b = (torch.from_numpy(v) for v in _images(shape, seed=3))
    got = tloss.ssim_map(a, b)
    want = tloss.ssim_map_plain(a, b)
    assert got.shape == want.shape == (shape if len(shape) == 4
                                       else (1,) + shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _counters() == (0, 0)


def test_ssim_map_gradient_on_cpu_is_the_plain_versions():
    a, b = _images((3, 33, 40), seed=4)
    d = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 3, 33, 40)).astype(np.float32))
    grads = []
    for fn in (tloss.ssim_map, tloss.ssim_map_plain):
        x = torch.from_numpy(a).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x, torch.from_numpy(b)), x, d)[0])
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
    assert float(grads[0].abs().max()) > 0.0
    assert _counters() == (0, 0)


@pytest.mark.parametrize("case", ["img2_grad", "float64", "img1_strided",
                                  "img2_strided", "shapes", "2d"])
def test_ssim_map_rejects_what_the_kernels_do_not_take(case):
    a, b = (torch.from_numpy(v) for v in _images((3, 16, 20), seed=5))
    args = {"img2_grad": (a, b.clone().requires_grad_(True)),
            "float64": (a.double(), b.double()),
            "img1_strided": (a.transpose(1, 2), b.transpose(1, 2)
                             .contiguous()),
            "img2_strided": (a, b.transpose(1, 2).contiguous()
                             .transpose(1, 2)),
            "shapes": (a, b[:, :15]),
            "2d": (a[0], b[0])}[case]
    with pytest.raises(ValueError):
        tloss.ssim_map(*args)


def _kernels_backward(img1, img2, d_map):
    """The arithmetic of csrc/ssim.cu's backward in torch ops: SF's three
    partials of the map (dm/dmu1 with the blurred moments held,
    dm/dsigma1², dm/dsigma12), their products with d_map blurred, and
    d_img1 = B(a) + 2·img1·B(b) + img2·B(c)."""
    g = tloss._gaussian_window(11)

    def blur(t):
        return tloss._blur1d(tloss._blur1d(t, 3, g), 2, g)

    mu1, mu2, e11, e22, e12 = (blur(t) for t in (
        img1, img2, img1 * img1, img2 * img2, img1 * img2))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    num_l = 2 * mu1_mu2 + tloss.C1
    num_c = 2 * (e12 - mu1_mu2) + tloss.C2
    den_l = mu1_sq + mu2_sq + tloss.C1
    den_c = (e11 - mu1_sq) + (e22 - mu2_sq) + tloss.C2
    m = (num_l * num_c) / (den_l * den_c)
    den = den_l * den_c
    d_mu1 = 2 * (mu2 * (num_c - num_l) + mu1 * m * (den_l - den_c)) / den
    d_s1 = -m / den_c
    d_s12 = 2 * num_l / den
    return (blur(d_map * d_mu1) + 2 * img1 * blur(d_map * d_s1) +
            img2 * blur(d_map * d_s12))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", [(1, 3, 45, 61), (1, 3, 128, 160),
                                   (2, 3, 5, 7)])
def test_the_kernels_backward_arithmetic_is_autograds(shape):
    """The backward's design: with zero padding and symmetric taps the
    blur's adjoint is the blur, so the three blurred products give the
    gradient: in f64 it is autograd's to 1e-12. In f32 it is as near the
    f64 gradient as autograd's own f32 gradient is (both start from the
    plain version's f32 moments, whose rounding the partials magnify), to
    the factor the card test allows, or within 1e-6."""
    g = tloss._gaussian_window(11)
    assert g == g[::-1]
    a, b = (torch.from_numpy(v) for v in _images(shape, seed=6))
    d = torch.from_numpy(np.random.default_rng(6).normal(
        size=shape).astype(np.float32))
    grads = {}
    for dtype in (torch.float64, torch.float32):
        x = a.to(dtype).requires_grad_(True)
        grads[dtype] = torch.autograd.grad(
            tloss.ssim_map_plain(x, b.to(dtype)), x, d.to(dtype))[0]
    exact = grads[torch.float64]
    assert _gap(_kernels_backward(a.double(), b.double(), d.double()),
                exact) < 1e-12
    got = _kernels_backward(a, b, d).double()
    assert _gap(got, exact) <= max(2 * _gap(grads[torch.float32].double(),
                                            exact), 1e-6)
