"""Training losses and image metrics: L1, SSIM, PSNR.

Port of rain_tpu/ops/losses.py, with the reference formulas:
- l1: mean absolute error                      (utils/loss_utils.py:6)
- ssim: 11x11 Gaussian window, sigma 1.5, SAME zero padding, per channel,
  C1=0.01², C2=0.03²                            (utils/loss_utils.py:12-52)
- psnr: 20·log10(1/sqrt(mse)) per image        (utils/image_utils.py:6-8)
- training loss: (1-λ)·L1 + λ·(1-SSIM), λ=0.2  (train.py:114)

The SSIM window is the outer product g·gᵀ, so the blur is the separable
pass of the JAX package (losses.py:59-90): 11 statically shifted slices of
the zero-padded moment images, weighted and summed in tap order, along x
and then along y. It rounds like the reference and its backward is
slices and adds, with no ``conv2d``, whose cuDNN backward may pick a
non-deterministic algorithm.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(x, y):
    return torch.abs(x - y).mean()


def l2_loss(x, y):
    return ((x - y) ** 2).mean()


@functools.lru_cache()
def _gaussian_window(window_size: int = 11, sigma: float = 1.5):
    g = np.array([math.exp(-(i - window_size // 2) ** 2 /
                           (2 * sigma ** 2)) for i in range(window_size)])
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """SSIM over [C, H, W] (or [N, C, H, W]) images, mean-reduced."""
    return ssim_map(img1, img2, window_size).mean()


def _blur1d(x: torch.Tensor, dim: int, g: tuple[float, ...]) -> torch.Tensor:
    """Zero-padded 1-D blur of x along ``dim`` with taps g, as the sum of
    len(g) shifted slices in tap order."""
    pad = len(g) // 2
    padding = [0, 0] * x.dim()
    # F.pad lists (before, after) pairs from the last dimension backwards
    padding[2 * (x.dim() - 1 - dim)] = pad
    padding[2 * (x.dim() - 1 - dim) + 1] = pad
    xp = F.pad(x, padding)
    n = x.shape[dim]
    acc = None
    for k, gk in enumerate(g):
        term = gk * xp.narrow(dim, k, n)
        acc = term if acc is None else acc + term
    return acc


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map [N, C, H, W]."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    c = img1.shape[1]
    g = _gaussian_window(window_size)
    stacked = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1)
    out = _blur1d(_blur1d(stacked, 3, g), 2, g)
    mu1 = out[:, 0:c]
    mu2 = out[:, c:2 * c]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = out[:, 2 * c:3 * c] - mu1_sq
    sigma2_sq = out[:, 3 * c:4 * c] - mu2_sq
    sigma12 = out[:, 4 * c:5 * c] - mu1_mu2
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    return (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) /
            ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR; img [C, H, W] or [N, C, H, W] in [0, 1]."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    mse = ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(dim=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def training_loss(image, gt, lambda_dssim: float = 0.2):
    """(1-λ)·L1 + λ·(1-SSIM)  (train.py:113-114). Returns (loss, l1)."""
    ll1 = l1_loss(image, gt)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt))
    return loss, ll1


def masked_training_loss(image, gt, real_w: int, real_h: int,
                         lambda_dssim: float = 0.2):
    """The training loss of a tile-padded render target.

    image/gt are [3, BH, BW] with the live image in the top-left
    (real_h, real_w) region; gt must be zero beyond it. Both inputs are
    zeroed outside the region, which reproduces the SSIM blur's zero
    padding at the real image's border, and the means divide by the real
    pixel count, so the result equals
    ``training_loss(image[:, :h, :w], gt[:, :h, :w])``. Returns (loss, l1).
    """
    bh, bw = image.shape[-2], image.shape[-1]
    dev = image.device
    mask = ((torch.arange(bh, device=dev) < real_h)[:, None] &
            (torch.arange(bw, device=dev) < real_w)[None, :])
    img = image * mask[None]
    gt = gt * mask[None]
    # 3·h·w rounded as the f32 products 3·h, then ·w, made on the host and
    # filled on the device: a copy from host memory would wait for it. The
    # divisor stays a device tensor: a CUDA tensor divided by a host scalar
    # is multiplied by its reciprocal, which can round another way
    n_pix = torch.full((), float(np.float32(3.0) * np.float32(real_h) *
                                 np.float32(real_w)),
                       dtype=torch.float32, device=dev)
    ll1 = torch.sum(torch.abs(img - gt)) / n_pix
    # pad pixels have ssim_map == 1 (0/0 regularised): mask before the sum
    sm = ssim_map(img, gt)[0]
    ssim_v = torch.sum(sm * mask[None]) / n_pix
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim_v)
    return loss, ll1
