"""Training losses and image metrics: L1, SSIM, PSNR.

Port of rain_tpu/ops/losses.py, with the reference formulas:
- l1: mean absolute error                      (utils/loss_utils.py:6)
- ssim: 11x11 Gaussian window, sigma 1.5, SAME zero padding, per channel,
  C1=0.01², C2=0.03²                            (utils/loss_utils.py:12-52)
- psnr: 20·log10(1/sqrt(mse)) per image        (utils/image_utils.py:6-8)
- training loss: (1-λ)·L1 + λ·(1-SSIM), λ=0.2  (train.py:114)
- depth L1: mean(|(D - D̂)·m|) of the rendered inverse depth D against
  the target D̂ under the mask m (graphdeco-inria/gaussian-splatting's
  2024 train.py, depth regularization), added with its weight

The SSIM map follows the images' device, as every kernel wrapper does:

- CPU images run the plain version, ``ssim_map_plain``, under autograd.
  The window is the outer product g·gᵀ, so its blur is the separable pass
  of the JAX package (losses.py:59-90): 11 statically shifted slices of
  the zero-padded moment images, weighted and summed in tap order, along
  x and then along y. It rounds like the reference, and its backward is
  slices and adds, with no ``conv2d``, whose cuDNN backward may pick a
  non-deterministic algorithm.
- CUDA images run the autograd Function ``_SSIMMap``: the forward kernel
  SF and the backward kernel SB of ``csrc/ssim.cu``, the blur separable
  in shared memory. SF's map equals the plain version's bit for bit; SB's
  gradient of the first image agrees with autograd's to f32 rounding and
  is bitwise reproducible (no atomics).

The L1 term, the masks and the sums stay plain PyTorch on either device.
``ssim_map`` takes contiguous f32 images and differentiates the first
alone: no caller differentiates the target. It counts its launches in
``ssim_map.launches_fwd`` and ``ssim_map.launches_bwd``: one of each per
training step, one forward per evaluated image, none on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from rain_tpu_torch import _build
from rain_tpu_torch import device as device_mod

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WINDOW = 11            # the kernels' window
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
    """SSIM over [C, H, W] (or [N, C, H, W]) images of any layout,
    mean-reduced."""
    return ssim_map(img1.contiguous(), img2.contiguous(), window_size).mean()


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


def ssim_map_plain(img1: torch.Tensor, img2: torch.Tensor,
                   window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map [N, C, H, W] in plain torch ops, on any device."""
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
    return (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) /
            ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))


def _taps():
    """The window's 11 taps as a host array for the kernels."""
    return (ctypes.c_float * WINDOW)(*_gaussian_window(WINDOW))


def _plane_args(img: torch.Tensor) -> tuple[int, int, int]:
    n, c, h, w = img.shape
    if (h + 15) // 16 >= 1 << 16 or n * c >= 1 << 16:
        raise ValueError(f"the SSIM kernels' grid takes under 2^16 planes "
                         f"and tile rows, got {tuple(img.shape)}")
    return n * c, h, w


def ssim_forward(img1: torch.Tensor, img2: torch.Tensor) -> tuple:
    """SF (``csrc/ssim.cu``) on contiguous f32 [N, C, H, W] CUDA images:
    (map, d_mu1, d_s1, d_s12), the map and its three partials; every
    element written."""
    out = [torch.empty_like(img1) for _ in range(4)]
    f = _build.kernel("ssim", "rain_ssim_forward", (
        _I, _I, _I, _P, _P, _P, _F, _F, _P, _P, _P, _P))
    taps = _taps()
    _build.launch(f, img1.device, *_plane_args(img1), img1.data_ptr(),
                  img2.data_ptr(), ctypes.addressof(taps), C1, C2,
                  *[t.data_ptr() for t in out])
    ssim_map.launches_fwd += 1
    return tuple(out)


def ssim_backward(img1: torch.Tensor, img2: torch.Tensor,
                  d_map: torch.Tensor, partials: tuple) -> torch.Tensor:
    """SB (``csrc/ssim.cu``): the gradient of img1 given the map's
    cotangent d_map and SF's three partials, all contiguous f32
    [N, C, H, W] CUDA tensors; every element written."""
    d_img1 = torch.empty_like(img1)
    f = _build.kernel("ssim", "rain_ssim_backward", (
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P))
    taps = _taps()
    _build.launch(f, img1.device, *_plane_args(img1), img1.data_ptr(),
                  img2.data_ptr(), d_map.data_ptr(),
                  *[t.data_ptr() for t in partials], ctypes.addressof(taps),
                  d_img1.data_ptr())
    ssim_map.launches_bwd += 1
    return d_img1


class _SSIMMap(torch.autograd.Function):
    """``ssim_map`` on CUDA images: SF forward, SB backward. Keeps the two
    images and SF's three partials for the backward."""

    @staticmethod
    def forward(ctx, img1, img2):
        out = ssim_forward(img1, img2)
        ctx.save_for_backward(img1, img2, *out[1:])
        return out[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_map):
        img1, img2, *partials = ctx.saved_tensors
        return ssim_backward(img1, img2, d_map.contiguous(), partials), None


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map [N, C, H, W] of [C, H, W] or [N, C, H, W] images.

    Both images are contiguous f32 tensors of one shape on one device, and
    only img1 may require a gradient. CPU images run ``ssim_map_plain``;
    CUDA images the kernels (see the module docstring), whose window is
    11. Raises ValueError on anything else."""
    if img1.dim() not in (3, 4) or img2.shape != img1.shape:
        raise ValueError(f"ssim_map takes two [C, H, W] or [N, C, H, W] "
                         f"images of one shape, got {tuple(img1.shape)} "
                         f"and {tuple(img2.shape)}")
    for name, t in (("img1", img1), ("img2", img2)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != img1.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {img1.device}, got {t.dtype} on "
                             f"{t.device}, strides {t.stride()}")
    if img2.requires_grad:
        raise ValueError("ssim_map differentiates img1 alone; img2 must "
                         "not require a gradient")
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    dev = img1.device
    if dev.type == "cpu":
        return ssim_map_plain(img1, img2, window_size)
    if dev.type != "cuda" or window_size != WINDOW:
        raise ValueError(f"no SSIM map for window {window_size} on {dev}")
    return _SSIMMap.apply(img1, img2)


ssim_map.launches_fwd = 0
ssim_map.launches_bwd = 0


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


def masked_training_loss(image, gt, real_w, real_h,
                         lambda_dssim: float = 0.2):
    """The training loss of a tile-padded render target.

    image/gt are [3, BH, BW] with the live image in the top-left
    (real_h, real_w) region; gt must be zero beyond it. real_w and real_h
    are ints or 0-d int32 device tensors (rain_tpu's traced sizes). Both
    inputs are zeroed outside the region, which reproduces the SSIM blur's
    zero padding at the real image's border, and the means divide by the
    real pixel count, so the result equals
    ``training_loss(image[:, :h, :w], gt[:, :h, :w])``. Returns (loss, l1).
    """
    bh, bw = image.shape[-2], image.shape[-1]
    dev = image.device
    mask = ((torch.arange(bh, device=dev) < real_h)[:, None] &
            (torch.arange(bw, device=dev) < real_w)[None, :])
    img = image * mask[None]
    gt = gt * mask[None]
    # 3·h·w rounded as the f32 products 3·h, then ·w, on the device. The
    # divisor stays a device tensor: a CUDA tensor divided by a host scalar
    # is multiplied by its reciprocal, which can round another way
    n_pix = (3.0 * device_mod.scalar(real_h, torch.float32, dev)) * \
        device_mod.scalar(real_w, torch.float32, dev)
    ll1 = torch.sum(torch.abs(img - gt)) / n_pix
    # pad pixels have ssim_map == 1 (0/0 regularised): mask before the sum
    sm = ssim_map(img.contiguous(), gt.contiguous())[0]
    ssim_v = torch.sum(sm * mask[None]) / n_pix
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim_v)
    return loss, ll1


def depth_l1(inv_depth, target, mask, real_wh=None):
    """The depth term's L1 (upstream train.py: ``torch.abs((invDepth -
    mono_invdepth) * depth_mask).mean()``): ``inv_depth`` the rendered
    [H, W] inverse depth, ``target`` and ``mask`` [H, W]. With ``real_wh``
    = (w, h) (ints or 0-d int32 device tensors) the images are a tile
    bucket's, ``target`` and ``mask`` zero beyond the true size, and the
    mean is over the true pixels, as ``masked_training_loss``'s."""
    diff = torch.abs((inv_depth - target) * mask)
    if real_wh is None:
        return diff.mean()
    bh, bw = inv_depth.shape[-2], inv_depth.shape[-1]
    dev = inv_depth.device
    region = ((torch.arange(bh, device=dev) < real_wh[1])[:, None] &
              (torch.arange(bw, device=dev) < real_wh[0])[None, :])
    n_pix = device_mod.scalar(real_wh[1], torch.float32, dev) * \
        device_mod.scalar(real_wh[0], torch.float32, dev)
    return torch.sum(diff * region) / n_pix
