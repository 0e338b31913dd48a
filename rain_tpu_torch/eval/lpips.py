"""LPIPS perceptual metric: VGG16 feature distance with linear heads.

Port of rain_tpu/eval/lpips.py, the counterpart of the reference
lpipsPyTorch/ package (modules/lpips.py, modules/networks.py:62-96):
normalized VGG16 conv features at the 5 relu block outputs,
channel-normalized, squared difference, 1x1 linear heads, spatial mean,
summed over layers. The 13 convolutions are ``F.conv2d`` and the pools
``F.max_pool2d``, in f32 (TF32 is off, rain_tpu_torch/__init__.py).

Weights: the reference downloads torchvision VGG16 + LPIPS linear weights
at run time (modules/utils.py:11-28). Nothing is downloaded here: they are
loaded from local files when present, and the metric is cleanly
unavailable otherwise:
  $RAIN_TPU_LPIPS_VGG    — torchvision vgg16 state_dict (.pth)
  $RAIN_TPU_LPIPS_LIN    — LPIPS 'vgg' linear weights state_dict (.pth)
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from rain_tpu_torch import device as device_mod

VGG_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))
# torchvision vgg16.features conv layer indices
VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
POOL_IDX = (4, 9, 16, 23)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _load_state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@functools.cache
def _load_weights():
    vgg_path = os.environ.get("RAIN_TPU_LPIPS_VGG")
    lin_path = os.environ.get("RAIN_TPU_LPIPS_LIN")
    if not vgg_path or not os.path.exists(vgg_path):
        return None
    vgg = _load_state(vgg_path)
    convs = [(vgg[f"features.{i}.weight"], vgg[f"features.{i}.bias"])
             for i in VGG_CONV_IDX]
    lins = None
    if lin_path and os.path.exists(lin_path):
        lin = _load_state(lin_path)
        lins = [lin[k] for k in sorted(lin.keys()) if k.endswith("weight")]
    return convs, lins


# the warning of a missing metric is printed once per process
_warned = False


def lpips_fn_or_none(log_fn=None, device=None):
    """lpips(img1, img2) over [3,H,W] tensors in [0,1] on ``device``
    (default: the CUDA card), or None if the weights are unavailable. When
    None and ``log_fn`` is given, emits a one-line warning (once per
    process) so that the LPIPS key missing from results.json and the
    reports is explained — the reference always has the metric because it
    downloads weights at run time (lpipsPyTorch/modules/utils.py:11-28)."""
    global _warned
    weights = _load_weights()
    if weights is None:
        if log_fn is not None and not _warned:
            _warned = True
            log_fn("[lpips] VGG weights unavailable (set "
                   "RAIN_TPU_LPIPS_VGG / RAIN_TPU_LPIPS_LIN) — LPIPS "
                   "will be omitted from reports and results.json")
        return None
    convs, lins = weights
    return make_lpips(convs, lins, device=device)


def make_lpips(convs, lins, device=None):
    """Build lpips(img1, img2) from explicit weights on ``device``
    (default: the CUDA card).

    convs: 13 (weight [O,I,3,3], bias [O]) pairs for torchvision
      vgg16.features conv layers; lins: 5 [1,C,1,1] linear-head weights
      (or None → channel mean); arrays or tensors. Inputs are [3,H,W]
      tensors; the reference feeds its [0,1] tensors straight into the
      z-score normalization (lpipsPyTorch/modules/networks.py
      BaseNet.forward — no [-1,1] rescale), so we do the same. Returns a
      0-d tensor.
    """
    dev = device_mod.resolve(device)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    conv_params = [(put(w), put(b)) for w, b in convs]
    lin_params = [put(w) for w in lins] if lins else None
    shift = put(SHIFT)[:, None, None]
    scale = put(SCALE)[:, None, None]

    def features(img):
        # z_score (networks.py:49-50): applied to the caller's [0,1]
        # image directly, matching the reference call sites
        # (train.py:198, metrics.py:70)
        x = ((img - shift) / scale)[None]
        feats = []
        ci = 0
        layer = 0
        for _, hi in VGG_SLICES:
            while layer < hi:
                if layer in VGG_CONV_IDX:
                    w, b = conv_params[ci]
                    x = F.relu(F.conv2d(x, w, b, padding=1))
                    ci += 1
                elif layer in POOL_IDX:
                    x = F.max_pool2d(x, 2, 2)
                layer += 1
            feats.append(x)
        return feats

    @torch.no_grad()
    def lpips(img1, img2):
        total = 0.0
        for li, (a, b) in enumerate(zip(features(img1), features(img2))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            if lin_params is not None:
                d = torch.einsum("nchw,oc->nohw", d,
                                 lin_params[li][:, :, 0, 0])
            else:
                d = d.mean(dim=1, keepdim=True)
            total = total + d.mean()
        return total

    return lpips
