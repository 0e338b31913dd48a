"""Composite coloured part-mask overlays onto base renders.

Port of rain_tpu/tools/combine_masks.py: for each frame directory of
binary part masks, alpha-blend a fixed colour per part onto the base
image and stamp the frame name.

  python -m rain_tpu_torch.tools.combine_masks --masks masks/ \\
      --base renders/ --out overlays/ [--device cpu]

The blend (``blend``) runs on ``--device``: the CUDA card unless
``--device cpu``, and without a card it raises. The base image is read
with ``data.images.load_rgb`` and each mask with ``load_grey`` (8-bit
PNGs without PIL). The frame-name stamp and the saved overlay are PIL's,
as in rain_tpu, so the CLI needs PIL; ``blend`` does not.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data import images

DEFAULT_COLORS = {
    "000.png": (255, 0, 0),
    "001.png": (0, 255, 0),
    "002.png": (0, 0, 255),
    "003.png": (255, 255, 0),
}


def blend(base: torch.Tensor, masks, alpha: float) -> torch.Tensor:
    """rain_tpu's blend (rain_tpu/tools/combine_masks.py:49-59) on the
    tensors' device.

    ``base`` is float32 [H, W, 3] with values in [0, 255]; ``masks`` holds
    one float32 [H, W] mask per entry of ``DEFAULT_COLORS``, in its order,
    or None where the frame has no such mask. A mask that is None or has
    no positive value is skipped. Returns float32 [H, W, 3], unclipped.

    255 and ``alpha`` are 0-d tensors on the device: CUDA divides by a
    host scalar through its reciprocal, which rounds unlike numpy's
    division, and the uint8 truncation after the blend turns such an ulp
    into a whole unit.
    """
    dev = base.device
    full = torch.tensor(255.0, device=dev)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    final = base
    for mask, color in zip(masks, DEFAULT_COLORS.values(), strict=True):
        if mask is None or not bool((mask > 0).any()):
            continue
        unit = mask / full
        color_img = unit[..., None] * torch.tensor(
            color, dtype=torch.float32, device=dev)
        a = (unit * alpha_t)[..., None]
        final = (1 - a) * final + a * color_img
    return final


def _pil_draw():
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        raise RuntimeError("combine_masks: stamping the frame name needs "
                           "PIL, which does not import here") from None
    return Image, ImageDraw


def main(argv=None) -> dict:
    """The CLI; returns {"device": the blend's device, "overlays": count}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--masks", required=True,
                   help="dir of per-frame subdirs of binary masks")
    p.add_argument("--base", required=True,
                   help="dir of base images named <frame>.png")
    p.add_argument("--out", required=True)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="torch device of the blend (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = device_mod.resolve(args.device)
    Image, ImageDraw = _pil_draw()

    frame_dirs = sorted(d for d in os.listdir(args.masks)
                        if os.path.isdir(os.path.join(args.masks, d)))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    for frame in frame_dirs:
        base = images.load_rgb(Path(args.base) / f"{frame}.png")
        masks = []
        for mask_name in DEFAULT_COLORS:
            mp = Path(args.masks) / frame / mask_name
            masks.append(torch.from_numpy(
                images.load_grey(mp).astype(np.float32)).to(dev)
                if mp.exists() else None)
        final = blend(torch.from_numpy(base.astype(np.float32)).to(dev),
                      masks, args.alpha)
        img = Image.fromarray(
            final.clamp(0, 255).to(torch.uint8).cpu().numpy())
        draw = ImageDraw.Draw(img)
        tw = draw.textlength(frame)
        draw.text((img.width - tw - 10, 10), frame, fill=(255, 0, 0))
        img.save(out / f"{frame}.png")
    print(f"wrote {len(frame_dirs)} overlays to {out}")
    return {"device": str(dev), "overlays": len(frame_dirs)}


if __name__ == "__main__":
    main()
