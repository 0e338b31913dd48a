"""SAM2 automatic part masks for image directories.

Port of rain_tpu/tools/sam2_image_masks.py: a coloured overlay per image,
or every Nth image with one binary mask per part under
<out>/<stem>/NNN.png, as one CLI:

  python -m rain_tpu_torch.tools.sam2_image_masks -i frames/ -o masks/ \\
      --mode binary --every 30 --checkpoint sam2.1_hiera_large.pt \\
      [--device cpu]

SAM2 runs on ``--device``: the CUDA card unless ``--device cpu``, and
without a card the CLI raises before it imports ``sam2``. It needs the
external ``sam2`` package (facebookresearch/sam2) and its weights, and
exits with rain_tpu's message when ``sam2`` does not import. Images are
read with ``data.images.load_rgb`` and written with ``data.images.save``
(PNG without PIL).

One difference from rain_tpu: the overlay of a JPEG input is written as
<stem>.png, since JPEG holds no alpha channel (rain_tpu's PIL save raises
there). Every other overlay keeps the input's name, as in rain_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data import images

EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


def overlay_image(masks, shape):
    """Coloured overlay of masks, biggest first (rain_tpu's
    ``overlay_image``): deterministic colours, float32 [H, W, 4]."""
    img = np.zeros(shape + (4,), np.float32)
    for i, ann in enumerate(sorted(masks, key=lambda m: m["area"],
                                   reverse=True)):
        m = ann["segmentation"]
        color = np.array([(i * 67 % 256) / 255, (i * 131 % 256) / 255,
                          (i * 197 % 256) / 255, 0.5])
        img[m] = color
    return img


def overlay_path(out: Path, name: str) -> Path:
    """Where the overlay of input ``name`` goes: ``out / name``, or
    ``<stem>.png`` for a JPEG input (JPEG holds no alpha)."""
    stem, suffix = os.path.splitext(name)
    if suffix.lower() in (".jpg", ".jpeg"):
        return out / f"{stem}.png"
    return out / name


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--mode", choices=["overlay", "binary"],
                   default="overlay")
    p.add_argument("--every", type=int, default=1,
                   help="process every Nth image (reference multi "
                        "script uses 30)")
    p.add_argument("--min_area", type=int, default=2000)
    p.add_argument("--checkpoint",
                   default="sam2/checkpoints/sam2.1_hiera_large.pt")
    p.add_argument("--model_cfg",
                   default="configs/sam2.1/sam2.1_hiera_l.yaml")
    p.add_argument("--device", default=None,
                   help="torch device of SAM2 (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = device_mod.resolve(args.device)

    try:
        from sam2.automatic_mask_generator import SAM2AutomaticMaskGenerator
        from sam2.build_sam import build_sam2
    except ImportError as e:
        sys.exit(f"sam2 is not installed ({e}); install "
                 "facebookresearch/sam2 to use this tool")

    sam2 = build_sam2(args.model_cfg, args.checkpoint, device=dev,
                      apply_postprocessing=False)
    if args.mode == "overlay":
        gen = SAM2AutomaticMaskGenerator(
            model=sam2, points_per_side=64, points_per_batch=128,
            pred_iou_thresh=0.7, stability_score_thresh=0.92,
            stability_score_offset=0.7, crop_n_layers=1,
            box_nms_thresh=0.7, crop_n_points_downscale_factor=2,
            min_mask_region_area=args.min_area, use_m2m=True)
    else:
        gen = SAM2AutomaticMaskGenerator(sam2)

    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith(EXTS))
    files = [f for i, f in enumerate(files) if i % args.every == 0]
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    for name in files:
        print(os.path.join(args.input_dir, name))
        image = images.load_rgb(os.path.join(args.input_dir, name))
        masks = gen.generate(image)
        stem = os.path.splitext(name)[0]
        if args.mode == "overlay":
            ov = overlay_image(masks, image.shape[:2])
            images.save(overlay_path(out, name),
                        (ov * 255).astype(np.uint8))
        else:
            (out / stem).mkdir(exist_ok=True)
            for i, m in enumerate(masks):
                binary = (m["segmentation"] > 0).astype(np.uint8) * 255
                images.save_png(out / stem / f"{i:03d}.png", binary)


if __name__ == "__main__":
    main()
