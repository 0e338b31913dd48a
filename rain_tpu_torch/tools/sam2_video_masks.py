"""SAM2 part-mask extraction over a frame sequence.

Port of rain_tpu/tools/sam2_video_masks.py: automatic mask generation on
the first frame, each auto-mask registered as a tracked object, masks
propagated through the video, per-frame binary masks saved as
<out>/frame_NNNN/mask_MM.png plus an overview image (all.jpg) per frame
and an mp4 of the overviews (with cv2, as rain_tpu gates it):

  python -m rain_tpu_torch.tools.sam2_video_masks --video_path frames/ \\
      --out masks/ --checkpoint sam2_hiera_large.pt [--device cpu]

SAM2 and the masks' down-sampling run on ``--device``: the CUDA card
unless ``--device cpu``, and without a card the CLI raises before it
imports ``sam2``. It needs the external ``sam2`` package
(facebookresearch/sam2) and its weights, and exits with rain_tpu's
message when ``sam2`` does not import. Frames are read with
``data.images.load_rgb`` and the masks written with
``data.images.save_png``; the JPEG overviews need PIL.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data import images


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_path", required=True,
                   help="directory of frames named NNN.jpg/png")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="sam2 checkpoint .pt")
    p.add_argument("--model_cfg", default="sam2_hiera_l.yaml")
    p.add_argument("--min_area", type=int, default=500)
    p.add_argument("--device", default=None,
                   help="torch device of SAM2 (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = device_mod.resolve(args.device)

    try:
        from sam2.automatic_mask_generator import SAM2AutomaticMaskGenerator
        from sam2.build_sam import build_sam2, build_sam2_video_predictor
    except ImportError as e:
        sys.exit(f"sam2 is not installed ({e}); install "
                 "facebookresearch/sam2 to use this tool")

    frames = sorted(
        [f for f in os.listdir(args.video_path)
         if f.lower().endswith((".jpg", ".jpeg", ".png"))],
        key=lambda q: int(os.path.splitext(q)[0]))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # auto-mask the first frame
    sam2 = build_sam2(args.model_cfg, args.checkpoint, device=dev,
                      apply_postprocessing=False)
    first = images.load_rgb(Path(args.video_path) / frames[0])
    gen = SAM2AutomaticMaskGenerator(
        model=sam2, points_per_side=64, points_per_batch=128,
        pred_iou_thresh=0.7, stability_score_thresh=0.92,
        stability_score_offset=0.7, crop_n_layers=1, box_nms_thresh=0.7,
        crop_n_points_downscale_factor=2,
        min_mask_region_area=args.min_area, use_m2m=True)
    auto_masks = gen.generate(first)
    print(f"Number of auto-masks: {len(auto_masks)}")

    # masks → video-tracking prompts at a quarter of SAM2's input size
    predictor = build_sam2_video_predictor(args.model_cfg, args.checkpoint,
                                           device=dev)
    state = predictor.init_state(video_path=args.video_path)
    dtype = next(predictor.parameters()).dtype
    lowres = predictor.image_size // 4
    for idx, m in enumerate(auto_masks):
        t = torch.tensor(m["segmentation"], dtype=dtype, device=dev)
        lm = torch.nn.functional.interpolate(
            t[None, None], size=(lowres, lowres), mode="bilinear",
            align_corners=False).squeeze()
        predictor.add_new_mask(inference_state=state, frame_idx=0,
                               obj_id=idx, mask=lm)

    # propagate
    segments = {}
    for fidx, obj_ids, logits in predictor.propagate_in_video(state):
        segments[fidx] = {
            oid: (logits[i] > 0.0).cpu().numpy()
            for i, oid in enumerate(obj_ids)}

    # per-frame binary masks and an overview
    overview_paths = []
    for fidx in range(len(segments)):
        fdir = out / f"frame_{fidx:04d}"
        fdir.mkdir(exist_ok=True)
        overlay = None
        for oid, mask in segments[fidx].items():
            binary = (mask > 0).astype(np.uint8) * 255
            images.save_png(fdir / f"mask_{oid:02d}.png", binary[0])
            color = np.array([(oid * 67) % 255, (oid * 131) % 255,
                              (oid * 197) % 255], np.uint8)
            if overlay is None:
                overlay = np.zeros(binary[0].shape + (3,), np.uint8)
            overlay[binary[0] > 0] = color
        if overlay is not None:
            path = fdir / "all.jpg"
            images.save(path, overlay)
            overview_paths.append(path)

    _write_mp4(out, overview_paths)


def _write_mp4(out: Path, frame_paths, fps: int = 30):
    """The overviews as <out>/<out.name>.mp4; skipped without cv2."""
    if not frame_paths:
        return
    try:
        import cv2
    except ImportError:
        print("cv2 not available; skipping mp4")
        return
    first = cv2.imread(str(frame_paths[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(str(out / f"{out.name}.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frame_paths:
        vw.write(cv2.imread(str(f)))
    vw.release()
    print(f"Video saved to {out / (out.name + '.mp4')}")


if __name__ == "__main__":
    main()
