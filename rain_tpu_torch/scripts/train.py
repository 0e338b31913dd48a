"""Training CLI — port of rain_tpu/scripts/train.py, the counterpart of
reference train.py:226-296.

Usage: python -m rain_tpu_torch.scripts.train -s <scene> [--ours_new ...]
       [--device cpu]

The flags are rain_tpu's (``config.build_parser``) plus ``--device``
(default: the CUDA card; without one it raises unless ``--device cpu``).
``--device`` is not part of the configuration, so ``cfg_args.json`` keeps
rain_tpu's keys and a configuration saved by either package loads in the
other. One device only: ``--devices`` other than 1 raises (ROADMAP A.6).
"""

from __future__ import annotations

import json
import os
import sys
import uuid
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod


def main(argv=None):
    parser = cfg_mod.build_parser("rain-tpu training")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[30000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="./output/")
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--white_bg", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--viewer", action="store_true",
                        help="serve the SIBR live viewer")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)
    device = device_mod.resolve(args.device)
    args.white_background = args.white_background or args.white_bg
    args.save_iterations = list(args.save_iterations) + [args.iterations]

    cfgs = cfg_mod.extract_all(args)
    cfgs = cfg_mod.apply_method_presets(cfgs, args.source_path)
    model = cfgs["model"]
    rain = cfgs["rain"]

    # output dir resolution (train.py:154-169)
    if model.model_path:
        model_path = model.model_path
    elif args.exp_name:
        model_path = os.path.join(args.output_path, args.exp_name)
    else:
        model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    print(f"Output folder: {model_path}")
    Path(model_path).mkdir(parents=True, exist_ok=True)
    cfg_mod.save_config(cfgs, Path(model_path) / "cfg_args.json")
    (Path(model_path) / "command_line.txt").write_text(" ".join(sys.argv))

    from rain_tpu_torch.data import ply
    from rain_tpu_torch.data.cameras import fov2focal
    from rain_tpu_torch.data.dataset import load_scene
    from rain_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(cfgs["system"].seed)
    scene = load_scene(
        model.source_path,
        images_dir=model.images,
        eval_split=True,                       # train.py:261 forces eval
        num_cams=rain.num_cams,
        resolution=model.resolution,
        rain_cfg=rain,
        white_background=model.white_background,
        rng=rng)
    print(f"cameras: {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} test; "
          f"init points: {scene.points.shape[0]}")

    # provenance files (reference scene/__init__.py:36-55): the input point
    # cloud and the camera poses used for this run
    ply.write_point_cloud(Path(model_path) / "input.ply", scene.points,
                          scene.colors * 255.0)
    cam_entries = []
    for cid, cam in enumerate(scene.test_cameras + scene.train_cameras):
        W2C = np.linalg.inv(cam.world_view)
        cam_entries.append({
            "id": cid, "img_name": cam.image_name,
            "width": cam.width, "height": cam.height,
            "position": W2C[:3, 3].tolist(),
            "rotation": [r.tolist() for r in W2C[:3, :3]],
            "fy": fov2focal(cam.fovy, cam.height),
            "fx": fov2focal(cam.fovx, cam.width)})
    (Path(model_path) / "cameras.json").write_text(json.dumps(cam_entries))

    viewer = None
    if args.viewer:
        from rain_tpu_torch.viewer.network_gui import NetworkGUI
        viewer = NetworkGUI(args.ip, args.port)
        print(f"GUI server started at {viewer.host}:{viewer.port}")
    # --quiet: counterpart of reference safe_state(args.quiet)
    # (utils/general_utils.py:86-90) — silence progress logging; file
    # artifacts (log_file.txt, TB, checkpoints) are still written
    log_fn = (lambda *a, **k: None) if args.quiet else print
    trainer = Trainer(scene, cfgs, model_path, device=device, viewer=viewer,
                      log_fn=log_fn)
    # --detect_anomaly (reference train.py:234,295): autograd raises at the
    # first backward op that yields a NaN, with the forward op's traceback
    with torch.autograd.set_detect_anomaly(cfgs["pipeline"].detect_anomaly):
        trainer.train(
            iterations=cfgs["opt"].iterations,
            test_iterations=tuple(args.test_iterations),
            save_iterations=tuple(args.save_iterations),
            checkpoint_iterations=tuple(args.checkpoint_iterations),
            start_checkpoint=args.start_checkpoint)
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
