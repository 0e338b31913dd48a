"""Offline render CLI — port of rain_tpu/scripts/render.py, the counterpart
of reference render.py.

Loads a trained model (latest or given iteration PLY snapshot) and renders
every train/test view, saving color, normalized depth, an
inferno-colormapped depth image and the ground truth as PNG (reference
render.py:19-43), with ``data.images`` (no PIL).

Usage: python -m rain_tpu_torch.scripts.render -m <model_path> [-s <scene>]
       [--device cpu]

Views render at rain_tpu's tier, max(8 · n_alive, 262144)
(rain_tpu/scripts/render.py:110). A view whose instances overflow it is
rendered again at the first tier of the Trainer's ladder that holds it,
and logged, where rain_tpu would save the truncated image.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data import images
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train.trainer import render_whole


def _search_max_iteration(folder: Path) -> int:
    """(reference utils/system_utils.py:15-17)."""
    return max(int(p.name.split("_")[-1]) for p in folder.iterdir())


def _save_image(path, arr):
    """arr [3,H,W] or [H,W] in [0,1] → PNG; truncated to uint8, as
    rain_tpu's ``(np.clip(arr, 0, 1) * 255).astype(np.uint8)``."""
    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    images.save_png(path, (np.clip(arr, 0, 1) * 255).astype(np.uint8))


def _inferno(x):
    """Minimal inferno colormap (matplotlib-free)."""
    stops = np.array([
        [0.001, 0.000, 0.014], [0.253, 0.037, 0.407], [0.550, 0.161, 0.506],
        [0.798, 0.280, 0.470], [0.950, 0.533, 0.295], [0.988, 0.809, 0.145],
        [0.988, 0.998, 0.645]])
    x = np.clip(x, 0, 1) * (len(stops) - 1)
    i = np.clip(x.astype(int), 0, len(stops) - 2)
    f = (x - i)[..., None]
    return stops[i] * (1 - f) + stops[i + 1] * f


def render_set(model_path, name, iteration, cameras, state, cfgs,
               max_instances, device, steps):
    """Render and save ``cameras`` through ``steps`` (a
    train.compiled.CompiledStep: one graph per view size and tier on the
    card); returns [(view, tier, re-render tier)] of the views rendered
    again."""
    base = Path(model_path) / name / f"ours_{iteration}"
    bg = torch.tensor([1.0, 1.0, 1.0] if cfgs["model"].white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32,
                      device=device)
    rerenders = []
    for idx, cam in enumerate(cameras):
        out, again = render_whole(
            state, cam.render_inputs(device), bg, 0.3, width=cam.width,
            height=cam.height, sh_degree=cfgs["model"].sh_degree,
            max_instances=max_instances, steps=steps)
        if again is not None:
            rerenders.append((f"{name}/{idx:05d}", max_instances, again))
            print(f"[render] {name} view {idx:05d}: "
                  f"{int(out.num_instances)} instances overflow the tier "
                  f"{max_instances}; rendered again at {again}")
        _save_image(base / "renders" / f"{idx:05d}.png", out.render.cpu())
        depth = out.depth[0].cpu().numpy()
        dmax = depth.max() if depth.max() > 0 else 1.0
        _save_image(base / "depth" / f"{idx:05d}.png", depth / dmax)
        _save_image(base / "depth_inferno" / f"{idx:05d}.png",
                    _inferno(depth / dmax).transpose(2, 0, 1))
        if cam.image is not None:
            _save_image(base / "gt" / f"{idx:05d}.png", cam.image)
    print(f"rendered {len(cameras)} {name} views → {base}")
    return rerenders


def main(argv=None):
    parser = cfg_mod.build_parser("rain-tpu rendering")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--render_only", action="store_true",
                        help="load result.ply from the scene dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)
    device = device_mod.resolve(args.device)

    cfgs = cfg_mod.extract_all(args)
    saved = Path(args.model_path) / "cfg_args.json"
    if saved.exists():
        # full get_combined_args semantics (arguments/__init__.py:82-102):
        # saved config is the base, any explicitly-passed CLI flag wins
        explicit = cfg_mod.explicit_flag_names(argv)
        explicit.add("model_path")  # -m names this run; never the saved one
        cfgs = cfg_mod.merge_saved(cfgs, cfg_mod.load_config(saved),
                                   explicit)
    model = cfgs["model"]

    from rain_tpu_torch.data.dataset import load_scene
    from rain_tpu_torch.train import checkpoint as ckpt

    scene = load_scene(
        model.source_path, images_dir=model.images, eval_split=True,
        num_cams=cfgs["rain"].num_cams, resolution=model.resolution,
        rain_cfg=cfgs["rain"], white_background=model.white_background,
        render_only=args.render_only)

    if args.iteration == -1:
        iteration = _search_max_iteration(
            Path(args.model_path) / "point_cloud")
    else:
        iteration = args.iteration
    ply = (Path(args.model_path) / "point_cloud" /
           f"iteration_{iteration}" / "point_cloud.ply")
    state = ckpt.load_ply_snapshot(ply, max_sh_degree=model.sh_degree,
                                   device=device)
    print(f"loaded {state.n_alive} gaussians from {ply}")
    max_instances = max(state.n_alive * 8, 262144)

    rerenders = []
    steps = compiled.CompiledStep()
    if not args.skip_train:
        rerenders += render_set(args.model_path, "train", iteration,
                                scene.train_cameras, state, cfgs,
                                max_instances, device, steps)
    if not args.skip_test:
        rerenders += render_set(args.model_path, "test", iteration,
                                scene.test_cameras, state, cfgs,
                                max_instances, device, steps)
    return rerenders


if __name__ == "__main__":
    main()
