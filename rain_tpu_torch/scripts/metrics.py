"""Metrics CLI — port of rain_tpu/scripts/metrics.py, the counterpart of
reference metrics.py:27-84.

Walks <model_path>/test/ours_<iter>/{renders,gt}, computes SSIM/PSNR (and
LPIPS when weights are available) on ``--device``, writes results.json and
per_view.json. PNGs are read with ``data.images`` (no PIL).

Usage: python -m rain_tpu_torch.scripts.metrics -m <model_path> [...]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data import images


def _load_dir(d: Path):
    arrays, names = [], []
    for p in sorted(d.iterdir()):
        arr = np.asarray(images.load_rgb(p), np.float32) / 255.0
        arrays.append(arr.transpose(2, 0, 1))
        names.append(p.name)
    return arrays, names


@torch.no_grad()
def evaluate(model_paths, device=None):
    from rain_tpu_torch.eval.lpips import lpips_fn_or_none
    from rain_tpu_torch.ops import losses

    dev = device_mod.resolve(device)
    lpips_fn = lpips_fn_or_none(log_fn=print, device=dev)
    full, per_view = {}, {}
    for model_path in model_paths:
        model_path = Path(model_path)
        print(f"Scene: {model_path}")
        full[str(model_path)] = {}
        per_view[str(model_path)] = {}
        test_dir = model_path / "test"
        for method_dir in sorted(test_dir.iterdir()):
            renders, names = _load_dir(method_dir / "renders")
            gts, _ = _load_dir(method_dir / "gt")
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(r).to(dev)
                gt = torch.from_numpy(g).to(dev)
                ssims.append(float(losses.ssim(rt, gt)))
                psnrs.append(float(losses.psnr(rt, gt)[0]))
                if lpips_fn is not None:
                    lpipss.append(float(lpips_fn(rt, gt)))
            entry = {"SSIM": float(np.mean(ssims)),
                     "PSNR": float(np.mean(psnrs))}
            pv = {"SSIM": dict(zip(names, map(float, ssims))),
                  "PSNR": dict(zip(names, map(float, psnrs)))}
            if lpipss:
                entry["LPIPS"] = float(np.mean(lpipss))
                pv["LPIPS"] = dict(zip(names, map(float, lpipss)))
            full[str(model_path)][method_dir.name] = entry
            per_view[str(model_path)][method_dir.name] = pv
            print(f"  {method_dir.name}: SSIM {entry['SSIM']:.7f} "
                  f"PSNR {entry['PSNR']:.7f} "
                  f"LPIPS {entry.get('LPIPS', float('nan')):.7f}")
        (model_path / "results.json").write_text(
            json.dumps(full[str(model_path)], indent=True))
        (model_path / "per_view.json").write_text(
            json.dumps(per_view[str(model_path)], indent=True))
    return full


def main(argv=None):
    parser = argparse.ArgumentParser(description="rain-tpu metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to compute on (default: cuda)")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.device)


if __name__ == "__main__":
    main()
