"""The full 30k-iteration production-schedule run, on the port's Trainer.

Port of tools/run_production_30k.py. The reference's primary artifact is
a complete 30k-iteration garden training (train.py:24-151; budget
arguments/__init__.py:63-78): densify 500→15k every 100 iterations,
opacity reset every 3k, the c2f low-pass, the SH-degree schedule, evals
at 1k/3k/7k/15k/22.5k/30k and checkpoints every 2k. With no Mip-NeRF-360
data at hand, the run builds the same stand-in as the tool, from the same
numpy seeds, and trains it with rain_tpu_torch.train.trainer.Trainer:

- a procedural "garden" target of 600,000 Gaussians (ground disk, bushes,
  trunks; spatial colour fields plus per-splat noise) at garden's
  images_4 resolution (1297x840);
- 60 train and 6 test views on a ring, their ground truth RENDERED from
  the target with the port's eval_render (SH degree 3, opacity logit 1.2,
  an instance tier of 4,194,304; any overflow raises), so the held-out
  PSNR curve measures real multi-view optimisation;
- an SfM-like init of 150,000 target points with noise.

Run:  python -m rain_tpu_torch.scripts.production_30k [out_dir]
      [--ring_radius 8.0] [--target_scale_shift 0.0] [--device cpu]

It resumes from the newest chkpnt*.npz in out_dir (by iteration number),
so the run can be taken in segments. The scene and schedule flags below
the first two exist to cut the run for checks; their defaults are the
tool's. Each line of the log carries the seconds since the process
started ("[+12.34s]"), so the time between any two logged
iterations can be read off the log. The closing [done] line gives the
rate over the iterations this process ran (the tool divides 30,000 by
the time of a possibly resumed process) and, on the card, the peak
device memory. Like the port's other CLIs it runs on the CUDA card and
raises without one unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops.sh import rgb_to_sh_dc
from rain_tpu_torch.train import step as step_mod
from rain_tpu_torch.train.trainer import Trainer

SEED = 11
TARGET_N = 600_000
WIDTH, HEIGHT = 1297, 840
N_TRAIN, N_TEST = 60, 6
INIT_N = 150_000
# the camera ring radius and a log-shift of every target scale: together
# they set where the model's splat sizes land relative to the schedule's
# 20 px size prune and percent_dense split boundaries
RING_RADIUS = 8.0
TARGET_SCALE_SHIFT = 0.0
GT_MAX_INSTANCES = 4_194_304
GT_OPACITY = 1.2                     # sigmoid → 0.77
ITERATIONS = 30_000
TEST_ITERATIONS = (1000, 3000, 7000, 15000, 22500, 30000)
SAVE_ITERATIONS = (7000, 30000)
CHECKPOINT_EVERY = 2000


def _color_field(pts, rng):
    """Spatially structured multi-octave colour field (not iid noise: an
    iid-coloured sub-pixel target composites to unfittable pixel noise,
    and the production schedule then prunes the whole model after the
    first opacity reset)."""
    n = pts.shape[0]
    cols = np.empty((n, 3), np.float32)
    # wavelengths from ~5 world units down to ~0.1 (≈15 px at the ring
    # distance): the finest octaves sit at or below the model's splat
    # scale, so resolving them takes densification
    freqs = [(1.3, 0.9, 1.1), (4.1, 3.7, 3.3), (11.0, 9.0, 10.0),
             (27.0, 23.0, 25.0), (61.0, 53.0, 57.0)]
    amps = [0.22, 0.15, 0.11, 0.10, 0.09]
    for ch in range(3):
        v = 0.47 + 0.05 * ch
        for (fx, fy, fz), a in zip(freqs, amps):
            ph = rng.uniform(0, 2 * np.pi, 3)
            v = v + a * np.sin(fx * pts[:, 0] + ph[0]) * \
                np.sin(fy * pts[:, 1] + ph[1]) * \
                np.sin(fz * pts[:, 2] + ph[2])
        cols[:, ch] = v
    return cols


def build_target(rng, target_n=TARGET_N, scale_shift=TARGET_SCALE_SHIFT):
    """Procedural garden-like target: positions, colours, log-scales.

    Splats of 2-6 px at the ring distance, ~1-2 per pixel footprint, with
    locally coherent colours, so the target can be fitted and refining it
    rewards more, smaller splats: the regime the reference's densification
    schedule is built for."""
    n = target_n
    n_ground = n // 4
    n_trunk = n // 20
    n_bush = n - n_ground - n_trunk

    r = np.sqrt(rng.uniform(0, 1, n_ground)) * 6.0
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th),
                       -1.2 + 0.08 * np.sin(3 * th) * r / 6 +
                       rng.normal(0, 0.015, n_ground),
                       r * np.sin(th)], 1)

    n_clusters = 48
    centers = np.stack([rng.uniform(-4.5, 4.5, n_clusters),
                        rng.uniform(-0.9, 0.9, n_clusters),
                        rng.uniform(-4.5, 4.5, n_clusters)], 1)
    sizes = rng.uniform(0.25, 0.9, n_clusters)
    ci = rng.integers(0, n_clusters, n_bush)
    bush = centers[ci] + rng.normal(0, 1.0, (n_bush, 3)) * \
        sizes[ci][:, None] * rng.uniform(0.25, 1.0, (n_bush, 1))

    ti = rng.integers(0, n_clusters, n_trunk)
    h = rng.uniform(0, 1, n_trunk)
    trunk = np.stack([
        centers[ti, 0] + rng.normal(0, 0.03, n_trunk),
        -1.2 + h * (centers[ti, 1] + 1.2),
        centers[ti, 2] + rng.normal(0, 0.03, n_trunk)], 1)

    pts = np.concatenate([ground, bush, trunk]).astype(np.float32)

    tint = np.zeros((n, 3), np.float32)
    tint[:n_ground] = [0.1, 0.06, 0.02]                     # earthy ground
    tint[n_ground:n_ground + n_bush] = [-0.1, 0.12, -0.08]  # leafy bushes
    tint[n_ground + n_bush:] = [0.05, -0.02, -0.1]          # brown trunks
    # per-splat jitter at target-splat (2-3 px) granularity: the photo-like
    # texture floor that keeps densification selecting
    cols = np.clip(_color_field(pts, rng) + tint +
                   rng.normal(0, 0.12, (n, 3)), 0.02, 0.98
                   ).astype(np.float32)

    # 2-3 px splats (80 %) and 5-8 px washes (20 %) at the ring distance
    log_scale = np.where(rng.uniform(0, 1, n) < 0.8,
                         rng.normal(-4.1, 0.25, n),
                         rng.normal(-3.3, 0.3, n)).astype(np.float32)
    log_scale = log_scale + scale_shift
    return pts, cols, np.repeat(log_scale[:, None], 3, axis=1)


def look_at_colmap(eye, target):
    """COLMAP-convention (x right, y down, z forward) pose → (R, T) as
    data.cameras.Camera expects (R = C2W rotation, T = W2C translation)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    right = np.cross(f, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    down /= np.linalg.norm(down)
    R_w2c = np.stack([right, down, f])
    return R_w2c.T.astype(np.float32), (-R_w2c @ eye).astype(np.float32)


def build_cameras(rng, n_train=N_TRAIN, n_test=N_TEST, width=WIDTH,
                  height=HEIGHT, ring_radius=RING_RADIUS):
    """The ring of views, split every-Nth into (train, test) as the
    reference does (dataset_readers.py:133-140)."""
    cams = []
    n_total = n_train + n_test
    for i in range(n_total):
        ang = 2 * np.pi * i / n_total + rng.uniform(-0.02, 0.02)
        rad = ring_radius + 1.2 * np.sin(3 * ang)
        eye = np.array([rad * np.cos(ang),
                        1.4 + 0.9 * np.sin(2 * ang + 1.0),
                        rad * np.sin(ang)])
        R, T = look_at_colmap(eye, np.array([0.0, -0.4, 0.0]))
        cams.append(Camera(uid=i, image_name=f"view_{i:03d}", R=R, T=T,
                           fovx=1.0, fovy=0.7, image=None,
                           width=width, height=height))
    step = n_total // n_test
    test = [c for i, c in enumerate(cams) if i % step == 0][:n_test]
    test_ids = {id(c) for c in test}
    train = [c for c in cams if id(c) not in test_ids]
    return train, test


class ProductionScene(NamedTuple):
    """The seeded scene: the target, the cameras (no images yet) and the
    SfM-like init."""

    pts: np.ndarray              # [T, 3] target means
    cols: np.ndarray             # [T, 3] target colours
    log_scales: np.ndarray       # [T, 3]
    train_cameras: list
    test_cameras: list
    init_pts: np.ndarray         # [I, 3]
    init_cols: np.ndarray        # [I, 3]


def build_scene(seed=SEED, target_n=TARGET_N, width=WIDTH, height=HEIGHT,
                n_train=N_TRAIN, n_test=N_TEST, init_n=INIT_N,
                ring_radius=RING_RADIUS, scale_shift=TARGET_SCALE_SHIFT
                ) -> ProductionScene:
    """The tool's numpy stream from ``default_rng(seed)``: the target, the
    cameras, then the init subsample and its noise (garden's COLMAP
    sparse cloud has ~138k points). The defaults are the tool's."""
    rng = np.random.default_rng(seed)
    pts, cols, log_scales = build_target(rng, target_n, scale_shift)
    train, test = build_cameras(rng, n_train, n_test, width, height,
                                ring_radius)
    sel = rng.choice(pts.shape[0], init_n, replace=False)
    init_pts = pts[sel] + rng.normal(0, 0.01, (init_n, 3)).astype(np.float32)
    init_cols = np.clip(cols[sel] + rng.normal(0, 0.05, (init_n, 3)),
                        0, 1).astype(np.float32)
    return ProductionScene(pts, cols, log_scales, train, test, init_pts,
                           init_cols)


@torch.no_grad()
def render_targets(cams, pts, cols, log_scales, *, device=None,
                   max_instances=GT_MAX_INSTANCES, log_fn=print):
    """The ground truth of every camera: eval_render of the target (SH
    degree 3 with zero rest coefficients, opacity logit 1.2, black
    background), clipped to [0, 1]. Raises RuntimeError on any overflow of
    ``max_instances`` and on a blank view 0. Returns ([3, H, W] float32
    images, the instance count of each view)."""
    dev = device_mod.resolve(device)
    n = pts.shape[0]
    state = gmod.from_arrays(
        xyz=pts, f_dc=rgb_to_sh_dc(cols)[:, None, :],
        f_rest=np.zeros((n, 15, 3), np.float32), scaling=log_scales,
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n, 1), GT_OPACITY, np.float32), capacity=n,
        device=dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    images, instances = [], []
    t0 = time.time()
    for i, cam in enumerate(cams):
        out = step_mod.eval_render(
            state, cam.render_inputs(dev), bg, 0.3, width=cam.width,
            height=cam.height, sh_degree=3, max_instances=max_instances)
        if bool(out.overflow):
            raise RuntimeError(f"target render overflow at view {i} "
                               f"({int(out.num_instances)} instances > "
                               f"{max_instances})")
        img = torch.clamp(out.render, 0.0, 1.0).cpu().numpy()
        images.append(img.astype(np.float32))
        instances.append(int(out.num_instances))
        if i == 0:
            if not img.std() > 0.05:
                raise RuntimeError("target render is blank")
            log_fn(f"[gt] view0 mean {img.mean():.3f} std {img.std():.3f} "
                   f"instances {instances[0]}")
    log_fn(f"[gt] rendered {len(cams)} target views in "
           f"{time.time() - t0:.0f}s")
    return images, instances


def newest_checkpoint(out_dir) -> Path | None:
    """The chkpnt*.npz in ``out_dir`` with the highest iteration number."""
    found = sorted(Path(out_dir).glob("chkpnt*.npz"),
                   key=lambda p: int(re.findall(r"\d+", p.name)[-1]))
    return found[-1] if found else None


class ProductionRun(NamedTuple):
    trainer: Trainer
    gt_instances: list           # instances of each target view
    gt_seconds: float            # the target renders
    first_iteration: int         # the checkpoint's iteration, 0 if fresh
    train_seconds: float         # Trainer.train


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="output/production_30k")
    p.add_argument("--ring_radius", type=float, default=RING_RADIUS)
    p.add_argument("--target_scale_shift", type=float,
                   default=TARGET_SCALE_SHIFT)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    # cuts of the run for checks; the defaults are the tool's
    p.add_argument("--target_n", type=int, default=TARGET_N)
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_test", type=int, default=N_TEST)
    p.add_argument("--init_n", type=int, default=INIT_N)
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--test_iterations", nargs="*", type=int,
                   default=list(TEST_ITERATIONS))
    p.add_argument("--save_iterations", nargs="*", type=int,
                   default=list(SAVE_ITERATIONS))
    p.add_argument("--checkpoint_iterations", nargs="*", type=int,
                   default=None, help=f"default: every {CHECKPOINT_EVERY}")
    p.add_argument("--profile_steps", type=str, default="",
                   help="A-B: a torch.profiler trace of those iterations "
                        "(the Trainer's system.profile_steps)")
    return p


def main(argv=None) -> ProductionRun:
    args = _parser().parse_args(argv)
    device = device_mod.resolve(args.device)
    started = time.time()

    def log(msg):
        print(f"[+{time.time() - started:.2f}s] {msg}", flush=True)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    sc = build_scene(SEED, args.target_n, args.width, args.height,
                     args.n_train, args.n_test, args.init_n,
                     args.ring_radius, args.target_scale_shift)
    cams = sc.train_cameras + sc.test_cameras
    t0 = time.time()
    images, gt_instances = render_targets(cams, sc.pts, sc.cols,
                                          sc.log_scales, device=device,
                                          log_fn=log)
    gt_seconds = time.time() - t0
    for cam, img in zip(cams, images):
        cam.image = img
    scene = SceneData(train_cameras=sc.train_cameras,
                      test_cameras=sc.test_cameras, points=sc.init_pts,
                      colors=sc.init_cols,
                      nerf_radius=args.ring_radius * 1.15,
                      nerf_translate=np.zeros(3))

    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("production")
                               .parse_args([]))
    # the reference production budget (arguments/__init__.py:63-78) plus
    # c2f (RAIN-GS), as scripts/train.py would set them
    cfgs["rain"] = dataclasses.replace(
        cfgs["rain"], c2f=True, c2f_every_step=1000.0,
        c2f_max_lowpass=300.0)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], log_every=50, max_capacity=1 << 23,
        profile_steps=args.profile_steps)

    trainer = Trainer(scene, cfgs, str(out_dir), device=device, log_fn=log)
    start = newest_checkpoint(out_dir)
    first = 0
    if start is not None:
        with np.load(start) as z:
            first = int(z["iteration"])
        log(f"[resume] from {start}")
    checkpoints = args.checkpoint_iterations
    if checkpoints is None:
        checkpoints = range(CHECKPOINT_EVERY, args.iterations + 1,
                            CHECKPOINT_EVERY)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    trainer.train(
        iterations=args.iterations,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(checkpoints),
        start_checkpoint=str(start) if start is not None else None)
    dt = time.time() - t0
    last = max(trainer.iteration, first)
    ran = last - first
    print(f"\n[done] {args.iterations}-iteration production schedule "
          f"complete; this process ran iterations {first + 1}-{last} "
          f"in {dt / 3600:.2f} h "
          f"({ran / max(dt, 1e-9):.2f} it/s); final population "
          f"{trainer.state.n_alive} capacity {trainer.state.capacity} "
          f"instance tier {trainer.max_instances}" + (
              f"; peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB"
              if device.type == "cuda" else ""), flush=True)
    return ProductionRun(trainer, gt_instances, gt_seconds, first, dt)


if __name__ == "__main__":
    main()
