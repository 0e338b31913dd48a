"""Capacity-growth stress: drive the Trainer to multi-million alive.

Port of tools/sustained_growth.py. Not the production schedule (opacity
resets are off): the run densifies without end through every capacity
growth and instance-tier growth to millions of live Gaussians, at the
rate a user of the Trainer sees. An unfittable noise target keeps the
screen-space gradients above the densify threshold, so the population
grows as fast as the schedule lets it, until the ``max_capacity`` rail
(2,500,000, rounded up to 2,502,656) drops the appends of every later
round.

The scene is the tool's (:36-55), from ``default_rng(seed)``: 262,144
means in bench.py's box, random colours, one uniform-noise image of
1297x840 shared by four cameras at yaw (i - 2) * 0.04; the Trainer's
default configuration with densify rounds from iteration 500 on and
never a last one, no opacity reset, capacity 262,144, instance tier
2^20, ``log_every`` 50 (a loss and population line every 500
iterations), ``max_capacity`` 2,500,000.
After the init (the exact KNN at 262,144 points) every scale is forced to
the log-scale -4.5, as the tool does.

Run:  python -m rain_tpu_torch.scripts.sustained_growth [--iterations 3600]
      [--out DIR] [--device cpu] [--seed 0]

Every log line carries the seconds since the process started; each
capacity growth also gives the peak device memory so far. The closing
[growth] line gives the rate over the whole run, growths, retried steps
and densify rounds included, and the peak device memory. ``--seed`` is
the scene's numpy seed and the Trainer's (the split noise). Like the
port's other entry points it runs on the CUDA card and raises without
one unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.scripts import probe_scale
from rain_tpu_torch.train.trainer import Trainer

N = 262_144
WIDTH, HEIGHT = 1297, 840
ITERATIONS = 3600
LOG_SCALE = -4.5
MAX_INSTANCES = 1 << 20
# the tool's single-card ceiling: the pipelined Trainer holds two state
# generations (the unverified step's input and its output)
MAX_CAPACITY = 2_500_000


def build_scene(seed: int = 0) -> SceneData:
    """The tool's scene (tools/sustained_growth.py:36-55): bench.py's
    arrays (probe_scale.bench_arrays) and four cameras on the target."""
    pts, cols, img = probe_scale.bench_arrays(N, WIDTH, HEIGHT, seed)
    cams = []
    for i in range(4):
        ang = (i - 2) * 0.04
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(Camera(uid=i, image_name=f"c{i}", R=R, T=np.zeros(3),
                           fovx=1.0, fovy=0.7, image=img, width=WIDTH,
                           height=HEIGHT))
    return SceneData(train_cameras=cams, test_cameras=[], points=pts,
                     colors=cols, nerf_radius=5.0,
                     nerf_translate=np.zeros(3))


def configs(iterations: int = ITERATIONS, seed: int = 0) -> dict:
    """The tool's configuration (tools/sustained_growth.py:56-68)."""
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], iterations=iterations, densify_from_iter=500,
        densify_until_iter=10 ** 9, opacity_reset_interval=10 ** 9)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], capacity=N, max_instances=MAX_INSTANCES,
        log_every=50, max_capacity=MAX_CAPACITY, seed=seed)
    return cfgs


def force_scaling(trainer: Trainer, log_scale: float = LOG_SCALE) -> None:
    """Every scale of the trainer's state set to ``log_scale``, as the
    tool sets it after the init (bench-like splat sizes)."""
    st = trainer.state
    trainer.state = st._replace(params=st.params._replace(
        scaling=torch.full_like(st.params.scaling, log_scale)))


def stamped_log(started: float, device: torch.device):
    """A log function that stamps each line with the seconds since
    ``started`` and adds the peak device memory to capacity growths."""
    def log(msg):
        if msg.startswith("[cap] growing capacity") and \
                device.type == "cuda":
            msg += (f"; peak device memory "
                    f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f}"
                    f" MiB")
        print(f"[+{time.time() - started:.2f}s] {msg}", flush=True)
    return log


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--out", type=str, default="output/sustained_growth")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> Trainer:
    args = _parser().parse_args(argv)
    device = device_mod.resolve(args.device)
    started = time.time()
    log = stamped_log(started, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(build_scene(args.seed),
                      configs(args.iterations, args.seed), args.out,
                      device=device, log_fn=log, tensorboard=False)
    force_scaling(trainer)
    t0 = time.time()
    trainer.train(iterations=args.iterations, test_iterations=(),
                  save_iterations=())
    dt = time.time() - t0
    print(f"[growth] {args.iterations} iters in {dt / 60:.1f} min "
          f"({args.iterations / dt:.2f} it/s sustained incl. all growths; "
          f"{dt / args.iterations * 1e3:.2f} ms per iteration); final alive "
          f"{trainer.state.n_alive} capacity {trainer.state.capacity} "
          f"instance tier {trainer.max_instances}" + (
              f"; peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB"
              if device.type == "cuda" else ""), flush=True)
    return trainer


if __name__ == "__main__":
    main()
