"""The long end-to-end run from a sparse init.

Port of tests/test_e2e_long.py (rain_tpu's run gated by
RAIN_TPU_RUN_SLOW=1; its records are docs/runs/e2e_long_tpu_r4.log and
e2e_long_cpu_r3.log). A fresh model is trained for thousands of
iterations against renders of a held-out ground-truth scene, with the
full production schedule: densification grows the population from 150
noisy points to thousands, which forces at least one capacity growth
(Trainer._maybe_grow) and crosses an opacity reset, and the held-out
PSNR is then checked (reference protocol train.py:179-224).

The scene (``gt_scene``, the test's ``_gt_scene``): 2,000 ground-truth
Gaussians in 12 clustered blobs, initialised by ``create_from_pcd`` with
the Morton-window KNN (window 32), rendered from 30 cameras at 96x96
(black background, clipped to [0, 1], tier 65,536); the last 3 cameras
are held out. Training starts from 150 of the ground-truth points with
noise on their positions and colours. The numpy draws are the test's in
the test's order, so one seed gives the same scene in both packages.

The schedule (``configs``): the default configuration with densify
rounds every 100 iterations from 300 to ``iterations`` - 500, an opacity
reset every 1,200, capacity 512, instance tier 131,072, ``log_every``
100; a report at 0 and at the end, a PLY at the end.

Run:  python -m rain_tpu_torch.scripts.e2e_long [--iterations 2500]
      [--out DIR] [--device cpu]

It prints the Trainer's log (each line stamped with the seconds since the
start), the closing ``[e2e]`` line and the record as one JSON line, and
checks the test's five assertions (``check``), raising AssertionError on
the first that fails. Like the port's other entry points it runs on the
CUDA card and raises without one unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.train.trainer import Trainer

N_GAUSS, N_CAMS, SIZE, SEED = 2000, 30, 96, 3
N_INIT = 150
KNN_WINDOW = 32
GT_MAX_INSTANCES = 65536
ITERATIONS = 2500
CAPACITY = 512
MAX_INSTANCES = 131072
# the iteration-0 report as docs/runs/e2e_long_tpu_r4.log:2-3 prints it
# (e2e_long_cpu_r3.log prints the same): (L1, PSNR, SSIM) to 5, 2 and 4
# decimals
LOG_ITER0 = {"test": ("0.02702", "24.22", "0.8591"),
             "train": ("0.03217", "23.54", "0.8218")}
# tests/test_e2e_long.py:115-119
MIN_ALIVE = 1500
MIN_PSNR = 26.0
MIN_PSNR_GAIN = 8.0


@dataclasses.dataclass
class GTScene(SceneData):
    """The training scene, with each ground-truth render's instance count
    and overflow flag (an overflowing render keeps its truncated image,
    as the test's does)."""
    gt_instances: tuple = ()
    gt_overflow: tuple = ()


def gt_cloud(n_gauss=N_GAUSS, seed=SEED):
    """(rng, points [n, 3] f32, colours [n, 3] f32) of the ground truth:
    the test's first draws, in its order; ``rng`` goes on to the init's."""
    rng = np.random.default_rng(seed)
    # clustered structure (harder than uniform noise): a few blobs
    centers = rng.uniform(-0.8, 0.8, (12, 3)) * np.array([1, 1, 0.3]) + \
        np.array([0, 0, 3.8])
    idx = rng.integers(0, len(centers), n_gauss)
    pts = (centers[idx] +
           rng.normal(0, 0.12, (n_gauss, 3))).astype(np.float32)
    cols = rng.uniform(0.05, 0.95, (n_gauss, 3)).astype(np.float32)
    return rng, pts, cols


def gt_camera(i, n_cams=N_CAMS, size=SIZE) -> Camera:
    """Camera ``i`` of the test's arc (no image)."""
    ang = (i / n_cams - 0.5) * 0.8
    tilt = 0.15 * np.sin(i * 2.3)
    Ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)],
                   [0, np.sin(tilt), np.cos(tilt)]])
    return Camera(uid=i, image_name=f"c{i}", R=Ry @ Rx, T=np.zeros(3),
                  fovx=0.9, fovy=0.9, image=None, width=size, height=size)


def gt_state(pts, cols, device=None) -> gmod.GaussianState:
    """The ground-truth state: ``create_from_pcd`` with the KNN window."""
    return gmod.create_from_pcd(pts, cols, sh_degree=3,
                                capacity=pts.shape[0],
                                knn_window=KNN_WINDOW, device=device)


def gt_scene(device=None, n_gauss=N_GAUSS, n_cams=N_CAMS, size=SIZE,
             seed=SEED) -> GTScene:
    """tests/test_e2e_long.py:_gt_scene in the port: the ground truth is
    rendered on ``device`` (default: the CUDA card); the images come back
    as numpy."""
    dev = device_mod.resolve(device)
    rng, pts, cols = gt_cloud(n_gauss, seed)
    state = gt_state(pts, cols, dev)
    scales, quats, opac, shs = gmod.activate(state.params)
    alive = gmod.alive_mask(state)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)

    cams, instances, overflow = [], [], []
    for i in range(n_cams):
        cam = gt_camera(i, n_cams, size)
        with torch.no_grad():
            out = render_ops.render(
                state.params.xyz, scales, quats, opac, shs, alive,
                camera=cam.render_inputs(dev), width=size, height=size,
                sh_degree=3, bg=bg, max_instances=GT_MAX_INSTANCES)
        cam.image = torch.clamp(out.render, 0, 1).cpu().numpy()
        instances.append(int(out.num_instances))
        overflow.append(bool(out.overflow))
        cams.append(cam)

    # sparse noisy init: forces heavy densification to recover detail
    sel = rng.choice(n_gauss, N_INIT, replace=False)
    init_pts = (pts[sel] +
                rng.normal(0, 0.1, (N_INIT, 3))).astype(np.float32)
    init_cols = np.clip(cols[sel] + rng.normal(0, 0.25, (N_INIT, 3)),
                        0, 1).astype(np.float32)
    return GTScene(train_cameras=cams[:-3], test_cameras=cams[-3:],
                   points=init_pts, colors=init_cols,
                   nerf_radius=2.0, nerf_translate=np.zeros(3),
                   gt_instances=tuple(instances),
                   gt_overflow=tuple(overflow))


def configs(iterations: int = ITERATIONS) -> dict:
    """The test's configuration (tests/test_e2e_long.py:85-93)."""
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], iterations=iterations, densify_from_iter=300,
        densification_interval=100, densify_until_iter=iterations - 500,
        opacity_reset_interval=1200)
    # capacity 512 with 150 init points: densification must grow it
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], capacity=CAPACITY, max_instances=MAX_INSTANCES,
        log_every=100)
    return cfgs


def run(scene: SceneData, out: str, *, iterations: int = ITERATIONS,
        stop: int | None = None, device=None, log=print) -> dict:
    """The test's run on ``scene``: a report at 0, then ``iterations``'
    schedule trained up to ``stop`` (default: to its end) with a report
    and a PLY there. Returns the record: both reports, every ``[cap]``
    line with the iteration it came in, the final alive count, capacity
    and instance tier, the wall time, host ms per iteration and, on the
    card, the peak device memory."""
    dev = device_mod.resolve(device)
    stop = iterations if stop is None else stop
    started = time.time()
    cap_events = []
    trainer = None

    def log_fn(msg):
        msg = str(msg)
        if msg.startswith("[cap]"):
            cap_events.append({"iteration": trainer.iteration, "line": msg})
        log(f"[+{time.time() - started:.2f}s] {msg}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(scene, configs(iterations), out, device=dev,
                      log_fn=log_fn, tensorboard=False)
    r0 = trainer.report(0)
    t0 = time.perf_counter()
    trainer.train(iterations=stop, test_iterations=(stop,),
                  save_iterations=(stop,))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    final = trainer.history[-1]
    rec = {
        "device": str(dev), "iterations": iterations, "stop": stop,
        "report0": r0, "final": final,
        "cap_events": cap_events, "n_alive": int(trainer.state.n_alive),
        "capacity": int(trainer.state.capacity),
        "tier": int(trainer.max_instances),
        "ema_loss": float(trainer.ema_loss), "wall_s": wall_s,
        "host_ms_per_iteration": wall_s / stop * 1e3,
        "report_rerenders": trainer.report_rerenders,
        "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                     if dev.type == "cuda" else None)}
    log(f"[e2e] final population {rec['n_alive']} (from "
        f"{scene.points.shape[0]}); capacity {rec['capacity']}; test PSNR "
        f"{r0['test']['psnr']:.2f} -> {final['test']['psnr']:.2f}; "
        f"{stop} iterations in {wall_s:.1f} s "
        f"({rec['host_ms_per_iteration']:.2f} ms per iteration)" +
        (f"; peak device memory {rec['peak_mib']:.0f} MiB"
         if rec["peak_mib"] is not None else ""))
    rec["trainer"] = trainer
    return rec


def check(rec: dict) -> None:
    """The test's five assertions (tests/test_e2e_long.py:115-119), in its
    order; AssertionError on the first that fails."""
    p0, p1 = rec["report0"]["test"]["psnr"], rec["final"]["test"]["psnr"]
    if rec["n_alive"] < MIN_ALIVE:
        raise AssertionError(f"{rec['n_alive']} alive, fewer than "
                             f"{MIN_ALIVE}")
    if not rec["capacity"] > CAPACITY:
        raise AssertionError(f"capacity {rec['capacity']}: no growth past "
                             f"{CAPACITY}")
    if not any("growing capacity" in e["line"] for e in rec["cap_events"]):
        raise AssertionError(f"no capacity growth event: "
                             f"{rec['cap_events']}")
    if not p1 > MIN_PSNR:
        raise AssertionError(f"final test PSNR {p1} not above {MIN_PSNR}")
    if not p1 > p0 + MIN_PSNR_GAIN:
        raise AssertionError(f"final test PSNR {p1} not {MIN_PSNR_GAIN} dB "
                             f"above iteration 0's {p0}")


def units_off(report0: dict) -> dict:
    """How many units of the log's last printed digit each value of an
    iteration-0 report lies from LOG_ITER0, once printed as the log
    prints it: {split: (L1, PSNR, SSIM)}."""
    off = {}
    for split, digits in LOG_ITER0.items():
        r = report0[split]
        off[split] = tuple(
            round(abs(float(f"{v:.{len(d.split('.')[1])}f}") - float(d)) *
                  10 ** len(d.split(".")[1]))
            for v, d in zip((r["l1"], r["psnr"], r["ssim"]), digits))
    return off


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--out", type=str, default="output/e2e_long")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Build the scene, run the schedule, print the record and check the
    test's assertions. Returns the record (its ``trainer`` included)."""
    args = _parser().parse_args(argv)
    device = device_mod.resolve(args.device)
    t = time.perf_counter()
    scene = gt_scene(device)
    scene_s = time.perf_counter() - t
    print(f"[e2e] scene: {N_GAUSS} ground-truth Gaussians, {N_CAMS} views "
          f"of {SIZE}x{SIZE} in {scene_s:.2f} s (instances "
          f"{min(scene.gt_instances)}-{max(scene.gt_instances)}, "
          f"overflow {sum(scene.gt_overflow)}), {N_INIT} init points",
          flush=True)
    rec = run(scene, args.out, iterations=args.iterations, device=device,
              log=lambda m: print(m, flush=True))
    rec["scene_s"] = scene_s
    rec["gt_overflow"] = list(scene.gt_overflow)
    print(json.dumps({k: v for k, v in rec.items() if k != "trainer"},
                     default=str))
    check(rec)
    return rec


if __name__ == "__main__":
    main()
