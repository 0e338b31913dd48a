"""Micro-benchmark: the compositor's kernels alone at the garden-proxy shape.

Port of tools/profiling/composite_micro.py: kernels B3
(``tile_render.composite_forward``) and B4 (``composite_backward``) on the
sorted pack of bench.py's 262k scene (scripts/probe_scale.py:
build_tier_state, log-scale -4.5) from bench.py's camera at 1297x840,
with an instance tier of 2^20 and, for B4, a cotangent of ones. The pack
and tile ranges are those ``eval_render`` hands the compositor (its
``on_stage`` hook).

Run:  python -m rain_tpu_torch.scripts.composite_micro [--reps 20]
      [--device cpu]

On the card each kernel is timed with CUDA events around ``reps``
back-to-back calls after a warm-up; with --device cpu the plain versions
run, timed on the host clock. The tool's RAIN_TPU_TILE_BATCH (tiles per
grid step of the Pallas compositor) has no counterpart here: B3 and B4
run one 16x16 tile per block, and the port has no such knob, like
rain_tpu's RAIN_TPU_CHUNK (the compositor's DMA chunk). Like the port's
other entry points it runs on the CUDA card and raises without one
unless --device cpu.
"""

from __future__ import annotations

import argparse
import time

import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.scripts import probe_scale
from rain_tpu_torch.train import step as step_mod

N = 262_144
MAX_INSTANCES = 1 << 20
LOG_SCALE = -4.5


def _time_ms(fn, reps: int, dev) -> float:
    """ms per call of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    ts = probe_scale.build_tier_state(N, LOG_SCALE, device=dev)
    width, height = probe_scale.WIDTH, probe_scale.HEIGHT
    seen = {}
    out = step_mod.eval_render(
        ts.state, ts.camera, ts.bg, probe_scale.LOW_PASS, width=width,
        height=height, sh_degree=probe_scale.SH_DEGREE,
        max_instances=MAX_INSTANCES, on_stage=seen.__setitem__)
    grid_x = (width + 15) // 16
    pack = seen["tile_sort_gather"]
    starts, ends = seen["tile_ranges"]
    tiles = seen["composite_B3"]
    g_tiles = torch.ones_like(tiles)
    rec = {"instances": int(out.num_instances),
           "overflow": bool(out.overflow), "tiles": starts.shape[0],
           "max_instances": MAX_INSTANCES, "device": str(dev),
           "clock": "cuda events" if dev.type == "cuda" else "host"}
    print(f"instances={rec['instances']} overflow={rec['overflow']} "
          f"tiles={rec['tiles']} M={MAX_INSTANCES}", flush=True)
    rec["fwd_ms"] = _time_ms(lambda: tile_render.composite_forward(
        pack, starts, ends, 0, grid_x), args.reps, dev)
    print(f"fwd (B3): {rec['fwd_ms']:.4f} ms ({rec['clock']} on {dev})",
          flush=True)
    rec["bwd_ms"] = _time_ms(lambda: tile_render.composite_backward(
        pack, starts, ends, 0, grid_x, tiles, g_tiles), args.reps, dev)
    print(f"bwd (B4): {rec['bwd_ms']:.4f} ms ({rec['clock']} on {dev})",
          flush=True)
    return rec


if __name__ == "__main__":
    main()
