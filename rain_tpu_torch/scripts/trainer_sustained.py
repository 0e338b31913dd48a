"""Sustained Trainer-loop throughput at the garden-proxy scale.

Port of tools/profiling/trainer_sustained.py. Measures the rate a user of
the Trainer sees (host scheduling, the one-step-late overflow and NaN
check, launches) beside bench.py's back-to-back steps, on the scene of
tools/sustained_growth.py (scripts/sustained_growth.py:build_scene): the
garden proxy's 262,144 means from their own points (the exact KNN), every
scale then forced to the log-scale -4.5, four cameras on one noise image
of 1297x840, capacity 262,144, instance tier 2^20, ``log_every`` 50.

Run:  python -m rain_tpu_torch.scripts.trainer_sustained [--iterations 200]
      [--pipeline 1] [--densify] [--out DIR] [--device cpu]

One Trainer iteration first (the first step's set-up), then ``iterations``
more, timed on the host clock up to a synchronize. ``--pipeline``
(the tool's SUSTAINED_PIPELINE) is the Trainer's ``system.pipeline``: 1
checks each step's flags while the next one runs, 0 waits for every step.
Densification is off unless ``--densify`` (the tool's SUSTAINED_DENSIFY),
which runs the default rounds from iteration 500 on, their growths
counted in the rate. Like the port's other entry points it runs on the
CUDA card and raises without one unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch import device as device_mod
from rain_tpu_torch.scripts import sustained_growth
from rain_tpu_torch.train.trainer import Trainer

ITERATIONS = 200


def configs(iterations: int, pipeline: int, densify: bool) -> dict:
    """The tool's configuration (tools/profiling/trainer_sustained.py:
    53-64): the defaults, with rounds from iteration 500 if ``densify``
    (else none), capacity 262,144, tier 2^20, ``log_every`` 50,
    ``pipeline``."""
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], iterations=iterations,
        densify_from_iter=500 if densify else 10 ** 9)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], capacity=sustained_growth.N,
        max_instances=sustained_growth.MAX_INSTANCES,
        log_every=50, pipeline=pipeline)
    return cfgs


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--pipeline", type=int, choices=(0, 1), default=1)
    p.add_argument("--densify", action="store_true")
    p.add_argument("--out", type=str, default="output/trainer_sustained")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_mod.resolve(args.device)
    trainer = Trainer(sustained_growth.build_scene(0),
                      configs(args.iterations, args.pipeline, args.densify),
                      args.out, device=device, tensorboard=False)
    sustained_growth.force_scaling(trainer)
    # one step to take the first use's set-up, then time the loop
    trainer.train(iterations=1, test_iterations=(), save_iterations=())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    trainer.train(iterations=args.iterations, test_iterations=(),
                  save_iterations=())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    rec = {"iterations": args.iterations, "pipeline": args.pipeline,
           "densify": args.densify, "device": str(device), "seconds": dt,
           "ms_per_iteration": dt / args.iterations * 1e3,
           "n_alive": trainer.state.n_alive,
           "instance_tier": trainer.max_instances,
           "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None)}
    print(f"sustained: {args.iterations / dt:.2f} it/s "
          f"({rec['ms_per_iteration']:.2f} ms per iteration) over "
          f"{args.iterations} Trainer iterations with pipeline "
          f"{args.pipeline}, densify {args.densify}; alive {rec['n_alive']} "
          f"tier {rec['instance_tier']} peak {rec['peak_mib']} MiB on "
          f"{device}", flush=True)
    return rec


if __name__ == "__main__":
    main()
