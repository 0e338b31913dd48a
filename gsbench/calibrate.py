"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m gsbench.calibrate --workload <cell> --seeds 11 12 ...
        --control-seeds 21 22 23 [--window 1.0] [--out FILE]

In one process, per seed of ``--seeds``: the cell's set-up (the
program's first steps through the timed call, as a run makes them), for
a render cell a ``--window`` of the cell's own traffic, then the check
against the plain reference: the program's readings, the lower end of
each limit. Per seed of ``--control-seeds``: the control, the reference
computed in bfloat16 put in the program's place, against the float32
reference (the upper end), and the faults that the cell can have,
planted in what stands in the program's place:

- training: the step's loss over half the image's rows, the mean taken
  over the rest; a step that returns its state unchanged reads 1 in the
  change and the gradient by construction and needs no run;
- frames: a frame that returns the previous frame's image, a frame with
  half its rows left black, a frame with one pixel altered by 0.05.

A cell of several cards (``chips`` > 1) takes every reading in one
spawn of its ranks (``sharded_readings``): the program's set-up on every
rank for each seed of both lists, then for each control seed again with
the exchange between the cards left out (``program.leave_out_exchange``);
then each rank runs, on its own card, the references of its share of the
seeds: float32 for every seed, and for the control seeds the bfloat16
control and the loss over half the rows. A step that returns one rank's
state unchanged is read from the sound run's parts with that rank's
first gradient, change and statistics at zero, as such a step leaves
them; the whole state unchanged reads 1.

Each reading is printed as one JSON line and written to ``--out``. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from gsbench import check, run
from gsbench.reference import step as ref

ALTERED = 0.05


def _loop(workload: str, seed: int, device):
    from gsbench import program as prog
    cell, cfg, traffic = run.cell_spec(workload)
    mod = importlib.import_module(f"gsbench.loops.{traffic['loop']}")
    return mod.Loop(cfg, traffic, seed, device, prog)


def half_rows_loss(image, gt, lambda_dssim):
    """The training loss over the top half of the rows alone."""
    h = image.shape[-2] // 2
    return ref.training_loss(image[:, :h], gt[:, :h], lambda_dssim)


def image_numbers(images: list, counts: list, frames: list) -> dict:
    return {"image": max(float(torch.max(torch.abs(i - f.image)))
                         for i, f in zip(images, frames)),
            "instances": check.rel_gap(counts, [f.instances for f in frames])}


def program_reading(workload: str, seed: int, device, window: float) -> dict:
    loop = _loop(workload, seed, device)
    loop.setup(lambda name: None)
    if loop.kind == "render":
        loop.window(window)
    loop.release()
    gc.collect()
    torch.cuda.empty_cache()
    numbers, overflowed = loop.check()
    return {"seed": seed, "kind": "program", "overflowed": overflowed,
            **numbers}


def control_readings(workload: str, seed: int, device) -> list[dict]:
    loop = _loop(workload, seed, device)
    loop.setup(lambda name: None)
    if loop.kind == "render":
        loop.window(0.5)
    loop.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    bf16 = {k: v.to(torch.bfloat16) for k, v in loop.p0.items()}
    if loop.kind == "train":
        r32 = loop.reference(loop.p0)
        out.append({"control": "bfloat16",
                    **check.train_numbers(loop.reference(bf16), r32)})
        out.append({"fault": "half the rows in the loss",
                    **check.train_numbers(loop.reference(
                        loop.p0, loss_fn=half_rows_loss), r32)})
    else:
        idx = [i for i, _, _ in loop.sample]
        images = [img for _, img, _ in loop.sample]
        counts = [int(m) for _, _, m in loop.sample]
        frames = loop.reference(loop.p0, idx)
        low = loop.reference(bf16, idx)
        out.append({"control": "bfloat16", **image_numbers(
            [f.image.float() for f in low], [f.instances for f in low],
            frames)})
        stale = loop.reference(loop.p0, [i - 1 for i in idx])
        out.append({"fault": "the previous frame's image",
                    **image_numbers([f.image for f in stale], counts,
                                    frames)})
        half = [img.clone() for img in images]
        for img in half:
            img[:, img.shape[1] // 2:] = 0.0
        out.append({"fault": "half the rows left black",
                    **image_numbers(half, counts, frames)})
        altered = [img.clone() for img in images]
        for img in altered:
            img[0, img.shape[1] // 2, img.shape[2] // 2] += ALTERED
        out.append({"fault": f"one pixel altered by {ALTERED}",
                    **image_numbers(altered, counts, frames)})
    return [{"seed": seed, "kind": "control", **r} for r in out]


def _sharded_rank(rank: int, device, workload: str, seeds: list,
                  control_seeds: list) -> dict:
    """One rank's part of ``sharded_readings``: plain data."""
    from gsbench import program as prog
    cell, cfg, traffic = run.cell_spec(workload)
    mod = importlib.import_module(f"gsbench.loops.{traffic['loop']}")
    world = cell["chips"]
    every = list(dict.fromkeys(seeds + control_seeds))
    parts = {}
    for seed, fault in [(s, False) for s in every] + \
            [(s, True) for s in control_seeds]:
        if fault:
            prog.leave_out_exchange()    # for every later seed
        loop = mod.Loop(cfg, traffic, seed, device, prog, world=world)
        loop.setup(lambda name: None)
        loop.release()
        parts[seed, fault] = loop.shard_check()
        del loop
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    refs = {}
    for seed in every[rank::world]:
        loop = mod.Loop(cfg, traffic, seed, device, None, world=world)
        loop.inputs()
        refs[seed] = {"f32": loop.reference(loop.p0)}
        if seed in control_seeds:
            bf16 = {k: v.to(torch.bfloat16) for k, v in loop.p0.items()}
            refs[seed]["bf16"] = loop.reference(bf16)
            refs[seed]["half"] = loop.reference(loop.p0,
                                                loss_fn=half_rows_loss)
        del loop
        gc.collect()
    return {"parts": parts, "refs": refs}


def sharded_readings(workload: str, seeds: list, control_seeds: list,
                     device) -> list[dict]:
    """The readings of a cell of several cards (see the docstring)."""
    from gsbench import program as prog
    from gsbench.loops.sharded_train import whole
    cell, _, _ = run.cell_spec(workload)
    reports = prog.spawn(_sharded_rank, cell["chips"], device=device,
                         timeout_s=3600.0,
                         args=(workload, seeds, control_seeds))
    refs = {}
    for r in reports:
        refs.update(r["refs"])

    def parts(seed, fault=False):
        return [r["parts"][seed, fault] for r in reports]

    rows = []
    for seed in dict.fromkeys(seeds + control_seeds):
        got = parts(seed)
        rows.append({"seed": seed, "kind": "program",
                     "overflowed": max(p["overflow"] for p in got),
                     **check.train_numbers(whole(got), refs[seed]["f32"])})
    for seed in control_seeds:
        r32 = refs[seed]["f32"]
        unchanged = [dict(p) for p in parts(seed)]
        unchanged[-1].update({k: dict.fromkeys(unchanged[-1][k], 0.0)
                              for k in ("first_grad", "change", "stats")})
        for name, rec in (
                ("control", refs[seed]["bf16"]),
                ("half the rows in the loss", refs[seed]["half"]),
                ("the exchange between the cards left out",
                 whole(parts(seed, True))),
                ("the last rank's state unchanged", whole(unchanged))):
            key = "control" if name == "control" else "fault"
            rows.append({"seed": seed, "kind": "control",
                         key: "bfloat16" if key == "control" else name,
                         **check.train_numbers(rec, r32)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []

    def emit(row):
        row["t"] = time.perf_counter()
        rows.append(row)
        print(json.dumps(row), flush=True)

    cell, _, _ = run.cell_spec(args.workload)
    if cell["chips"] > 1:
        for row in sharded_readings(args.workload, args.seeds,
                                    args.control_seeds, dev):
            emit(row)
    else:
        for seed in args.seeds:
            emit(program_reading(args.workload, seed, dev, args.window))
        for seed in args.control_seeds:
            for row in control_readings(args.workload, seed, dev):
                emit(row)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
