"""Readings that the limits of a Trainer cell's ``correct`` are set from,
on the card.

    python3 -m gsbench.calibrate_trainer --workload <cell> --seeds 11 12 ...
        --control-seeds 21 22 23 [--out FILE]

In one process, per seed of ``--seeds``: the cell's set-up episode, as a
run makes it (no warm-up), then the check against the plain reference:
the program's readings, the lower end of each limit. Per seed of
``--control-seeds``, the upper end:

- the control: the same set-up, then the reference computed in bfloat16
  in the program's place (the start's plain construction rounded to
  bfloat16, the first steps from the start state cast to bfloat16, each
  round and reset from the program's recorded state cast to bfloat16),
  and the training cells' fault, the step's loss over half the image's
  rows, each against the float32 reference;
- each fault a Trainer cell can have (``loops/trainer.py:FAULTS``: the
  abe_split pre-pass left out, another seed's split noise, the size
  threshold left out, the opacity reset skipped, the start's colours
  left as RGB), planted in the program, whose set-up episode is then
  checked as a run checks it.

With each round of a program reading come the spread of its mean
screen-space gradients beside the threshold, with the share of rows at
or over it (``grads``), and the shares of rows that each of the prune's
tests selects (``prune_causes``). Each reading is one JSON line, also
written to ``--out``. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from gsbench import check, run
from gsbench.calibrate import half_rows_loss
from gsbench.loops import trainer as trainer_loop
from gsbench.reference import schedules as ref_sched

QUANTILES = (0.5, 0.9, 0.99, 0.999, 1.0)


def _loop(workload: str, seed: int, device,
          fault=None) -> trainer_loop.Loop:
    _, cfg, traffic = run.cell_spec(workload)
    loop = trainer_loop.Loop(cfg, dict(traffic, warm_episodes=0), seed,
                             device)
    loop.fault = fault
    loop.setup(lambda name: None)
    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return loop


def grads(loop: trainer_loop.Loop) -> list[dict]:
    """Per recorded round: its iteration, the threshold and quantiles of
    the rows' mean screen-space gradient (accum / denom, 0 where denom
    is 0)."""
    out = []
    for r in loop.record.rounds:
        g = r["stats"]["xyz_gradient_accum"] / r["stats"]["denom"]
        g = torch.nan_to_num(g, nan=0.0).double()
        q = torch.quantile(g, torch.tensor(QUANTILES, dtype=torch.float64))
        thr = loop.cfg["opt"]["densify_grad_threshold"]
        out.append({"iteration": r["iteration"], "threshold": thr,
                    "share_over": float((g >= thr).double().mean()),
                    **{f"q{p}": float(v) for p, v in zip(QUANTILES, q)}})
    return out


def prune_causes(loop: trainer_loop.Loop) -> list[dict]:
    """Per recorded round: the shares of the rows before it whose opacity
    is under the floor, whose screen radius is over the screen size and
    whose largest scale is over 0.1·extent (the last two tested past the
    first reset only)."""
    out = []
    for r in loop.record.rounds:
        p, st = r["params"], r["stats"]
        out.append({
            "iteration": r["iteration"],
            "opacity": float((torch.sigmoid(p["opacity"][:, 0]) <
                              ref_sched.MIN_OPACITY).double().mean()),
            "screen": float((st["max_radii2d"] > ref_sched.SCREEN_SIZE)
                            .double().mean()),
            "world": float((torch.exp(p["scaling"]).amax(1) >
                            0.1 * loop.extent()).double().mean())})
    return out


def program_reading(workload: str, seed: int, device) -> dict:
    loop = _loop(workload, seed, device)
    numbers, overflowed = loop.check()
    return {"seed": seed, "kind": "program", "overflowed": overflowed,
            **numbers, "grads": grads(loop),
            "counts": [r["counts"] for r in loop.record.rounds],
            "prune_causes": prune_causes(loop)}


def control_readings(workload: str, seed: int, device) -> list[dict]:
    loop = _loop(workload, seed, device)
    r32 = loop.reference(loop.p0)
    rows = []

    def emit(key, name, nums):
        rows.append({"seed": seed, "kind": "control", key: name, **nums})

    bf16 = loop.plain_start(torch.bfloat16)
    emit("control", "bfloat16", {
        "start": loop.start_gap(bf16),
        **check.train_numbers(loop.reference(bf16), r32),
        **loop.round_numbers(loop.reference_rounds(dtype=torch.bfloat16),
                             loop.reference_rounds())})
    emit("fault", "half the rows in the loss", check.train_numbers(
        loop.reference(loop.p0, loss_fn=half_rows_loss), r32))
    del loop
    for name, fault in trainer_loop.FAULTS.items():
        faulty = _loop(workload, seed, device, fault)
        emit("fault", name, faulty.check()[0])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.calibrate_trainer needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from gsbench import program
    program.build_kernels(dev)
    rows = []

    def emit(row):
        row["t"] = time.perf_counter()
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        emit(program_reading(args.workload, seed, dev))
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
