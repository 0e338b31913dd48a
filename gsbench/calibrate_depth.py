"""Readings that the depth cell's limits of ``correct`` are set from, on
the card.

    python3 -m gsbench.calibrate_depth --seeds 11 12 ... \\
        --control-seeds 21 22 23 [--workload init262k.depth] [--out FILE]

In one process, per seed of ``--seeds``: the cell's set-up (the program's
first steps through the timed call, as a run makes them) and the check
against the plain reference (``reference/depth.py``): the program's
readings, the lower end of each limit (``calibrate.program_reading``).
Per seed of ``--control-seeds``: the control, the reference computed in
bfloat16 put in the program's place, against the float32 reference (the
upper end), and three faults planted in the program, each read as a
program reading:

- B4 drops the inverse-depth cotangent (its depth variant is given a
  cotangent whose depth channel is zero: no depth term in dL/dalpha, a
  zero gradient of 1/z);
- the pack carries z instead of 1/z (``ops.binning.inverse_depth``
  returns the depth itself);
- the depth weight is 0 (the program's step takes every weight it is
  given as 0; the reference keeps the schedule's).

Each reading is printed as one JSON line and written to ``--out``. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import sys
import time

import torch

from gsbench import calibrate, check
from gsbench.loops import depth_train

CELL = "init262k.depth"


@contextlib.contextmanager
def _dropped_cotangent():
    from rain_tpu_torch.ops import tile_render
    real = tile_render.composite_backward

    @functools.wraps(real)    # with its launch counters
    def dropped(pack, starts, ends, toff, grid_x, tiles, g_tiles,
                depth=False):
        if depth:
            g_tiles = g_tiles.clone()
            g_tiles[..., tile_render.CH_DEPTH] = 0.0
        return real(pack, starts, ends, toff, grid_x, tiles, g_tiles, depth)

    tile_render.composite_backward = dropped
    try:
        yield None
    finally:
        tile_render.composite_backward = real


@contextlib.contextmanager
def _pack_carries_z():
    from rain_tpu_torch.ops import binning, tile_render
    real = binning.inverse_depth

    def z(table, tiles):
        return torch.where(tiles > 0, table[tile_render.ROW_DEPTH], 0.0)

    binning.inverse_depth = z
    try:
        yield None
    finally:
        binning.inverse_depth = real


@contextlib.contextmanager
def _zero_weight():
    from rain_tpu_torch.train import compiled
    real = compiled.CompiledStep.train_step

    def zero(self, *args, depth=None, **kw):
        if depth is not None:
            depth = depth._replace(weight=0.0)
        return real(self, *args, depth=depth, **kw)

    compiled.CompiledStep.train_step = zero
    try:
        yield None
    finally:
        compiled.CompiledStep.train_step = real


FAULTS = {"B4 drops the inverse-depth cotangent": _dropped_cotangent,
          "the pack carries z instead of 1/z": _pack_carries_z,
          "the depth weight is 0": _zero_weight}


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def fault_reading(workload: str, seed: int, device, name: str) -> dict:
    """A program reading with the fault ``name`` planted."""
    with FAULTS[name]():
        loop = calibrate._loop(workload, seed, device)
        loop.setup(lambda _: None)
        loop.release()
    _free()
    numbers, overflowed = loop.check()
    return {"seed": seed, "kind": "control", "fault": name,
            "overflowed": overflowed, **numbers}


def control_reading(workload: str, seed: int, device) -> dict:
    """The bfloat16 reference against the float32 one."""
    loop = calibrate._loop(workload, seed, device)
    loop.inputs()
    r32 = loop.reference(loop.p0)
    r16 = loop.reference({k: v.to(torch.bfloat16)
                          for k, v in loop.p0.items()})
    numbers = check.train_numbers(r16, r32)
    numbers["invdepth"] = depth_train.inv_gap(r16["inv_depth"],
                                              r32["inv_depth"])
    return {"seed": seed, "kind": "control", "control": "bfloat16",
            **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.calibrate_depth needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []

    def emit(row):
        row["t"] = time.perf_counter()
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        emit(calibrate.program_reading(args.workload, seed, dev, 0.0))
        _free()
    for seed in args.control_seeds:
        emit(control_reading(args.workload, seed, dev))
        _free()
        for name in FAULTS:
            emit(fault_reading(args.workload, seed, dev, name))
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
