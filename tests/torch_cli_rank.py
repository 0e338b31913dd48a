"""One rank of the train CLI that also reports its kernels' launches.

    python tests/torch_cli_rank.py COUNTS.json [train CLI flags...]

runs ``rain_tpu_torch.scripts.train.main`` on the flags, the function that
``python -m rain_tpu_torch.scripts.train`` runs, in this process, then
writes to COUNTS.json the launch counts of B1-B4 and of preprocess's two
kernels over the run (every count is 0 when the process starts), the
Trainer's report frames and
re-renders, its final population, capacity and tier, the host time of
``Trainer.train`` (on a card up to a synchronize) per iteration, and the
median host time from one iteration's start to the next one's. The
card's sharded CLI runs (chip_smoke.py phase 11, chip_multicard.py) start
each rank this way, so that every rank's launches can be checked.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import preprocess as prep_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.scripts import train
from rain_tpu_torch.train import trainer as trainer_mod

KERNELS = {"expand_instances": expand_ops.expand_instances,
           "composite_forward": tile_render.composite_forward,
           "composite_backward": tile_render.composite_backward,
           "reduce_instances": expand_ops.reduce_instances,
           "preprocess_forward": prep_ops.preprocess_forward,
           "preprocess_backward": prep_ops.preprocess_backward}


def main(argv):
    out, flags = Path(argv[0]), argv[1:]
    timing = {}
    train_loop = trainer_mod.Trainer.train

    def timed_train(self, *a, **kw):
        t = time.perf_counter()
        state = train_loop(self, *a, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing["train_s"] = time.perf_counter() - t
        return state

    next_camera = trainer_mod.Trainer._next_camera
    starts = []    # host clock at each iteration's start

    def stamped_next_camera(self):
        starts.append(time.perf_counter())
        return next_camera(self)

    trainer_mod.Trainer.train = timed_train
    trainer_mod.Trainer._next_camera = stamped_next_camera
    sys.argv = [train.__file__, *flags]
    trainer = train.main(flags)
    out.write_text(json.dumps({
        "launches": {k: f.launches for k, f in KERNELS.items()},
        "rank": trainer.rank, "device": str(trainer.device),
        "iteration": trainer.iteration,
        "n_alive": int(trainer.state.n_alive),
        # a rank's state holds its shard of the capacity
        "capacity": trainer.state.capacity * trainer.n_devices,
        "tier": trainer.max_instances,
        # each report renders the test views and 5 training views; only
        # rank 0 reports
        "report_frames": len(trainer.history) * (
            len(trainer.scene.test_cameras) + 5),
        "report_rerenders": len(trainer.report_rerenders),
        "train_s": timing["train_s"],
        "ms_per_iteration": timing["train_s"] / trainer.iteration * 1e3,
        # from one iteration's start to the next one's, from the 5th on
        "iteration_ms_median": float(np.median(np.diff(starts[4:]))) * 1e3
        if len(starts) > 5 else None}))


if __name__ == "__main__":
    main(sys.argv[1:])
