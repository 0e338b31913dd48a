"""The port's sharded training with one card per rank, over NCCL.

Run from the repository root on a machine with four CUDA cards:

    python3 chip_multicard.py [--out RECORD.json]

chip_smoke.py's phase 11 runs its ranks on one shared card over gloo;
this runs the same checks with every rank on a card of its own
(rain_tpu_torch.parallel.launch.spawn's default for one card per rank:
the nccl backend). It builds the kernels, takes phase 4's step 0 (the
perturbed 262k proxy at 1297x840, pose 0, its render as ground truth) on
card 0 as the reference, then chip_smoke.sharded_phase: B1, B3 and B4 at
tile offset -82 on the synthetic band; the sharded step at D = 2 and 4
against the single-device step (loss and l1 within 1e-5, Adam moments
within 1e-5, params within 1e-5 where the gradient is above its rounding's
level and 2·lr below it, statistics exact), B1-B4 bit for bit on every
band, every kernel launched once per rank, a D = 2 rerun with the same
bits; the sharded Trainer (devices=2) against devices=1; and
entry.dryrun_multichip(4). Then the train CLI as a user starts a sharded
run on four cards: chip_smoke.py phase 8's COLMAP scene (cli_scene: 10
poses at 1297x840 of the 262k proxy) and phase 8's argv (5 train views,
40 iterations, a report and a PLY at 40, a checkpoint at 20) as four
processes, rank r on card r (--devices 4, --dist_init
tcp://127.0.0.1:<free port>, --world_size 4, --rank r), once over NCCL,
the card's default, and once with --dist_backend gloo
(chip_smoke.sharded_cli: every rank exits 0, rank 0 alone writes the
output folder, every kernel launched on every rank, B4 and B2 once per
dispatched step, B1 and B3 once more per report frame). The NCCL run is
held against the gloo run (chip_smoke.hold_cli): cfg_args.json equal (the
backend is not part of it), cameras.json and input.ply byte for byte, the
same capacity and n_alive, the PLY's params within 2e-3 in all but 1 in
10,000 rows a leaf (those rows counted and printed), the final test PSNR
within 0.05 dB. It prints each rank's ms per step beside the
single-device step's (host clock, each ending in a synchronize), each CLI
run's wall time and ms per iteration per rank, the cards' names and power
limits and, last, {"ok": true, "device": {...}}. Any failed check, or
fewer than four cards, exits non-zero.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as smoke
from rain_tpu_torch import _build
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.train import step

CARDS = 4


def main(out: Path | None = None):
    t_start = time.perf_counter()
    if torch.cuda.device_count() < CARDS:
        sys.exit(f"chip_multicard: needs {CARDS} CUDA cards, "
                 f"{torch.cuda.device_count()} visible")
    smi = smoke.nvidia_smi()
    print(smi)
    _build.build_all()
    arrays = smoke.garden_proxy_state_arrays()
    cam = smoke.pose(0).render_inputs(smoke.DEV)
    gt = step.eval_render(
        gmod.from_arrays(**arrays, device=smoke.DEV), cam,
        torch.tensor(smoke.BG, device=smoke.DEV), smoke.LOW_PASS,
        width=smoke.WIDTH, height=smoke.HEIGHT, sh_degree=smoke.SH_DEGREE,
        max_instances=smoke.MAX_INSTANCES).render
    state0 = gmod.from_arrays(**smoke.perturbed(arrays), device=smoke.DEV)
    (s, o, aux), _ = smoke.train(state0, adam_mod.init(state0.params), cam,
                                 gt, smoke.WIDTH, smoke.HEIGHT)
    del state0
    kernels = [{"name": name} for name, _, _ in smoke.KERNELS]
    record = smoke.sharded_phase(arrays, gt, aux, smoke.snapshot(s, o),
                                 kernels, share_device=False)
    # the train CLI over NCCL, one process per card, against the same argv
    # over gloo on the same cards
    del s, o, aux, gt
    with tempfile.TemporaryDirectory(dir=smoke.ROOT) as tmp:
        tmp = Path(tmp)
        smoke.cli_scene(tmp / "scene", arrays)
        torch.cuda.empty_cache()
        cli = {b: smoke.sharded_cli(tmp / "scene", tmp / b, CARDS, b, False,
                                    kernels) for b in ("nccl", "gloo")}
        cli["nccl_against_gloo"] = smoke.hold_cli(
            tmp / "nccl", tmp / "gloo",
            f"train CLI over nccl against gloo, {CARDS} ranks on {CARDS} "
            f"cards", cli["nccl"]["ranks"][0]["capacity"],
            cli["gloo"]["ranks"][0]["capacity"])
    record["cli"] = cli
    record.update(nvidia_smi=smi, kernels=kernels,
                  wall_s=time.perf_counter() - t_start)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(f"chip_multicard: wall time {record['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        help="write the run's full record to this JSON file")
    main(parser.parse_args().out)
