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
band, B1-B4 launched once per rank and preprocess's kernels never (the
sharded step runs the plain preprocess), a D = 2 rerun with the same
bits; the sharded Trainer (devices=2) against devices=1, its steps and
rank 0's report frames through its CompiledStep (the steps captured over
NCCL, the frames held to the eager render bit for bit), and the same run
with the eager step and render, which it must equal bit for bit on every
rank; and entry.dryrun_multichip(4). Then the captured sharded step
(rain_tpu_torch.train.compiled.CompiledStep.sharded_train_step: one CUDA
graph per key and rank over NCCL) at D = 2 and 4 on phase 4's step 0
(chip_smoke.captured_rank): a warm-up, the capture, then 20 replays of
the same inputs, each equal to the eager NCCL step bit for bit on every
rank, B1-B4 counted once per replay and preprocess's kernels never; per
rank the ms per step captured and eager (host clock, each call ending in
a synchronize), the host's
launch calls per step (torch.profiler), the capture's ms and the peak
memory over the capture and two replays, printed beside the one-card
compiled step (train.compiled.CompiledStep.train_step on card 0 at the
same step, against the eager one). Then the train CLI as a user starts a sharded
run on four cards: chip_smoke.py phase 8's COLMAP scene (cli_scene: 10
poses at 1297x840 of the 262k proxy) and phase 8's argv (5 train views,
40 iterations, a report and a PLY at 40, a checkpoint at 20) as four
processes, rank r on card r (--devices 4, --dist_init
tcp://127.0.0.1:<free port>, --world_size 4, --rank r), once over NCCL,
the card's default, whose steps are captured, and once with
--dist_backend gloo, whose steps run eagerly
(chip_smoke.sharded_cli: every rank exits 0, rank 0 alone writes the
output folder, every kernel launched on every rank, B4 and B2 once per
dispatched step, B1 and B3 once more per report frame). The NCCL run is
held against the gloo run (chip_smoke.hold_cli): cfg_args.json equal (the
backend is not part of it), cameras.json and input.ply byte for byte, the
same capacity and n_alive, the PLY's params within 2e-3 in all but 1 in
10,000 rows a leaf (those rows counted and printed), the final test PSNR
within 0.05 dB. It prints each rank's ms per step beside the
single-device step's (host clock, each ending in a synchronize), each CLI
run's wall time and ms per iteration per rank beside one process's run of
the same argv on card 0 (its steps captured) and beside the eager
NCCL run of PERF.md's M3 (18.2-20.5 ms), the cards' names and power
limits and, last, {"ok": true, "device": {...}}. Any failed check, or
fewer than four cards, exits non-zero.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as smoke
from rain_tpu_torch import _build
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.parallel import launch
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step

CARDS = 4
# the train CLI over NCCL through the eager step, median ms per iteration
# per rank over iterations 5-40 on four H100s (PERF.md's M3)
EAGER_NCCL_MS_PER_ITERATION = (18.2, 20.5)


def one_card(state, opt, cam, gt):
    """The single-device step at phase 4's step 0 on card 0, eager and
    through a CompiledStep (captured at its first call), every per-call
    value a 0-d tensor: host ms per step (chip_smoke.path_times) and the
    device's busy time and the host's launch calls
    (chip_smoke.device_profile) per path."""
    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=smoke.DEV)
    args = (state._replace(n_alive=torch.full(
        (), state.n_alive, dtype=torch.int32, device=smoke.DEV)), opt, cam,
        gt, torch.tensor(smoke.BG, device=smoke.DEV), f32(smoke.LOW_PASS),
        f32(smoke.XYZ_LR))
    kw = dict(width=smoke.WIDTH, height=smoke.HEIGHT,
              sh_degree=smoke.SH_DEGREE, max_instances=smoke.MAX_INSTANCES,
              opt_cfg_leaves={k: f32(v) for k, v in smoke.OPT_LEAVES.items()})
    steps = compiled.CompiledStep()
    paths = {"eager": lambda: step.train_step(*args, **kw),
             "compiled": lambda: steps.train_step(*args, **kw)}
    paths["compiled"]()
    rec = smoke.path_times(paths)
    for name, fn in paths.items():
        rec[name].update(smoke.device_profile(fn))
    return rec


def captured_phase(gt, one):
    """The captured sharded step at D = 2 and 4, one card per rank over
    NCCL (chip_smoke.captured_rank), beside the one-card step ``one``.
    Returns the record."""
    rec = {}
    smi = smoke.nvidia_smi().splitlines()[0]
    with tempfile.TemporaryDirectory(dir=smoke.ROOT) as tmp:
        np.save(Path(tmp) / "gt.npy", gt.cpu().numpy())
        for world in smoke.SHARD_WORLDS:
            ranks = launch.spawn(smoke.captured_rank, world, device=smoke.DEV,
                                 timeout_s=600,
                                 args=(smoke.sizes(), tmp,
                                       smoke.CAPTURED_REPLAYS))
            for r in ranks:
                what = f"captured sharded step D={world} rank {r['rank']}"
                if r["replays_equal"] != [True] * smoke.CAPTURED_REPLAYS or \
                        r["replay_digest"] != r["digest"]:
                    raise AssertionError(f"{what}: replays equal to the "
                                         f"eager step {r['replays_equal']}")
                if r["launches"] != smoke.sharded_launches(
                        smoke.CAPTURED_REPLAYS) or \
                        len(r["captures"]) != 1:
                    raise AssertionError(f"{what}: launches {r['launches']}"
                                         f", captures {r['captures']}")

            def per_rank(path, key):
                return [round(r[path][key]["median"] if key == "host_ms"
                              else r[path]["busy_ms"] - r[path]["nccl_ms"]
                              if key == "busy_ms" else r[path][key], 3)
                        for r in ranks]
            print(f"captured sharded step D={world} over nccl: "
                  f"{smoke.CAPTURED_REPLAYS} replays per rank equal the "
                  f"eager step bit for bit on every rank (loss "
                  f"{ranks[0]['loss']:.7f}, instances of the fullest band "
                  f"{ranks[0]['num_instances']}); ms per step "
                  f"per rank captured {per_rank('captured', 'host_ms')} "
                  f"(queued {per_rank('captured', 'queued_ms')}), eager "
                  f"{per_rank('eager', 'host_ms')} (queued "
                  f"{per_rank('eager', 'queued_ms')}); device busy ms "
                  f"outside NCCL's kernels captured "
                  f"{per_rank('captured', 'busy_ms')}, eager "
                  f"{per_rank('eager', 'busy_ms')}, in them captured "
                  f"{per_rank('captured', 'nccl_ms')}, eager "
                  f"{per_rank('eager', 'nccl_ms')}; host launches per step "
                  f"captured {per_rank('captured', 'host_launches')}, "
                  f"eager {per_rank('eager', 'host_launches')}; capture ms "
                  f"{[round(r['captures'][0][1], 1) for r in ranks]}; peak "
                  f"MiB over the capture and two replays "
                  f"{[round(r['peak_mib']) for r in ranks]} (reserved "
                  f"{[round(r['reserved_mib']) for r in ranks]}); one card: "
                  f"compiled {one['compiled']['host_ms']['median']:.3f} ms, "
                  f"eager {one['eager']['host_ms']['median']:.3f} ms, host "
                  f"launches {one['compiled']['host_launches']:.0f} and "
                  f"{one['eager']['host_launches']:.0f} ({smi})")
            rec[f"D{world}"] = ranks
    return rec


def one_process_cli(src, out):
    """The train CLI's argv of chip_smoke.sharded_cli as one process on
    card 0 (its steps captured): ms per iteration, the figure the sharded
    runs stand beside."""
    ranks_dir = out.with_name(out.name + "_ranks")
    rcs, logs, wall_s = smoke.SHARDING.train_cli_ranks(
        smoke.cli_argv(src) + ["-m", str(out)], 1, ranks_dir, counts=True,
        timeout_s=300)
    if rcs != [0]:
        raise AssertionError(f"train CLI, one process: exit {rcs}\n"
                             f"{logs[0][-4000:]}")
    rk = json.loads((ranks_dir / "rank0.json").read_text())
    print(f"train CLI, one process on card 0: {wall_s:.1f} s wall, "
          f"{rk['ms_per_iteration']:.2f} ms per iteration "
          f"(median {rk['iteration_ms_median']:.2f} over iterations "
          f"5-{smoke.CLI_ITERS})")
    return dict(rk, wall_s=wall_s)


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
    opt0 = adam_mod.init(state0.params)
    (s, o, aux), _ = smoke.train(state0, opt0, cam, gt, smoke.WIDTH,
                                 smoke.HEIGHT)
    one = one_card(state0, opt0, cam, gt)
    del state0, opt0
    kernels = [{"name": name} for name, _, _ in smoke.KERNELS]
    record = smoke.sharded_phase(arrays, gt, aux, smoke.snapshot(s, o),
                                 kernels, share_device=False)
    torch.cuda.empty_cache()
    record["one_card"] = one
    record["captured"] = captured_phase(gt, one)
    # the train CLI over NCCL, one process per card, against the same argv
    # over gloo on the same cards
    del s, o, aux, gt
    with tempfile.TemporaryDirectory(dir=smoke.ROOT) as tmp:
        tmp = Path(tmp)
        smoke.cli_scene(tmp / "scene", arrays)
        torch.cuda.empty_cache()
        cli = {b: smoke.sharded_cli(tmp / "scene", tmp / b, CARDS, b, False,
                                    kernels) for b in ("nccl", "gloo")}
        cli["one_process"] = one_process_cli(tmp / "scene", tmp / "one")
        print(f"train CLI, median ms per iteration per rank over "
              f"iterations 5-{smoke.CLI_ITERS}: nccl, captured "
              f"{[round(v, 2) for v in cli['nccl']['iteration_ms_median']]}"
              f"; gloo, eager "
              f"{[round(v, 2) for v in cli['gloo']['iteration_ms_median']]}"
              f"; nccl, eager (M3) {list(EAGER_NCCL_MS_PER_ITERATION)}; one "
              f"process on one card "
              f"{cli['one_process']['iteration_ms_median']:.2f} "
              f"({smoke.nvidia_smi().splitlines()[0]})")
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
