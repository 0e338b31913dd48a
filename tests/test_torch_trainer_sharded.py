"""The port's Trainer in sharded mode (system.devices > 1) on the CPU, one
gloo process per rank (parallel.launch.spawn).

- devices=4 against devices=1 through a densify round, as
  tests/test_sharding.py:98-138: the same n_alive after the round, and
  params within 2e-3 (the one-step parity is tests/test_torch_sharding.py;
  Adam's sign-like first steps let 1e-7 differences grow over the run);
- a non-zero rank writes no file and makes no TensorBoard writer, as
  tests/test_multihost.py:65-88;
- devices=2 without an initialised group raises;
- the train CLI over two gloo ranks (--dist_init, --world_size, --rank)
  against a one-process run of the same argv, at the same bar.

The toy scene is tests/test_training.py's, rendered by the port
(tests/torch_sharding_cases.py). No JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rain_tpu_torch.parallel import launch
from rain_tpu_torch.train.trainer import Trainer
import torch_sharding_cases as cases

torch.set_num_threads(1)

TIMEOUT_S = 300


def test_trainer_sharded_matches_single(tmp_path):
    n1, p1, tier1 = cases.train_toy(0, torch.device("cpu"), 1,
                                    str(tmp_path / "single"), 10)
    n4, p4, tier4 = launch.spawn(
        cases.train_toy, 4, device="cpu", timeout_s=TIMEOUT_S,
        args=(4, str(tmp_path / "sharded"), 10))[0]
    assert n1 == n4 and n1 > 120       # the densify round ran
    # the per-band tier: max(round_up(2·8192/4, 65536), 65536)
    assert (tier1, tier4) == (8192, 65536)
    for name, a in p4.items():
        err = np.abs(a[:n1] - p1[name][:n1]).max()
        assert err < 2e-3, (name, err)


def test_nonzero_rank_writes_no_file(tmp_path):
    (files0, tb0), (files1, tb1) = launch.spawn(
        cases.write_gate, 2, device="cpu", timeout_s=TIMEOUT_S,
        args=(str(tmp_path),))
    assert files1 == [] and not tb1, f"rank 1 wrote {files1}"
    assert {"chkpnt2.npz", "log_file.txt",
            "point_cloud/iteration_2/point_cloud.ply"} <= set(files0)


def test_devices_without_a_group_raise(tmp_path):
    with pytest.raises(ValueError, match="world size 2"):
        Trainer(cases.toy_scene(n_cams=3, n_pts=60),
                cases.trainer_configs(2), str(tmp_path), device="cpu",
                log_fn=lambda *a: None, tensorboard=False)


def test_train_cli_two_ranks(tmp_path):
    """The train CLI as a user starts a sharded run: one process per rank
    with --dist_init, --world_size and --rank (gloo on the CPU), one
    output folder, written by rank 0 alone. Its PLY is held against a
    one-process run of the same argv at the sharded Trainer's bar: the
    same n_alive, params within 2e-3 in all but 1 in 10,000 rows a leaf;
    its cameras.json and input.ply are that run's byte for byte."""
    from torch_colmap_scene import toy_scene
    root = tmp_path / "scene"
    toy_scene(root)
    out, single = tmp_path / "out", tmp_path / "single"
    argv = ["-s", str(root), "--iterations", "4", "--test_iterations", "4",
            "--num_cams", "3", "--capacity", "400", "--max_instances",
            "65536", "--device", "cpu"]
    rcs, logs, _ = cases.train_cli_ranks(
        argv + ["-m", str(out), "--devices", "2", "--dist_init",
                (tmp_path / "store").as_uri(), "--world_size", "2"], 2,
        tmp_path / "ranks", timeout_s=TIMEOUT_S)
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-3000:]
    assert "Training complete." in logs[0]
    assert "Training complete." not in logs[1]
    ply = "point_cloud/iteration_4/point_cloud.ply"
    for name in ("cfg_args.json", "cameras.json", "input.ply",
                 "log_file.txt", ply):
        assert (out / name).is_file(), name
    one = subprocess.run(
        [sys.executable, "-m", "rain_tpu_torch.scripts.train", *argv, "-m",
         str(single)], env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    for name in ("cameras.json", "input.ply"):
        assert (out / name).read_bytes() == (single / name).read_bytes()
    rec = cases.ply_agreement(out / ply, single / ply)
    assert cases.ply_agrees(rec), rec
