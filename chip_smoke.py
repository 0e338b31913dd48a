"""Drive the PyTorch/CUDA port (rain_tpu_torch) on one NVIDIA card.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py [--out RECORD.json]

Phases, in order; any failure exits non-zero before the result lines:

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel under rain_tpu_torch/csrc with nvcc, timed. Then B1
   (expand_instances) at its edge cases, on synthetic inputs made from a
   seed (tests/torch_expand_cases.py) at the main path's N = 262,144 and
   M = 786,432 unless the case sets them: tile-less Gaussians among
   visible ones, one rect of the whole 82x53 grid, M below the instance
   count, M = 786,431, no instance, no Gaussian, N = 2^21 + 3. Each is
   held against the plain version bit for bit (signed zeros and NaNs
   included), with NaN in the allocator's cache first so that a column
   the kernel failed to write shows. B2 (reduce_instances) the same way at
   its edge cases (tests/torch_reduce_cases.py): a segment over three
   chunks, one of the whole grid, segments across every chunk boundary, a
   culled tail, a run of empty segments, segments clipped by M, a ragged
   M, no instance, no Gaussian.
2. The garden-proxy 262k scene of bench.py (262,144 Gaussians, SH degree
   3 with random f_rest) is saved with save_ply_snapshot and loaded onto
   the card with load_ply_snapshot. Each forward kernel's output in a
   frame of eval_render (kept by its on_stage hook) is held against its
   plain PyTorch version on the same inputs: B1 (expand_instances) at the
   main path's shapes, bit for bit in columns and keys; B3
   (composite_forward) on the main
   path's frame and on a 256x256 view of 20k Gaussians, bit for bit in
   all 8 channels (its culling skips only pairs the plain loop skips).
   The whole eval_render on the card is held against the port's CPU path
   on a small scene, at the CPU tests' tolerances.
3. The render path: eval_render from 5 poses at 1297x840 with
   max_instances=786,432, its kernels' launch counters set to 0 just
   before and read just after (one launch of B1 and B3 per frame). The
   frames are finite, do not overflow, pose 0 renders as in phase 2, and
   they are the ground truth of phase 4.
4. The training main path, bench.py's 262k train tier: the scene is
   perturbed (seeded xyz noise, an opacity and a colour shift) and
   train_step takes 5 steps, one per pose, with the lrs of bench.py:79-80.
   All four launch counters are set to 0 just before and read just after:
   each kernel launched once per step. Loss and params are finite, no
   step overflows, and the loss at pose 0 after the steps is below step
   0's. Step 0 taken again from the same state gives the same params, Adam
   moments and statistics bit for bit.
5. The backward kernels against their plain versions, on the inputs the
   training step gave them (its on_stage hook): B2 (reduce_instances) bit
   for bit, and B4 (composite_backward) bit for bit in every row of its
   [16, M] output, at the main path's full frame and on the 256x256 view
   of 20k Gaussians. A training step on the card is held against the
   port's CPU path on a small scene (loss to rtol 1e-5, Adam's first
   moment at the gradient bar 1e-4).
6. Timing: per frame and per training step (host clock), per stage (CUDA
   events from the on_stage hooks), the device's busy time, idle share and
   launches (torch.profiler), peak memory, and per kernel (median of
   CUDA-event times, beside its plain version, the library call that
   computes the same function where one exists, and its bound from the
   H100 SXM's published peaks), on the training step's inputs; B1's and
   the compositors' resident blocks per SM and each kernel's ptxas line
   (registers, shared memory, spills); and, for the record, a [16, M]
   zero fill alone (what B4's output cost before B4 wrote its zeros).
7. The Trainer loop at full width: rain_tpu_torch.train.trainer.Trainer,
   its steps and report frames through its compiled step
   (rain_tpu_torch.train.compiled: one CUDA graph per key, as in phases
   8, 9, 12 and 13; each selected step of a KernelCapture runs eager),
   trains the 262k proxy at 1297x840 (SH degree 3, active degree 0 under
   the ours_new schedule) from its own points (the exact KNN at 262,144),
   with the 5 poses of phase 3 as train cameras and two more poses of the
   pan as test cameras, their renders as ground truth. The ours_new preset
   (c2f on) with warmup 30; 60 iterations, densify rounds at 20
   (abe_split) and 40, the opacity reset at 50; capacity 393,216, which
   the first round grows, and max_instances 262,144, which iteration 1
   overflows. First KNN (20k points) and a densify round (3k) on the card
   are held against the CPU path, and the exact KNN at 262,144 is timed
   alone. Each run's loop is recorded by the wrappers of
   tests/torch_trainer_trace.py, which the Trainer tests share. Run A
   (pipelined, reports at 0 and 60, checkpoints at 25 and 30, a PLY at
   60) starts from that KNN's scales bit for bit and has its launch
   counters set to 0 just before the loop: each kernel launched once per
   dispatched step, retries included, B1 and B3 also once per report
   frame. It must retry an overflow at a tier that fits, keep no
   overflowed step, grow the capacity, match each round's n_alive, reset
   the opacity, keep every loss and param finite, raise the held-out PSNR
   and reload its PLY with n_alive rows. A second run from seed 0 (B,
   profiled over iterations 10-19) equals A's checkpoint at 25 bit for
   bit. A run E, A's loop with the compiled step's methods replaced by
   the eager step and render, equals A bit for bit: every step's tier,
   capacity, n_alive, loss and instances, each round's DensifyInfo, the
   reports at 0 and 60 and the final state. At B's first step after the
   growth (iteration 21: capacity
   786,432 with dead rows at its tail, the grown tier) B1, B3, B4 and B2
   are held against their plain versions bit for bit on that step's
   inputs, and timed there beside their bounds. A run with pipeline 0
   (C) equals B bit for bit, and a run resumed from the checkpoint at 30
   (D) reaches 60 with finite losses. Recorded: the KNN's time, host ms
   per iteration with pipeline 1 and 0, ms per densify round, capacity
   growth (the state's) and retried step, tiers and instance counts of
   every step, n_alive per round, the device's busy time per iteration
   and its idle share over B's profiled window (busy time over that
   window's host-clock time), peak memory, A's captures (key, ms) and
   host ms per iteration and peak memory of A and E, the synchronising
   calls of one
   step and of one bucketed step with the file:line of each (sync debug
   mode), the report frames rendered again because the training tier
   could not hold them, and B2's segments at the Trainer step (length
   mean, p99 and max, the warp imbalance of a thread per row and
   Gaussian, the segments carried past their chunk).
8. The CLIs at full width, with PIL made unimportable (so that nothing
   on the path leans on it, whether the machine has it or not): a COLMAP
   scene is written (one PINHOLE camera at 1297x840, 10 poses of phase
   3's pan with the 262k proxy's renders as PNG images, its 262,144
   means and colours as points3D.bin with a seeded error column), and rain_tpu_torch.scripts.train, .render and .metrics
   run in this process through their main(argv). The train CLI takes 40
   iterations from the SfM points (default preset: exact KNN, SH degree 3,
   5 train and 5 test views), a report at 40, a checkpoint at 20 and a PLY
   at 40; a second run resumes from the checkpoint and reaches 40. Checked:
   the native COLMAP parser is used and equals the Python one; the scene
   loads as written; the launch counters, set to 0 just before the train
   CLI and read just after, count each kernel once per dispatched step
   and B1 and B3 once more per report frame and re-render; the losses are
   finite and fall from iteration 1 to 40; the provenance files, the PLY
   and the resumed run; the render CLI writes 10 renders, gt, depth and
   inferno depth PNGs (B1 and B3 once per frame and re-render); test view
   0's PNG is the truncated eval_render of the loaded PLY bit for bit and
   B3 on that frame its plain version's bits; results.json's PSNR is the
   report's at 40 within what the PNG's truncation can move it. Recorded:
   the native parser's cc build, points3D.bin parse times (native and
   Python), PNG decode and encode times, each CLI's wall time, ms per
   iteration over iterations 5-40, the render CLI's ms per view against
   eval_render alone, each CLI's peak memory above what the process held.
9. The 30k production run of tools/run_production_30k.py on the port,
   through rain_tpu_torch.scripts.production_30k.main at full width (a
   600k-Gaussian procedural target, 60 train and 6 test views of
   1297x840 rendered from it at the tier 4,194,304, a 150k-point init,
   the production preset with c2f), with round 5's ring radius 14 and
   scale shift 0.56, cut from 30,000 iterations to 1000
   with reports at 1 and 1000 and a checkpoint at 500, then a second run
   resumed from that checkpoint to 600. Checked: ground truth view 0's
   instances within 0.1 % of round 5's 3,332,871; iteration 1 overflows
   the first tier 1,245,184 and is retried at a tier that holds it; the
   launch counters, set to 0 just before each run and read just after,
   count B1 and B3 once per target view, dispatched step (retries
   included), report frame and re-render and B4 and B2 once per
   dispatched step; at the retried step of iteration 1 B1, B3, B4 and B2
   are held against their plain versions bit for bit and timed (phase 7's
   trainer_step_kernels, whose launches are not counted); losses and
   params finite, the held-out PSNR at 1000 above that at 1; the resumed
   run starts at 500 and reaches 600. Recorded: the exact KNN at 150,000
   points, target-render ms per view, ms per iteration over iterations
   5-500 and 500-1000, n_alive per densify round, the tier ladder, report
   re-renders, peak memory, round 5's counts beside the port's, and the
   device's busy time, launches and idle share over iterations 400-409
   (torch.profiler through the CLI's --profile_steps).
10. The A/B paths of rain_tpu (RAIN_TPU_SORT, RAIN_TPU_EXPAND,
   RAIN_TPU_REDUCE), keyword arguments in the port, at phase 4's step 0
   (the perturbed 262k proxy, pose 0, its render as ground truth):
   render and the training loss's gradients through B2 (the main path),
   through the scatter reduction and through the legacy expansion, each
   twice. Checked: each path's two runs equal bit for bit; neither A/B
   path launches B2; bin_gaussians with torch.sort and with the bitonic
   network give one Binning, the legacy path's; the legacy and the fused
   path give one image, depth, alpha, final T and n_contrib, one instance
   order (tiles and depth ranks of the sorted keys, and the packs) bit
   for bit; with the scatter reduction their gradients are equal bit for
   bit; the scatter reduction against B2 within the gradient bar 1e-4.
   Recorded: the launches of the six runs, a frame's time through each
   expansion, bin_gaussians' time with each sort.
11. The sharded step (rain_tpu_torch.parallel), its ranks sharing the card
   over gloo (parallel.launch.spawn, one process per rank). First B1, B3
   and B4 at tile offset -82 on a band of 29 rows at full width whose
   rects start in the row above the image (50,000 Gaussians,
   tests/torch_sharding_cases.py:band_case): bit for bit with their plain
   versions and with the band moved down one row at offset 0. Then phase
   4's step 0 (the perturbed 262k proxy, pose 0, its render as ground
   truth) at D = 2 and 4 ranks, the tier 786,432 per band: every rank's
   counts set to 0 just before its step and read just after (each kernel
   once per rank); loss and l1 within 1e-5 of the single-device step's;
   every rank's rows of the Adam moments within 1e-5 absolute, of the
   params too wherever the single-device gradient is at least 1e-6 of its
   leaf's largest (below that the gradient is at its rounding's level and
   Adam's first step lr·g/(|g| + 1e-15) may move a param by up to 2·lr,
   the bar there; such params past 1e-5 are counted),
   xyz_gradient_accum within 1e-5, denom and max_radii2d exactly; B1-B4 of
   every band (offset -82 on band 0) bit for bit with their plain
   versions; a second D = 2 run gives the same bits on every rank. A
   Trainer with devices=2 (two ranks on the card) against devices=1 on
   phase 7's scene, 12 iterations with a densify round at 10 (the same
   n_alive; params within 2e-3 in all but 1 in 10,000 of each leaf's rows,
   where a gradient at its rounding's level took another sign and Adam
   made it a step of lr; those rows counted), and
   entry.dryrun_multichip(4,
   share_device=True). Then the train CLI as a user starts a sharded run:
   phase 8's argv on phase 8's COLMAP scene as 2 processes, one per rank
   (--devices 2, --dist_init tcp://127.0.0.1:<free port>, --world_size 2,
   --rank r, --dist_backend gloo, --device cuda:0), each reporting its
   launches (tests/torch_cli_rank.py). Checked: both exit 0, rank 0 alone
   writes the output folder, on each rank B4 and B2 once per dispatched
   step and B1 and B3 once more per report frame; against phase 8's run
   of one process: cfg_args.json equal but for the output folder and
   system.devices, cameras.json and input.ply byte for byte, the same
   capacity and n_alive, the final test PSNR within 0.05 dB, the PLY's
   rows off by 2e-3 or more counted per leaf (40 Adam steps turn
   rounding-level gradient differences into steps of lr; the sharded
   Trainer above holds the params). (NCCL cannot put two ranks on one
   card: chip_multicard.py runs the CLI over NCCL on four.)
   Recorded: ms per sharded step per rank (ranks sharing one card: not a
   scaling figure), each band's instances, the Trainers' times, the
   CLI's wall time and ms per iteration per rank.

12. The end-state scale, through rain_tpu_torch.scripts: bench.py's 1m
   and 4m tiers (1,048,576 and 4,194,304 Gaussians, SH degree 3 with zero
   f_rest, log-scales -5.2 and -5.9, tiers 2,097,152 and 6,291,456) at its
   camera and 1297x840, each through probe_scale.run_tier: step 0 and 10
   more steps, the launch counters set to 0 just before and read just
   after (each kernel once per step, 3 profiled steps included). Checked:
   step 0's instances are BENCH_r05.json's, 1,644,592 and 5,436,763, with
   no overflow; B1-B4 of step 0 bit for bit against their plain versions
   (phase 4's helpers), then timed beside their bounds. Then
   knn_deviation's clustered cloud of 1,572,864 points: the exact search
   completes and the Morton-window search lies on no row below it by
   more than 1e-6 relative. Then sustained_growth's run (262,144 points
   of bench.py's box, four cameras on a noise image, densify rounds from
   500, max_capacity 2,500,000) cut from 3,600 iterations to 1,350, its
   loop recorded and its launch counters set to 0 just before and read
   just after (each kernel once per dispatched step): it must grow the
   capacity 262,144 -> 524,288 -> 1,048,576 -> 2,097,152, retry
   overflows at the tiers 1,572,864 and 2,097,152, keep no overflowed
   step, hold alive at 1000 within 10 % of docs/runs/
   sustained_growth_r5.log's 496,434, and a train_step at its end state
   makes no synchronising call. Recorded: per tier the first step, the
   host median of 10 steps, the device's busy time and operations per
   step (torch.profiler), the peak memory and each kernel's ms and bound
   ms; the KNN's times and error statistics; the growth run's alive every
   50 iterations, growths, retries, rounds, host ms per iteration, peak
   memory and wall time.
13. The long end-to-end run from a sparse init, the port of rain_tpu's
   tests/test_e2e_long.py (rain_tpu_torch.scripts.e2e_long.main, uncut:
   2,000 ground-truth Gaussians rendered from 30 views of 96x96 on the
   card, training from 150 noisy points at capacity 512 over 2,500
   iterations, densify rounds every 100 from 300 to 2,000, an opacity
   reset at 1,200, tier 131,072), its loop recorded and its launch
   counters set to 0 just before and read just after (B1 and B3 once per
   ground-truth view, dispatched step, report frame and re-render, B4 and
   B2 once per dispatched step). Checked: the JAX test's five assertions
   (at least 1,500 alive, capacity above 512, a "growing capacity" event,
   final test PSNR above 26 dB and 8 dB above iteration 0's); the
   iteration-0 report within one unit of the last digit that
   docs/runs/e2e_long_tpu_r4.log prints (L1 0.02702, PSNR 24.22, SSIM
   0.8591 test; 0.03217, 23.54, 0.8218 train); B1-B4 bit for bit against
   their plain versions at the first step after the capacity growth
   (a 6x6 grid of whole-image tiles); the card's ground-truth images
   against the CPU path's at the oracle tolerances, each value past them
   a threshold flip that an f64 render settles, the same instance counts,
   no overflow; a train_step at the end state makes no synchronising
   call; the run's first 600 iterations (past the growth at 500) through
   the compiled step and through the eager one give the same steps,
   capacity events, reports and state bit for bit. Printed beside the
   port's, not checked: the logs' growths, final population and PSNR.
   Recorded: host ms per iteration, wall time, peak memory, every
   capacity growth and retry, the captures, and the 600-iteration runs'
   host ms per iteration and peak memory.

14. The part-mask overlays of rain_tpu/tools/combine_masks.py
   (rain_tpu_torch.tools.combine_masks; no kernel of its own: a handful
   of element-wise operations). blend at 1297x840 on the card against the
   CPU path and against rain_tpu's numpy arithmetic, bit for bit, at two
   alphas: four masks that take every value 0-255, then one such mask,
   an empty one, an all-255 one and a binary one. Then, where PIL imports
   (the frame-name stamp needs it; without it the CLI is skipped and
   said so), combine_masks.main --device cuda over three seeded frames
   of 1297x840 with four masks each (written with the port's PNG writer;
   an empty and a missing mask, an all-255 one) against --device cpu,
   pixel for pixel. Recorded: blend's device ms per frame, the CLI's ms
   per frame on the card and the CPU, and, for the record, at how many
   of the 256 mask values the card's division by a host scalar (torch
   multiplies by its reciprocal there) parts from numpy's.

15. The compiled step (rain_tpu_torch.train.compiled: train_step and
   eval_render captured once per key into a CUDA graph, every per-call
   value a 0-d device tensor) on the 262k proxy at 1297x840, held to the
   eager step bit for bit: the 5 poses rendered, each frame with another
   camera, low_pass, scale_modifier and n_alive than the captured frame
   0, and 5 chained training steps from phase 4's perturbed state, each
   with another camera, ground truth, low_pass, xyz_lr and n_alive; the
   launch counters count each compiled call once (replays included); a
   replayed step and frame make no synchronising call. Recorded for the
   eager and the compiled path: host ms per step and per frame (each
   call synchronised, in turns, and 10 calls queued), the device's busy
   time and operations and the host's launch calls per call
   (torch.profiler), CUDA-event ms, peak and reserved memory over three
   calls from a fresh CompiledStep (the capture's included), and the
   captures (key, ms).

It prints its wall time, the nvidia-smi line, one {"kernels": [...]} line
(each kernel's launches in phase 4, and in phases 8, 9, 10, 11, 12, 13
and 15, and its ms and bound ms at phase 12's tiers) and, last,
the {"ok": true, "device": {...}} line; with --out it also writes every
number it took to that JSON file, and B2's tiles and M at the Trainer step
to b2_trainer_step.npz beside it (the input of chip_ablate.py --b2-step).
"""

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import pickle
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import _build
from rain_tpu_torch import config
from rain_tpu_torch import entry as entry_mod
from rain_tpu_torch.data import colmap as colmap_io
from rain_tpu_torch.data import images
from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.data.cameras import Camera, fov2focal
from rain_tpu_torch.data.dataset import SceneData, nerfpp_norm
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import knn as knn_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.sh import rgb_to_sh_dc, sh_dc_to_rgb
from rain_tpu_torch.parallel import distributed, launch, sharding
from rain_tpu_torch.scripts import e2e_long
from rain_tpu_torch.scripts import knn_deviation
from rain_tpu_torch.scripts import metrics as metrics_cli
from rain_tpu_torch.scripts import probe_scale
from rain_tpu_torch.scripts import production_30k
from rain_tpu_torch.scripts import render as render_cli
from rain_tpu_torch.scripts import sustained_growth
from rain_tpu_torch.scripts import train as train_cli
from rain_tpu_torch.tools import combine_masks
from rain_tpu_torch.train import checkpoint
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import step
from rain_tpu_torch.train import trainer as trainer_mod

ROOT = Path(__file__).resolve().parent

DEV = torch.device("cuda")
WIDTH, HEIGHT = 1297, 840            # garden at images_4 (bench.py:58)
N_GAUSS, MAX_INSTANCES, LOG_SCALE = 262_144, 786_432, -4.5   # bench.py:43
SH_DEGREE = 3
N_POSES = 5
BG = (0.0, 0.0, 0.0)
LOW_PASS = 0.3
XYZ_LR = 1.6e-4                                              # bench.py:85
OPT_LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05,      # bench.py:79
              "scaling_lr": 0.005, "rotation_lr": 0.001}
# H100 SXM published peaks: HBM bytes/s, and f32 operations/s outside
# the tensor cores. The published 67 TFLOP/s counts a fused multiply-add
# as two operations, as the counts below count a product and a sum. The
# kernels are built with -fmad=false (to round as their plain versions),
# which halves the rate they can reach; that is a choice of the build,
# not a floor of the function, so a bound takes the full rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# cycles of the spin kernel queued ahead of a timed call (~1 ms)
SPIN_CYCLES = 2_000_000
# f32 operations per (pixel, instance) pair of the compositor: the power
# (2 sub, 7 mul, 2 add) plus exp, the opacity product and the clamp for
# every evaluated pair; 1 - alpha, T·(1 - alpha), alpha·T, the four
# weighted channel sums (2 each) and the alpha sum for a composited one
OPS_EVAL, OPS_COMP = 14, 12
# the backward compositor (B4): the same 14 to re-evaluate a pair; for a
# composited one c·g (5), 1 - alpha, alpha·T, the running sum (2),
# dL/dalpha (4), T (1), dL/dG and dL/dpower (2), the three moments (3),
# the gradient terms (19), and the nine adds of its share of the pixel
# sums
OPS_BWD_COMP = 47


def garden_proxy_state_arrays(seed=0):
    """bench.py:58-72's 262k tier, with random f_rest (sigma 0.1) so SH
    degree 3 does real work."""
    rng = np.random.default_rng(seed)
    n = N_GAUSS
    pts = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                          rng.uniform(2.0, 12.0, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return dict(
        xyz=pts, f_dc=rgb_to_sh_dc(cols)[:, None, :],
        f_rest=rng.normal(0, 0.1, (n, 15, 3)).astype(np.float32),
        scaling=np.full((n, 3), LOG_SCALE, np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n, 1), -1.0, np.float32))


def perturbed(arrays, seed=1):
    """The scene the training steps start from: xyz noise (sigma 2 mm of a
    6 m wide scene), opacity logits +1 and SH DC +0.3 on every Gaussian."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    out["xyz"] = (arrays["xyz"] +
                  rng.normal(0, 2e-3, arrays["xyz"].shape)).astype(np.float32)
    out["opacity"] = arrays["opacity"] + np.float32(1.0)
    out["f_dc"] = arrays["f_dc"] + np.float32(0.3)
    return out


def pose(k, width=WIDTH, height=HEIGHT):
    """Pose k of a short sideways pan around bench.py's camera."""
    yaw = 0.04 * (k - N_POSES // 2)
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return Camera(uid=k, image_name=f"pose{k}", R=R,
                  T=np.array([0.15 * (k - N_POSES // 2), 0.0, 0.0]),
                  fovx=1.0, fovy=0.7, image=None, width=width,
                  height=height)


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def stage_hook(seen, events=None):
    """An on_stage hook that keeps each stage's result in `seen` and, with
    `events` (a list), appends a CUDA event after each stage."""
    def on_stage(name, value):
        seen[name] = value
        if events is not None:
            events.append(_event())
    return on_stage


def render_frame(state, cam, width, height, events=None):
    """eval_render of one view with an on_stage hook. Returns the output
    and {stage: result} (see ops.render.STAGES). With `events` (a list),
    appends a CUDA event before the frame and one after each stage."""
    bg = torch.tensor(BG, device=state.params.xyz.device)
    seen = {}
    if events is not None:
        events.append(_event())
    out = step.eval_render(state, cam, bg, LOW_PASS, width=width,
                           height=height, sh_degree=SH_DEGREE,
                           max_instances=MAX_INSTANCES,
                           on_stage=stage_hook(seen, events))
    if tuple(seen) != render_ops.STAGES:
        raise AssertionError(f"stages seen: {tuple(seen)}")
    return out, seen


TRAIN_STAGES = (render_ops.STAGES + ("loss",) + render_ops.BACKWARD_STAGES +
                step.TRAIN_STAGES[1:])


def train(state, opt, cam, gt, width, height, events=None,
          max_instances=MAX_INSTANCES):
    """One train_step with an on_stage hook. Returns (state, opt, aux) and
    {stage: result}; with `events`, as render_frame."""
    seen = {}
    if events is not None:
        events.append(_event())
    out = step.train_step(
        state, opt, cam, gt, torch.tensor(BG, device=gt.device), LOW_PASS,
        XYZ_LR, width=width, height=height, sh_degree=SH_DEGREE,
        max_instances=max_instances, opt_cfg_leaves=OPT_LEAVES,
        on_stage=stage_hook(seen, events))
    if tuple(seen) != TRAIN_STAGES:
        raise AssertionError(f"training stages seen: {tuple(seen)}")
    return out, seen


# (name, source, the TPU kernel it replaces) of B1, B3, B4 and B2
KERNELS = (
    ("expand_instances", "rain_tpu_torch/csrc/expand.cu",
     "rain_tpu/ops/expand.py:49"),
    ("composite_forward", "rain_tpu_torch/csrc/tile_render_fwd.cu",
     "rain_tpu/ops/tile_render.py:212"),
    ("composite_backward", "rain_tpu_torch/csrc/tile_render_bwd.cu",
     "rain_tpu/ops/tile_render.py:279"),
    ("reduce_instances", "rain_tpu_torch/csrc/reduce.cu",
     "rain_tpu/ops/expand.py:145"),
)


def bound(nbytes, ops):
    """(the least time in ms for these bytes and f32 operations on the
    H100, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes"


def step_kernels(seen, width, height, max_instances):
    """B1–B4 of one training step, on the inputs the step gave them (its
    on_stage hook). Returns ({kernel: (its wrapper's call, its plain
    version's call, (the library call's name, the call) or None, bytes,
    f32 operations)}, the step's work): the bytes count each input read
    once and each output written once, the compositors' operations the
    pairs that this step's data composites, each evaluated and composited
    once (a pair that is evaluated and composites nothing is work that a
    cull could skip, so it is no floor; the evaluated pairs are kept in
    the work for the record); instances past the tier are dropped, so
    min(instances, M) columns count."""
    (d_args, d_kw), b3_args = kernel_inputs(seen, width, height,
                                            max_instances)
    n, m = d_args[0].shape[1], max_instances
    total = int(d_args[2][-1])
    live = min(total, m)
    n_eval, n_comp = tile_render.composite_work(*b3_args)
    n_tiles = b3_args[1].shape[0]
    b4_args = seen["composite_bwd_B4"][0]
    d_rank, exc, tiles_n, _ = seen["reduce_B2"]
    # B4 re-evaluates each pixel's pairs up to its n_contrib and
    # differentiates the composited ones (the forward's)
    b4_eval = int(b4_args[5][..., tile_render.CH_NCONTRIB].sum())
    rows = tile_render.GRAD_ROWS
    work = {
        "n": n, "m": m, "total": total, "n_tiles": n_tiles,
        "b1_bytes": (10 * 4 + 4 + 8 + 4 + 4) * n + (10 * 4 + 8) * m,
        "b3_pairs_evaluated": n_eval, "pairs_composited": n_comp,
        "b3_ops": (OPS_EVAL + OPS_COMP) * n_comp,
        "b3_bytes": 10 * 4 * live + 2 * 4 * n_tiles +
        n_tiles * 256 * 8 * 4,
        "b4_pairs_evaluated": b4_eval,
        "b4_ops": (OPS_EVAL + OPS_BWD_COMP) * n_comp,
        "b4_bytes": 2 * rows * 4 * live + 4 * n_tiles +
        2 * n_tiles * 256 * 8 * 4,
        "b2_bytes": rows * 4 * live + (8 + 4) * n + rows * 4 * n,
        "b2_ops": rows * live}
    seg_lengths = tiles_n.to(torch.int64).expand(rows, n).contiguous()
    seg_data = d_rank[:, :live].contiguous()
    kernels = {
        "expand_instances": (
            lambda: expand_ops.expand_instances(*d_args, **d_kw),
            lambda: expand_ops.expand_instances_torch(*d_args, **d_kw),
            ("repeat_interleave", lambda: torch.repeat_interleave(
                d_args[0], d_args[1], dim=1, output_size=total)),
            work["b1_bytes"], 0),
        "composite_forward": (
            lambda: tile_render.composite_forward(*b3_args),
            lambda: tile_render.composite_forward_torch(*b3_args),
            None, work["b3_bytes"], work["b3_ops"]),
        "composite_backward": (
            lambda: tile_render.composite_backward(*b4_args),
            lambda: tile_render.composite_backward_torch(*b4_args),
            None, work["b4_bytes"], work["b4_ops"]),
        "reduce_instances": (
            lambda: expand_ops.reduce_instances(d_rank, exc, tiles_n),
            lambda: expand_ops.reduce_instances_torch(d_rank, exc, tiles_n),
            ("segment_reduce", lambda: torch.segment_reduce(
                seg_data, "sum", lengths=seg_lengths, axis=1)),
            work["b2_bytes"], work["b2_ops"]),
    }
    return kernels, work


# the CUDA runtime's launch calls: kernels, graphs, copies and fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(run_once, reps=3):
    """torch.profiler over `reps` calls: per call, the device's busy time
    (the sum of its kernels' and copies' times; one stream, so they do not
    overlap), the number of device operations launched and the largest of
    them by time, and the host's launch calls (HOST_LAUNCH_CALLS)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_once()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / reps
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    return {
        "busy_ms": busy,
        "launches": sum(e.count for e in ops) / reps,
        "top": [[e.key[:100], e.self_device_time_total / 1e3 / reps,
                 e.count / reps] for e in ops[:12]],
        "host_launches": sum(e.count for e in prof.key_averages()
                             if e.key in HOST_LAUNCH_CALLS) / reps,
    }


def device_ms(fn, reps=20):
    """Median over `reps` calls of `fn`, after warm-up, of the time between
    CUDA events recorded just before and just after the call. A spin
    kernel queued first keeps the stream busy while the host enqueues the
    events and the call, so a call whose host work fits in the spin (each
    kernel's wrapper, the library call) is timed on the device alone, not
    with the host's launch gap, which exceeds a short kernel's run time.
    The plain versions launch more than the spin covers and are timed with
    their host gaps."""
    for _ in range(2 if reps < 5 else 3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = _event()
        fn()
        end = _event()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps):
    """Host-clock times in ms of `reps` calls of `fn`, each ending in a
    synchronize: (median, [q25, q75], max, all)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return (float(np.median(times)),
            [float(np.percentile(times, q)) for q in (25, 75)],
            float(np.max(times)), times)


def stage_split(run, stages, reps=10):
    """Median over `reps` runs of the CUDA-event interval of each stage;
    `run(events)` appends one event before the run and one after each
    stage."""
    split = {s: [] for s in stages}
    for _ in range(reps):
        events = []
        run(events)
        torch.cuda.synchronize()
        for s, a, b in zip(stages, events, events[1:]):
            split[s].append(a.elapsed_time(b))
    return {s: float(np.median(v)) for s, v in split.items()}


def occupancy(lib):
    """Resident blocks per SM of a kernel (its C entry
    rain_{expand,reduce}_occupancy or
    rain_composite_{forward,backward}_occupancy)."""
    entry = {"expand": "rain_expand_occupancy",
             "reduce": "rain_reduce_occupancy",
             "tile_render_fwd": "rain_composite_forward_occupancy",
             "tile_render_bwd": "rain_composite_backward_occupancy"}[lib]
    blocks = ctypes.c_int(0)
    _build.launch(_build.kernel(lib, entry, (ctypes.c_void_p,)), DEV,
                  ctypes.addressof(blocks))
    return blocks.value


def nvidia_smi():
    """The cards' names and power limits as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def tests_module(name):
    """A helper module of tests/ that imports numpy and torch only."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# B1-B4 against their plain versions, shared with the card tests
STEP = tests_module("torch_step_kernels")
bitwise_equal, compare_tiles = STEP.bitwise_equal, STEP.compare_tiles
kernel_inputs = STEP.kernel_inputs
compare_forward, compare_backward = STEP.compare_forward, STEP.compare_backward


def b1_edge_cases():
    """B1 against its plain version at the edge cases of
    tests/torch_expand_cases.py, bit for bit, at the main path's N and M
    unless the case sets them. Returns {case: (N, M, instances)}."""
    cases = tests_module("torch_expand_cases")
    seen = {}
    for name in cases.CASES:
        args, kw = cases.expand_case(name, N_GAUSS, MAX_INSTANCES)
        args = [a.to(DEV) for a in args]
        n, m = args[0].shape[1], kw["max_instances"]
        total = int(args[2][-1]) if n else 0
        # NaN in the allocator's cache, so that an unwritten column shows
        junk = torch.full((12 * m + 8192,), float("nan"), device=DEV)
        del junk
        cols, keys = expand_ops.expand_instances(*args, **kw)
        cols_p, keys_p = expand_ops.expand_instances_torch(*args, **kw)
        if not (torch.equal(keys, keys_p) and bitwise_equal(cols, cols_p)):
            raise AssertionError(f"B1 differs from its plain version in "
                                 f"case {name} (N={n}, M={m})")
        print(f"B1 {name} (N={n}, M={m}, {total} instances): bitwise equal "
              f"to its plain version")
        seen[name] = (n, m, total)
    return seen


def b2_edge_cases():
    """B2 against its plain version at the edge cases of
    tests/torch_reduce_cases.py, bit for bit, at the main path's N and M
    unless the case sets them, with NaN in the allocator's cache first so
    that an output element the kernel failed to write shows. Returns
    {case: (N, M, instances, longest segment)}."""
    cases = tests_module("torch_reduce_cases")
    seen = {}
    for name in cases.CASES:
        d, exc, tiles = (a.to(DEV) for a in cases.reduce_case(
            name, N_GAUSS, MAX_INSTANCES))
        n, m = exc.shape[0], d.shape[1]
        junk = torch.full((cases.ROWS * n + 8192,), float("nan"),
                          device=DEV)
        del junk
        got = expand_ops.reduce_instances(d, exc, tiles)
        want = expand_ops.reduce_instances_torch(d, exc, tiles)
        if not bitwise_equal(got, want):
            raise AssertionError(f"B2 differs from its plain version in "
                                 f"case {name} (N={n}, M={m})")
        total = int(tiles.sum()) if n else 0
        longest = int(tiles.max()) if n else 0
        print(f"B2 {name} (N={n}, M={m}, {total} instances, longest "
              f"segment {longest}): bitwise equal to its plain version")
        seen[name] = (n, m, total, longest)
    return seen


def counters():
    return {"expand_instances": expand_ops.expand_instances,
            "composite_forward": tile_render.composite_forward,
            "composite_backward": tile_render.composite_backward,
            "reduce_instances": expand_ops.reduce_instances}


def reset_counts():
    set_counts({k: 0 for k in counters()})


def set_counts(counts):
    for k, f in counters().items():
        f.launches = counts[k]


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def same_bits(a, b):
    """(params, AdamState, stats) tuples are equal bit for bit."""
    (pa, oa, sa), (pb, ob, sb) = a, b
    return all(torch.equal(x, y) for x, y in zip(
        list(pa) + list(oa.mu) + list(oa.nu) + list(sa),
        list(pb) + list(ob.mu) + list(ob.nu) + list(sb)))


def snapshot(state, opt):
    return (state.params, opt,
            [getattr(state, k) for k in gmod.STAT_FIELDS])


def host_snapshot(state, opt):
    """``snapshot`` copied to host memory."""
    def host(xs):
        return gmod.GaussianParams(*[x.cpu() for x in xs])
    return (host(state.params),
            adam_mod.AdamState(host(opt.mu), host(opt.nu), opt.step.cpu()),
            [getattr(state, k).cpu() for k in gmod.STAT_FIELDS])


# --- 7. the Trainer loop -------------------------------------------------
TRAINER_TEST_POSES = (5, 6)       # two more poses of the pan, held out
TRAINER_ITERS = 60
BITWISE_AT = 25                   # past the overflow retry and the abe round
PROFILE_ITERS = range(10, 20)     # profiled in the pipelined run B
PROFILE_STEPS = f"{PROFILE_ITERS[0]}-{PROFILE_ITERS[-1]}"
HOST_ITERS = range(4, 20)         # timed: after the retry, before round 20
TRACE = tests_module("torch_trainer_trace")   # the Trainer's recorder


def trainer_scene(arrays):
    """The 262k garden proxy as a Trainer scene: its points, colours
    clip(sh_dc_to_rgb(f_dc), 0, 1), the 5 poses of phase 3 as train cameras
    and two more poses of the pan as test cameras, each with the proxy's
    render as its ground truth; nerf_radius from nerfpp_norm."""
    state = gmod.from_arrays(**arrays, device=DEV)
    bg = torch.tensor(BG, device=DEV)

    def camera(k):
        cam = pose(k)
        out = step.eval_render(state, cam.render_inputs(DEV), bg, LOW_PASS,
                               width=WIDTH, height=HEIGHT,
                               sh_degree=SH_DEGREE,
                               max_instances=MAX_INSTANCES)
        cam.image = torch.clamp(out.render, 0.0, 1.0).cpu().numpy()
        return cam

    train_cams = [camera(k) for k in range(N_POSES)]
    norm = nerfpp_norm(train_cams)
    return SceneData(
        train_cameras=train_cams,
        test_cameras=[camera(k) for k in TRAINER_TEST_POSES],
        points=arrays["xyz"],
        colors=np.clip(sh_dc_to_rgb(arrays["f_dc"][:, 0, :]), 0.0,
                       1.0).astype(np.float32),
        nerf_radius=norm["radius"], nerf_translate=norm["translate"])


def trainer_configs(**system):
    """The ours_new preset (c2f on) with warmup_iter 30; 60 iterations with
    densify rounds at 20 (abe_split) and 40, the opacity reset at 50; a
    capacity that the first round grows (262,144 > 0.6 · 393,216) and an
    instance tier that iteration 1 overflows."""
    cfgs = config.extract_all(config.build_parser("chip_smoke").parse_args(
        []))
    cfgs["rain"] = dataclasses.replace(cfgs["rain"], ours_new=True)
    cfgs = config.apply_method_presets(cfgs)
    cfgs["rain"] = dataclasses.replace(cfgs["rain"], warmup_iter=30)
    # densify_until = 30 + warmup 30: rounds at 20 and 40, none at 60
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], iterations=TRAINER_ITERS, densify_from_iter=10,
        densification_interval=20, densify_until_iter=30,
        opacity_reset_interval=50)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], **{"capacity": 393_216, "max_instances": 262_144,
                           "pipeline": 1, "seed": 0, **system})
    return cfgs


def timed(fn, *a, **kw):
    """fn's result and its time in ms on the host clock, with a synchronize
    on each side."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


@contextlib.contextmanager
def recorded(capture=None, eager=False):
    """A Trainer's loop recorded while active by the wrappers of
    tests/torch_trainer_trace.py, which the Trainer tests share: every
    step's call (the Trainer's calls of its CompiledStep, whose replays
    never reach the step module), round, reset and growth, each round and
    growth timed with a synchronize on each side. ``capture`` (a
    KernelCapture) wraps the step first. ``eager`` replaces the
    CompiledStep's methods by the eager step and render: the run the
    compiled one is held to."""
    with TRACE.Patches() as patches:
        if eager:
            patches.setattr(compiled.CompiledStep, "train_step",
                            lambda self, *a, **kw: step.train_step(*a, **kw))
            patches.setattr(compiled.CompiledStep, "eval_render",
                            lambda self, *a, **kw: step.eval_render(*a,
                                                                    **kw))
        if capture is not None:
            patches.setattr(compiled.CompiledStep, "train_step",
                            capture.wrap(compiled.CompiledStep.train_step))
        yield TRACE.record(patches.setattr, compiled.CompiledStep,
                           densify_mod, gmod, timer=timed)


@torch.no_grad()
def trainer_step_kernels(seen, width, height, max_instances, state):
    """B1–B4 of one Trainer step: each against its plain version on the
    inputs the step gave them, bit for bit (compare_forward,
    compare_backward), then its time (device_ms) beside its bound and the
    library call's time. Returns the record."""
    what = (f"Trainer step {width}x{height}, {state.n_alive} of "
            f"{state.capacity} rows alive")
    errs = dict(zip(("expand_instances", "composite_forward"),
                    compare_forward(seen, width, height, what,
                                    max_instances)))
    errs["reduce_instances"], errs["composite_backward"], b2_scale = \
        compare_backward(seen, what)
    kernels, work = step_kernels(seen, width, height, max_instances)
    _, exc, tiles, _ = seen["reduce_B2"]
    segs = segment_stats(exc, tiles, max_instances, state.n_alive)
    print(f"B2 segments at the Trainer step: {json.dumps(segs)}")
    rows = []
    for name, (call, _, library, nbytes, ops) in kernels.items():
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "max_abs_err": errs[name],
                     "ms": device_ms(call), "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library": library[0] if library else None,
                     "library_ms": device_ms(library[1]) if library
                     else None})
    print("trainer step kernels (ms, bound ms): " + json.dumps(
        {r["name"]: [r["ms"], r["bound_ms"]] for r in rows}))
    return {"n_alive": state.n_alive, "capacity": state.capacity,
            "work": work, "b2_max_abs_per_row": b2_scale,
            "b2_segments": segs, "kernels": rows}


class KernelCapture:
    """Runs trainer_step_kernels on the first step a Trainer dispatches
    that ``when(state, kw)`` selects (kw: train_step's keywords) and that
    does not overflow its tier: in phase 7 the first at a capacity above
    the initial one (after a growth, so with dead rows at the tail of the
    state), in phase 9 the first above the initial instance tier (the
    retried iteration 1). Such a step runs as the eager train_step with an
    on_stage hook (a replay has none; the two give the same bits, phase
    15), and the checks run as the step returns; their launches are not
    counted."""

    def __init__(self, when):
        self.when = when
        self.result = None
        self.b2_tiles = None   # B2's tiles and M there, for chip_ablate.py

    def wrap(self, train_step):
        """``train_step``: CompiledStep.train_step, which the wrapper
        replaces."""
        def wrapped(steps, state, opt, *a, **kw):
            if self.result is not None or not self.when(state, kw):
                return train_step(steps, state, opt, *a, **kw)
            seen = {}
            out = step.train_step(state, opt, *a, on_stage=stage_hook(seen),
                                  **kw)
            if not bool(out[2].instance_overflow):
                counts = read_counts()
                self.result = trainer_step_kernels(
                    seen, kw["width"], kw["height"], kw["max_instances"],
                    state._replace(n_alive=int(state.n_alive)))
                set_counts(counts)
                self.b2_tiles = (seen["reduce_B2"][2].cpu().numpy(),
                                 kw["max_instances"])
            return out
        return wrapped


def loop_summary(trace, first=1):
    """One Trainer run, from its trace. Every dispatched step as (tier,
    capacity, n_alive, loss, overflow, num_instances). A retry is a step at
    a tier above the previous step's; the step that forced it is the first
    that overflowed since the last retry, and it and every step queued
    after it, up to the retry, were thrown away. The rest are the kept
    steps, one per iteration from ``first`` on, and the host ms of each
    iteration runs from its kept step's call to the next one's. Also each
    retry (its time to the next step's call), round, growth and reset."""
    calls, t = TRACE.calls(trace), trace["t"]
    at = [i for i, c in enumerate(calls) if c[0] == "step"]
    steps = [calls[i][6:8] + calls[i][10:11] + v
             for i, v in zip(at, TRACE.steps(trace))]
    thrown, retries, since = set(), [], 0
    for k in range(1, len(steps)):
        if steps[k][0] > steps[k - 1][0]:
            cause = next(j for j in range(since, k) if steps[j][4])
            thrown.update(range(cause, k))
            retries.append({
                "step": k, "iteration": first + k - len(thrown),
                "tier_before": steps[k - 1][0], "tier_after": steps[k][0],
                "instances": steps[cause][5],
                "ms": (t[k + 1] - t[k]) * 1e3 if k + 1 < len(t) else None})
            since = k
    kept = [k for k in range(len(steps)) if k not in thrown]
    iteration_ms = {first + j: (t[kept[j + 1]] - t[kept[j]]) * 1e3
                    for j in range(len(kept) - 1)}
    rounds = []
    for i, c in enumerate(calls):
        if c[0] == "densify":
            nxt = next((calls[j][10] for j in range(i + 1, len(calls))
                        if calls[j][0] == "step"), None)
            rounds.append({"capacity": c[1], "n_alive_in": c[2],
                           "abe_split": c[3], "use_size_threshold": c[4],
                           "info": c[5]._asdict(), "ms": trace["ms"][i],
                           "n_alive_next_step": nxt})
    growths = [{"from": c[1], "to": c[2], "ms": trace["ms"][i]}
               for i, c in enumerate(calls) if c[0] == "grow"]
    return {"steps": steps, "kept": [steps[k] for k in kept],
            "iteration_ms": iteration_ms, "retries": retries,
            "rounds": rounds, "growths": growths,
            "resets": sum(c[0] == "reset" for c in calls)}


def quartiles(ms):
    return {"median": float(np.median(ms)),
            "q25_q75": [float(np.percentile(ms, q)) for q in (25, 75)],
            "n": len(ms)}


def live_rows(tr):
    """The live rows of a Trainer's params, moments and statistics."""
    n = tr.state.n_alive
    return ([x[:n] for x in tr.state.params] +
            [x[:n] for x in tr.opt_state.mu] +
            [x[:n] for x in tr.opt_state.nu] +
            [getattr(tr.state, k)[:n] for k in gmod.STAT_FIELDS])


def count_syncs(fn):
    """The synchronising CUDA calls that fn makes (PyTorch's sync debug
    mode warns once per call): (their number, the file:line of the Python
    frame that made each). Only the warnings of a synchronising call count:
    the mode's own notice, the first time it is set, that it is a
    prototype feature that may miss some synchronising operations does
    not."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return len(sites), sites


def segment_stats(exc, tiles, m, n_alive, chunk=1024):
    """B2's segments at a step: the instances per live Gaussian, the length
    of the non-empty segments (mean, p99, max), for a kernel with one
    thread per row and Gaussian (a warp per 32 consecutive Gaussians of a
    row) the mean over warps of the longest segment over the mean one, and
    for csrc/reduce.cu (chunks of 1024 instances) the segments that run
    past their first chunk, the instances they carry on over and the
    longest carry."""
    end = torch.clamp(exc + tiles, max=m)
    length = torch.clamp(end - exc, min=0)
    live = int(length.sum())
    nz = length[length > 0].double()
    pad = (-length.shape[0]) % 32
    warps = torch.cat([length, length.new_zeros(pad)]).view(-1, 32).double()
    mean = warps.mean(dim=1)
    ratio = warps.max(dim=1).values[mean > 0] / mean[mean > 0]
    first = exc // chunk
    carried = (length > 0) & ((end - 1) // chunk > first)
    carry = (end - (first + 1) * chunk)[carried]
    return {
        "instances": live, "with_instances": int(nz.numel()),
        "per_alive": live / max(n_alive, 1),
        "mean": float(nz.mean()) if nz.numel() else 0.0,
        "p99": float(torch.quantile(nz, 0.99)) if nz.numel() else 0.0,
        "max": int(length.max()) if length.numel() else 0,
        "row_thread_warp_max_over_mean":
            float(ratio.mean()) if ratio.numel() else 0.0,
        "carried_segments": int(carried.sum()),
        "carried_instances": int(carry.sum()),
        "longest_carry": int(carry.max()) if carry.numel() else 0}


def trainer_card_vs_cpu(arrays):
    """KNN and a densify round on the card against the port's CPU path."""
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.normal(0, 1, (20_000, 3)).astype(np.float32))
    torch.testing.assert_close(knn_ops.mean_dist3_auto(pts.to(DEV)).cpu(),
                               knn_ops.mean_dist3_auto(pts), rtol=1e-6,
                               atol=0.0)
    small = {k: v[:3000] for k, v in arrays.items()}
    small["scaling"] = rng.uniform(-5.0, -2.5, (3000, 3)).astype(np.float32)
    small["rotation"] = rng.normal(size=(3000, 4)).astype(np.float32)
    accum = rng.uniform(0, 4e-4, 3000).astype(np.float32)
    noise = torch.from_numpy(rng.normal(size=(2, 12_000, 3)).astype(
        np.float32))
    outs = []
    for dev in (DEV, torch.device("cpu")):
        st = gmod.grow_capacity(gmod.from_arrays(**small, device=dev),
                                12_000)
        st.xyz_gradient_accum[:3000] = torch.from_numpy(accum).to(dev)
        st.denom[:3000] = 1.0
        outs.append(densify_mod.densify_and_prune(
            st, adam_mod.init(st.params), noise.to(dev), max_grad=2e-4,
            min_opacity=0.005, extent=5.0, percent_dense=0.01,
            divide_ratio=0.7, abe_split=True))
    (sc, _, ic), (sh, _, ih) = outs
    if ic != ih or ic.n_split == 0 or ic.n_cloned == 0:
        raise AssertionError(f"densify card vs CPU: {ic} / {ih}")
    for a, b in zip(sc.params, sh.params):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)
    print(f"trainer: KNN (20k) and densify_and_prune (3k, {ic}) on the "
          f"card match the CPU path")
    return ic._asdict()


def trainer_phase(arrays, out=None):
    """The Trainer loop at full width (phase 7). Returns its record; with
    ``out`` (a directory) it also writes there the tiles of B2's input at
    the Trainer step where the kernels are held (b2_trainer_step.npz, for
    chip_ablate.py --b2-step)."""
    scene = trainer_scene(arrays)
    rec = {"nerf_radius": scene.nerf_radius,
           "card_vs_cpu_densify": trainer_card_vs_cpu(arrays)}
    # the exact KNN at N, timed alone; create_from_pcd must give its scales
    d2, knn_ms = timed(knn_ops.mean_dist3_matmul,
                       torch.from_numpy(scene.points).to(DEV))
    knn_scales = torch.log(torch.sqrt(torch.maximum(
        d2, torch.tensor(1e-7, device=DEV))))[:, None].expand(-1, 3)

    def log(msg):
        print(f"  trainer: {msg}")

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        # A: the main path, pipelined, 60 iterations
        with recorded() as trace_a:
            tr = trainer_mod.Trainer(scene, trainer_configs(), tmp / "a",
                                     log_fn=log, tensorboard=False)
            if tr.state.params.xyz.device.type != DEV.type:
                raise AssertionError("the Trainer is not on the card")
            if tr.state.n_alive != N_GAUSS or not bitwise_equal(
                    tr.state.params.scaling[:N_GAUSS], knn_scales) or not \
                    bool(torch.isfinite(knn_scales).all()):
                raise AssertionError(f"create_from_pcd did not run the exact "
                                     f"KNN at {N_GAUSS} points")
            del d2, knn_scales
            r0 = tr.report(0)
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t = time.perf_counter()
            tr.train(iterations=TRAINER_ITERS,
                     test_iterations=(TRAINER_ITERS,),
                     save_iterations=(TRAINER_ITERS,),
                     checkpoint_iterations=(BITWISE_AT, 30))
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t
            launches = read_counts()
            peak_mib = torch.cuda.max_memory_allocated() / 2**20
            held_mib = held / 2**20
        a = loop_summary(trace_a)
        steps, kept = a["steps"], a["kept"]
        # the report at 60, and each of its views rendered again because
        # the training tier could not hold it
        n_frames = len(scene.test_cameras) + 5
        rerenders = tr.report_rerenders
        again = sum(r[0] == TRAINER_ITERS for r in rerenders)
        want = {"expand_instances": len(steps) + n_frames + again,
                "composite_forward": len(steps) + n_frames + again,
                "composite_backward": len(steps),
                "reduce_instances": len(steps)}
        print(f"trainer: launches {launches} for {len(steps)} dispatched "
              f"steps and {n_frames} report frames")
        print(f"trainer: {len(rerenders)} report frames rendered again at a "
              f"tier that holds them: {rerenders}")
        if any(r[3] <= r[2] for r in rerenders):
            raise AssertionError(f"a report re-render at no higher tier: "
                                 f"{rerenders}")
        if launches != want:
            raise AssertionError(f"expected launches {want}")
        if not a["retries"]:
            raise AssertionError("no overflow was retried")
        if any(r["tier_after"] < r["instances"] for r in a["retries"]):
            raise AssertionError("a grown tier is below the reported count")
        if any(s[4] for s in kept) or len(kept) != TRAINER_ITERS or \
                int(tr.opt_state.step) != TRAINER_ITERS:
            raise AssertionError("a kept step overflowed")
        if not a["growths"] or len(a["rounds"]) != 2 or a["resets"] != 1:
            raise AssertionError(f"growths {a['growths']}, rounds "
                                 f"{len(a['rounds'])}, resets {a['resets']}")
        for rnd in a["rounds"]:
            if rnd["n_alive_next_step"] != rnd["info"]["n_alive"]:
                raise AssertionError(f"n_alive after a round: {rnd}")
        if not all(math.isfinite(s[3]) for s in steps) or not all(
                bool(torch.isfinite(x).all()) for x in tr.state.params):
            raise AssertionError("non-finite loss or params")
        r60 = tr.history[-1]
        if not r60["test"]["psnr"] > r0["test"]["psnr"]:
            raise AssertionError(f"held-out PSNR {r0} -> {r60}")
        ply = checkpoint.load_ply_snapshot(
            tmp / "a" / "point_cloud" / f"iteration_{TRAINER_ITERS}" /
            "point_cloud.ply")
        if ply.n_alive != tr.state.n_alive:
            raise AssertionError("the PLY does not reload with n_alive rows")
        cam = scene.train_cameras[0]
        cam_in = cam.render_inputs(DEV)
        gt = torch.from_numpy(cam.image).to(DEV)
        # one step as the Trainer takes it (sh_degree 0, the active degree
        # under ours_new), and one bucketed to the 16-pixel tile grid with
        # its loss masked to the true size; the Trainer's flag read is one
        # more wait
        bw, bh = -(-WIDTH // 16) * 16, -(-HEIGHT // 16) * 16
        gt_bucket = torch.zeros((3, bh, bw), device=DEV)
        gt_bucket[:, :HEIGHT, :WIDTH] = gt

        def sync_step(size, target, real_wh):
            step.train_step(
                tr.state, tr.opt_state, cam_in, target, tr.background,
                tr.low_pass, XYZ_LR, width=size[0], height=size[1],
                sh_degree=0, max_instances=tr.max_instances,
                opt_cfg_leaves=OPT_LEAVES, real_wh=real_wh)

        syncs = {
            "exact": count_syncs(lambda: sync_step((WIDTH, HEIGHT), gt,
                                                   None)),
            "bucketed": count_syncs(lambda: sync_step(
                (bw, bh), gt_bucket, (WIDTH, HEIGHT)))}
        print(f"trainer: synchronising calls per train_step: "
              f"{json.dumps(syncs)}")
        if any(n for n, _ in syncs.values()):
            raise AssertionError(f"train_step waits for the card: {syncs}")
        iter_ms = a["iteration_ms"]
        rec.update({
            "knn_ms": knn_ms, "init_report": r0, "final_report": r60,
            "loop_s": loop_s, "launches": launches,
            "steps_dispatched": len(steps), "report_frames": n_frames,
            "steps": steps, "rounds": a["rounds"], "growths": a["growths"],
            "retries": a["retries"], "resets": a["resets"],
            "final_tier": tr.max_instances, "final_n_alive": tr.state.n_alive,
            "final_capacity": tr.state.capacity,
            "host_ms_pipeline1": quartiles([iter_ms[i] for i in HOST_ITERS]),
            "host_ms_pipeline1_all": iter_ms,
            "peak_mib": peak_mib, "held_mib_before_loop": held_mib,
            "syncs_per_step": syncs["exact"][0],
            "syncs_per_bucketed_step": syncs["bucketed"][0],
            "sync_sites": {k: v[1] for k, v in syncs.items()},
            "report_rerenders": rerenders})
        snap_a = host_snapshot(tr.state, tr.opt_state)
        captures_a = [[list(k), ms] for k, ms in tr._steps.captures]
        keys_a = len(tr._step_keys)
        del tr, ply, cam_in, gt, gt_bucket

        # E: run A again with CompiledStep's methods replaced by the eager
        # step and render: the same steps, rounds, reports and state, bit
        # for bit
        with recorded(eager=True) as trace_e:
            te = trainer_mod.Trainer(scene, trainer_configs(), tmp / "e",
                                     log_fn=log, tensorboard=False)
            e0 = te.report(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            te.train(iterations=TRAINER_ITERS,
                     test_iterations=(TRAINER_ITERS,),
                     save_iterations=(TRAINER_ITERS,),
                     checkpoint_iterations=(BITWISE_AT, 30))
            torch.cuda.synchronize()
            peak_e = torch.cuda.max_memory_allocated() / 2**20
        e = loop_summary(trace_e)
        if e["steps"] != a["steps"] or e0 != r0 or \
                te.history[-1] != r60 or \
                [r["info"] for r in e["rounds"]] != \
                [r["info"] for r in a["rounds"]] or \
                te._steps.captures or not same_bits(
                    host_snapshot(te.state, te.opt_state), snap_a):
            raise AssertionError("the Trainer through its compiled step "
                                 "differs from the eager one")
        e_ms = quartiles([e["iteration_ms"][i] for i in HOST_ITERS])
        rec["compiled_vs_eager"] = {
            "host_ms_compiled": rec["host_ms_pipeline1"],
            "host_ms_eager": e_ms, "peak_mib_compiled": peak_mib,
            "peak_mib_eager": peak_e, "captures": captures_a,
            "step_keys": keys_a, "steps": len(a["steps"])}
        print(f"trainer: through the compiled step (A) and the eager one "
              f"(E): {len(a['steps'])} steps, rounds, reports and state "
              f"bit for bit; host ms per iteration (median, iterations "
              f"{HOST_ITERS[0]}-{HOST_ITERS[-1]}) "
              f"{rec['host_ms_pipeline1']['median']:.2f} against "
              f"{e_ms['median']:.2f}; peak {peak_mib:.0f} and {peak_e:.0f} "
              f"MiB; {len(captures_a)} captures (key, ms) {captures_a}")
        del te, snap_a

        # B: the same seed, pipelined, to 25: profiled over 10 iterations,
        # and B1-B4 held against their plain versions at iteration 21, the
        # first step after the growth (run A's inputs: B equals A bit for
        # bit, and its launches are not counted)
        with np.load(tmp / "a" / f"chkpnt{BITWISE_AT}.npz") as z:
            saved = {k: z[k] for k in z.files}
        first_capacity = trainer_configs()["system"].capacity
        capture = KernelCapture(
            lambda state, kw: state.capacity > first_capacity)
        with recorded(capture):
            tb = trainer_mod.Trainer(
                scene, trainer_configs(profile_steps=PROFILE_STEPS),
                tmp / "b", log_fn=log, tensorboard=False)
            tb.train(iterations=BITWISE_AT, test_iterations=(),
                     save_iterations=())
        if capture.result is None:
            raise AssertionError("no step ran after the capacity grew")
        rec["trainer_step_kernels"] = capture.result
        if out is not None:
            tiles_np, m_step = capture.b2_tiles
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / "b2_trainer_step.npz", tiles=tiles_np, m=m_step)
        got = dict(zip(
            [f"params.{f}" for f in gmod.GaussianParams._fields] +
            [f"mu.{f}" for f in gmod.GaussianParams._fields] +
            [f"nu.{f}" for f in gmod.GaussianParams._fields] +
            list(gmod.STAT_FIELDS), live_rows(tb)))
        if int(saved["n_alive"]) != tb.state.n_alive or \
                int(saved["adam_step"]) != int(tb.opt_state.step) or not \
                all(np.array_equal(v.cpu().numpy(), saved[k])
                    for k, v in got.items()):
            raise AssertionError(f"a second Trainer from the same seed "
                                 f"differs at iteration {BITWISE_AT}")
        # busy time and wall time of the same profiled window
        ops = [e for e in tb.profile.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ops) / 1e3
        if busy <= 0.0:
            raise AssertionError("the profiler recorded no device time")
        n_prof = len(PROFILE_ITERS)
        ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
        rec.update({"device_busy_ms_per_iter": busy / n_prof,
                    "profiled_wall_ms_per_iter": tb.profile_wall_ms / n_prof,
                    "device_idle_share": 1.0 - busy / tb.profile_wall_ms,
                    "device_ops_per_iter": sum(e.count for e in ops) / n_prof,
                    "device_top_per_iter": [
                        [e.key[:100], e.self_device_time_total / 1e3 / n_prof,
                         e.count / n_prof] for e in ops[:12]]})
        print(f"trainer: a second Trainer from seed 0 equals the first bit "
              f"for bit at iteration {BITWISE_AT}")

        # C: pipeline 0 to 25, the same bits as B
        with recorded() as trace_c:
            tc = trainer_mod.Trainer(scene, trainer_configs(pipeline=0),
                                     tmp / "c", log_fn=log,
                                     tensorboard=False)
            tc.train(iterations=BITWISE_AT, test_iterations=(),
                     save_iterations=())
        if (tc.state.n_alive, tc.max_instances, int(tc.opt_state.step)) != (
                tb.state.n_alive, tb.max_instances,
                int(tb.opt_state.step)) or not same_bits(
                snapshot(tc.state, tc.opt_state),
                snapshot(tb.state, tb.opt_state)):
            raise AssertionError("pipeline 0 differs from pipeline 1")
        iter_ms = loop_summary(trace_c)["iteration_ms"]
        rec["host_ms_pipeline0"] = quartiles([iter_ms[i] for i in HOST_ITERS])
        print(f"trainer: pipeline 0 equals pipeline 1 bit for bit at "
              f"iteration {BITWISE_AT}")
        del tb, tc

        # D: resumed from the checkpoint at 30, on to 60
        with recorded() as trace_d:
            td = trainer_mod.Trainer(scene, trainer_configs(), tmp / "d",
                                     log_fn=log, tensorboard=False)
            td.train(iterations=TRAINER_ITERS, test_iterations=(),
                     save_iterations=(),
                     start_checkpoint=str(tmp / "a" / "chkpnt30.npz"))
        resumed = loop_summary(trace_d, first=31)["steps"]
        if td.iteration != TRAINER_ITERS or len(resumed) < 30 or not all(
                math.isfinite(s[3]) for s in resumed):
            raise AssertionError("the resumed Trainer did not reach 60")
        rec["resumed_losses"] = [s[3] for s in resumed]
        rec["resumed_capacity"] = td.state.capacity
        del td
    summary = {k: rec[k] for k in (
        "knn_ms", "loop_s", "steps_dispatched", "final_tier",
        "final_n_alive", "final_capacity", "host_ms_pipeline1",
        "host_ms_pipeline0", "device_busy_ms_per_iter",
        "profiled_wall_ms_per_iter", "device_idle_share", "peak_mib",
        "syncs_per_step", "syncs_per_bucketed_step")}
    summary.update(
        psnr=[r0["test"]["psnr"], r60["test"]["psnr"]],
        rounds_ms=[r["ms"] for r in rec["rounds"]],
        n_alive=[r["info"]["n_alive"] for r in rec["rounds"]],
        growth_ms=[g["ms"] for g in rec["growths"]],
        retry_ms=[r["ms"] for r in rec["retries"]],
        report_rerenders=len(rec["report_rerenders"]))
    print("trainer: " + json.dumps(summary))
    return rec


# --- 8. the CLIs ---------------------------------------------------------
CLI_VIEWS = 10                  # llffhold 2: 5 train and 5 test views
CLI_ITERS = 40
CLI_RESUME = 20                 # the checkpoint the second run starts from
CLI_TIMED = range(5, CLI_ITERS)  # ms per iteration over iterations 5-40
SCENE = tests_module("torch_colmap_scene")   # the COLMAP scene writer
# One PNG step. A render PNG holds each value truncated to k/255, so the
# metrics CLI's image is the report's less d in [0, 1/255) per value (the
# ground truth round-trips exactly: k/255 in f32 times 255 truncates to k
# for every k). By the triangle inequality a view's RMSE moves by less
# than 1/255, so its PSNR by less than 20 log10(r / (r - 1/255)), r the
# quantised view's RMSE; the mean over views by less than the largest.
PNG_STEP = 1.0 / 255.0


@contextlib.contextmanager
def pil_blocked():
    """PIL made unimportable (``sys.modules["PIL"] = None``), as on a
    machine without it: what needs PIL fails here even where it is
    installed."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "PIL" or k.startswith("PIL.")}
    for k in saved:
        del sys.modules[k]
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


def cli_scene(root, arrays):
    """Phase 8's COLMAP scene: one PINHOLE camera at 1297x840 with the
    focal of phase 3's poses, 10 poses of its pan, each image the 262k
    proxy's eval_render there (truncated to uint8, as the render CLI
    writes), and the proxy's 262,144 means as points3D.bin with colours
    round(clip(sh_dc_to_rgb(f_dc), 0, 1) * 255) and a seeded error column.
    Returns the sparse directory."""
    state = gmod.from_arrays(**arrays, device=DEV)
    bg = torch.tensor(BG, device=DEV)
    views = []
    for k in range(CLI_VIEWS):
        cam = pose(k)
        out, _ = trainer_mod.render_whole(
            state, cam.render_inputs(DEV), bg, LOW_PASS, width=WIDTH,
            height=HEIGHT, sh_degree=SH_DEGREE, max_instances=MAX_INSTANCES,
            steps=None)
        img = torch.clamp(out.render, 0.0, 1.0).permute(1, 2, 0).cpu()
        views.append((f"view_{k:02d}.png", cam.R.T, cam.T,
                      (img.numpy() * 255).astype(np.uint8)))
    rgb = np.round(np.clip(sh_dc_to_rgb(arrays["f_dc"][:, 0, :]), 0, 1)
                   * 255).astype(np.uint8)
    err = np.random.default_rng(8).random(N_GAUSS) * 2.0
    cam = pose(0)
    return SCENE.write_colmap_scene(
        root, views, WIDTH, HEIGHT, fov2focal(cam.fovx, WIDTH),
        fov2focal(cam.fovy, HEIGHT), arrays["xyz"], rgb, err)


def cli_argv(src):
    """Phase 8's train CLI flags on the COLMAP scene at ``src``: 5 train and
    5 test views, CLI_ITERS iterations, a report at CLI_ITERS (and at 0,
    which the loop never reaches), a PLY there, a checkpoint at
    CLI_RESUME."""
    return ["-s", str(src), "--num_cams", str(CLI_VIEWS // 2),
            "--iterations", str(CLI_ITERS), "--test_iterations", "0",
            str(CLI_ITERS), "--save_iterations", str(CLI_ITERS),
            "--checkpoint_iterations", str(CLI_RESUME)]


def cli_phase(arrays, tmp):
    """The train, render and metrics CLIs on a COLMAP scene at full width,
    with PIL blocked (phase 8), in the directory ``tmp``: the scene in
    ``scene/``, the train CLI's run in ``out/`` (phase 11's sharded CLI
    runs start from both). Returns its record."""
    rec = {}
    bg = torch.tensor(BG, device=DEV)
    with pil_blocked():
        src, out, resumed = tmp / "scene", tmp / "out", tmp / "resumed"
        sparse = cli_scene(src, arrays)

        # the parsers (the native one built first, with cc) and the PNG
        # codec, timed on the scene's files
        parser, rec["native_build_ms"] = timed(colmap_io.parser)
        if parser != "native":
            raise AssertionError("the COLMAP parser is not the native one")
        pts, rec["parse_native_ms"] = timed(colmap_io.read_points3d_binary,
                                            sparse / "points3D.bin")
        pts_py, rec["parse_python_ms"] = timed(
            colmap_io._read_points3d_binary_py, sparse / "points3D.bin")
        if not all(np.array_equal(a, b) for a, b in zip(pts, pts_py)):
            raise AssertionError("the native and Python parsers differ")
        pngs = sorted((src / "images").iterdir())
        rec["png_decode_ms"] = quartiles(
            [timed(images.load, p)[1] for p in pngs])
        pixels = images.load(pngs[0])
        rec["png_encode_ms"] = quartiles(
            [timed(images.encode_png, pixels)[1] for _ in range(5)])

        # the train CLI: SfM init, exact KNN, the default preset
        argv = cli_argv(src)
        torch.cuda.synchronize()
        reset_counts()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recorded() as trace:
            tr, train_ms = timed(train_cli.main, argv + ["-m", str(out)])
        launches = read_counts()
        # peaks above what the process held before the CLI ran
        rec["train_peak_mib"] = (torch.cuda.max_memory_allocated() -
                                 held) / 2**20
        rec["train_held_mib"] = held / 2**20
        a = loop_summary(trace)
        steps, kept = a["steps"], a["kept"]
        cams = tr.scene.train_cameras + tr.scene.test_cameras
        if tr.scene.points.shape != (N_GAUSS, 3) or len(cams) != CLI_VIEWS \
                or any((c.width, c.height) != (WIDTH, HEIGHT) for c in cams):
            raise AssertionError("the COLMAP scene did not load as written")
        n_frames = len(tr.scene.test_cameras) + 5
        again = len(tr.report_rerenders)
        want = {"expand_instances": len(steps) + n_frames + again,
                "composite_forward": len(steps) + n_frames + again,
                "composite_backward": len(steps),
                "reduce_instances": len(steps)}
        print(f"cli: train launches {launches} for {len(steps)} dispatched "
              f"steps, {n_frames} report frames and {again} re-renders")
        if launches != want:
            raise AssertionError(f"expected launches {want}")
        losses = [s[3] for s in kept]
        if len(kept) != CLI_ITERS or any(s[4] for s in kept) or not all(
                math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"train CLI losses {losses}")
        for name in ("input.ply", "cameras.json", "cfg_args.json",
                     "command_line.txt", f"chkpnt{CLI_RESUME}.npz"):
            if not (out / name).exists():
                raise AssertionError(f"the train CLI wrote no {name}")
        if len(json.loads((out / "cameras.json").read_text())) != \
                CLI_VIEWS or not np.array_equal(ply_io.read_point_cloud(
                    out / "input.ply")[0], tr.scene.points):
            raise AssertionError("cameras.json or input.ply is wrong")
        ply = out / "point_cloud" / f"iteration_{CLI_ITERS}" / \
            "point_cloud.ply"
        state = checkpoint.load_ply_snapshot(ply)
        if state.n_alive != tr.state.n_alive:
            raise AssertionError("the PLY does not load with n_alive rows")
        report = json.loads((out / "log_file.txt").read_text()
                            .splitlines()[-1])
        iter_ms = a["iteration_ms"]
        rec.update({
            "train_cli_s": train_ms / 1e3, "launches_train": launches,
            "steps_dispatched": len(steps), "report_frames": n_frames,
            "report_rerenders": tr.report_rerenders, "losses": losses,
            "retries": a["retries"], "final_tier": tr.max_instances,
            "capacity": tr.state.capacity,
            "iteration_ms": quartiles([iter_ms[i] for i in CLI_TIMED]),
            "report": report})
        test_cam = tr.scene.test_cameras[0]
        del tr

        # the second run, from the checkpoint at 20
        with recorded() as trace:
            tr, rec["resume_cli_s"] = timed(
                train_cli.main, argv + ["-m", str(resumed),
                                        "--start_checkpoint",
                                        str(out / f"chkpnt{CLI_RESUME}.npz")])
        rec["resume_cli_s"] /= 1e3
        r = loop_summary(trace, first=CLI_RESUME + 1)["kept"]
        if tr.iteration != CLI_ITERS or len(r) != CLI_ITERS - CLI_RESUME \
                or not all(math.isfinite(s[3]) for s in r):
            raise AssertionError("the resumed train CLI did not reach 40")
        rec["resumed_losses"] = [s[3] for s in r]
        del tr

        # the render CLI
        torch.cuda.synchronize()
        reset_counts()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        rerenders, render_ms = timed(render_cli.main, ["-m", str(out)])
        render_launches = read_counts()
        rec["render_peak_mib"] = (torch.cuda.max_memory_allocated() -
                                  held) / 2**20
        rec["render_held_mib"] = held / 2**20
        frames = CLI_VIEWS + len(rerenders)
        if render_launches != {"expand_instances": frames,
                               "composite_forward": frames,
                               "composite_backward": 0,
                               "reduce_instances": 0}:
            raise AssertionError(f"render CLI launches {render_launches}")
        for kind in ("renders", "gt", "depth", "depth_inferno"):
            n = sum(len(list((out / split / f"ours_{CLI_ITERS}" / kind)
                             .iterdir())) for split in ("train", "test"))
            if n != CLI_VIEWS:
                raise AssertionError(f"the render CLI wrote {n} {kind}")
        print(f"cli: render launches {render_launches}; {len(rerenders)} "
              f"views rendered again at a tier that holds them: "
              f"{rerenders}")

        # test view 0: the PNG is the truncated compiled eval_render of the
        # PLY, which equals the eager one bit for bit, and B3 on that frame
        # is its plain version's bits
        tier = max(8 * state.n_alive, 262_144)
        cam_in = test_cam.render_inputs(DEV)
        frame, second = trainer_mod.render_whole(
            state, cam_in, bg, LOW_PASS, width=WIDTH, height=HEIGHT,
            sh_degree=SH_DEGREE, max_instances=tier,
            steps=compiled.CompiledStep())
        used = second or tier
        seen = {}
        again_frame = step.eval_render(
            state, cam_in, bg, LOW_PASS, width=WIDTH, height=HEIGHT,
            sh_degree=SH_DEGREE, max_instances=used,
            on_stage=stage_hook(seen))
        png = images.load(out / "test" / f"ours_{CLI_ITERS}" / "renders" /
                          "00000.png")
        want_png = (np.clip(frame.render.cpu().numpy(), 0, 1) * 255).astype(
            np.uint8).transpose(1, 2, 0)
        if not bitwise_equal(frame.render, again_frame.render) or \
                not np.array_equal(png, want_png):
            raise AssertionError("test view 0 differs from eval_render")
        with torch.no_grad():
            compare_tiles(seen["composite_B3"],
                          tile_render.composite_forward_torch(
                              *kernel_inputs(seen, WIDTH, HEIGHT, used)[1]),
                          "cli: test view 0")
        del seen, again_frame
        frame_ms = host_ms(lambda: step.eval_render(
            state, cam_in, bg, LOW_PASS, width=WIDTH, height=HEIGHT,
            sh_degree=SH_DEGREE, max_instances=used), 5)
        rec.update({"render_cli_s": render_ms / 1e3,
                    "launches_render": render_launches,
                    "render_rerenders": rerenders,
                    "render_cli_ms_per_view": render_ms / CLI_VIEWS,
                    "eval_render_ms": frame_ms[0],
                    "render_tier": tier, "render_tier_used": used})

        # the metrics CLI, against the report at 40
        results, metrics_ms = timed(metrics_cli.main, ["-m", str(out)])
        per_view = json.loads((out / "per_view.json").read_text())[
            f"ours_{CLI_ITERS}"]["PSNR"]
        psnr = results[str(out)][f"ours_{CLI_ITERS}"]["PSNR"]
        rms = [10 ** (-p / 20) for p in per_view.values()]
        tol = max(20 * math.log10(x / (x - PNG_STEP)) for x in rms)
        print(f"cli: results.json PSNR {psnr:.6f}, report at {CLI_ITERS} "
              f"{report['test']['psnr']:.6f}, tolerance {tol:.6f} dB")
        if report["iteration"] != CLI_ITERS or \
                not abs(psnr - report["test"]["psnr"]) <= tol:
            raise AssertionError("results.json's PSNR is not the report's")
        rec.update({"metrics_cli_s": metrics_ms / 1e3, "results": results,
                    "psnr_tolerance_db": tol})
    summary = {k: rec[k] for k in (
        "native_build_ms", "parse_native_ms", "parse_python_ms",
        "png_decode_ms",
        "png_encode_ms", "train_cli_s", "resume_cli_s", "render_cli_s",
        "metrics_cli_s", "iteration_ms", "render_cli_ms_per_view",
        "eval_render_ms", "train_peak_mib", "render_peak_mib",
        "train_held_mib", "render_held_mib",
        "steps_dispatched", "final_tier")}
    summary.update(loss=[rec["losses"][0], rec["losses"][-1]],
                   report_rerenders=len(rec["report_rerenders"]),
                   render_rerenders=len(rec["render_rerenders"]),
                   psnr=[rec["report"]["test"]["psnr"], psnr])
    print("cli: " + json.dumps(summary))
    return rec


# --- 9. the 30k production run, cut to 1000 iterations ----------------------
PROD_ITERS = 1000
PROD_CHECKPOINT = 500           # the checkpoint the second run resumes from
PROD_RESUMED = 600
PROD_TIMED = {"5-500": range(5, 500), "500-1000": range(500, PROD_ITERS)}
PROD_PROFILED = range(400, 410)   # between the retry and the first round
# round 5's JAX run (docs/runs/production_30k_r5.log:3,11-12,15): ground
# truth view 0's instances, iteration 1's instances over the first tier,
# and the held-out PSNR at 1000 (a TPU's run: a band, not bits). It ran
# the tool with a camera ring of 14 and target scales shifted by 0.56
# (docs/runs/README.md:13-14 names the ring; the shift is the one whose
# view 0 holds round 5's count, tests/test_torch_production.py); the
# tool's defaults (8, 0) are round 5's third attempt's.
R5_GT_VIEW0, R5_ITER1, R5_FIRST_TIER, R5_PSNR_1000 = (
    3_332_871, 2_008_240, 1_245_184, 25.46)
R5_KNOBS = ["--ring_radius", "14", "--target_scale_shift", "0.56"]


def production_phase():
    """tools/run_production_30k.py's run on the port (phase 9), through
    rain_tpu_torch.scripts.production_30k.main at full width, cut to 1000
    iterations, then resumed from its checkpoint at 500 to 600. Returns
    its record."""
    rec = {}
    sc = production_30k.build_scene(ring_radius=14.0, scale_shift=0.56)
    _, rec["knn_ms"] = timed(knn_ops.mean_dist3_matmul,
                             torch.from_numpy(sc.init_pts).to(DEV))
    n_views = len(sc.train_cameras) + len(sc.test_cameras)
    n_report = len(sc.test_cameras) + 5
    del sc
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = str(Path(tmp) / "production")
        argv = [out, *R5_KNOBS, "--iterations", str(PROD_ITERS),
                "--profile_steps", f"{PROD_PROFILED[0]}-{PROD_PROFILED[-1]}",
                "--test_iterations",
                "1", str(PROD_ITERS), "--save_iterations",
                "--checkpoint_iterations", str(PROD_CHECKPOINT)]
        capture = KernelCapture(
            lambda state, kw: kw["max_instances"] > R5_FIRST_TIER)
        torch.cuda.synchronize()
        gc.collect()
        held = torch.cuda.memory_allocated()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with recorded(capture) as trace:
            run, wall_ms = timed(production_30k.main, argv)
        launches = read_counts()
        rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        rec["held_mib"] = held / 2**20
        tr = run.trainer
        a = loop_summary(trace)
        steps, kept = a["steps"], a["kept"]
        again = len(tr.report_rerenders)
        want = {"expand_instances": n_views + len(steps) + 2 * n_report +
                again,
                "composite_forward": n_views + len(steps) + 2 * n_report +
                again,
                "composite_backward": len(steps),
                "reduce_instances": len(steps)}
        print(f"production: launches {launches} for {n_views} target "
              f"views, {len(steps)} dispatched steps, {2 * n_report} report "
              f"frames and {again} re-renders")
        if launches != want:
            raise AssertionError(f"expected launches {want}")
        gt0 = run.gt_instances[0]
        print(f"production: ground truth view 0 {gt0} instances (round 5: "
              f"{R5_GT_VIEW0})")
        if not abs(gt0 - R5_GT_VIEW0) <= 1e-3 * R5_GT_VIEW0:
            raise AssertionError("view 0's instances are not round 5's")
        first = a["retries"][0] if a["retries"] else None
        if first is None or first["iteration"] != 1 or \
                first["tier_before"] != R5_FIRST_TIER or \
                not first["instances"] > R5_FIRST_TIER or \
                first["tier_after"] < first["instances"]:
            raise AssertionError(f"iteration 1 did not overflow "
                                 f"{R5_FIRST_TIER} and retry: {a['retries']}")
        print(f"production: iteration 1 {first['instances']} instances > "
              f"{R5_FIRST_TIER}, retried at {first['tier_after']} (round 5: "
              f"{R5_ITER1}, retried at 2097152)")
        if capture.result is None:
            raise AssertionError("the retried step of iteration 1 was not "
                                 "held against the plain versions")
        losses = [s[3] for s in kept]
        if len(kept) != PROD_ITERS or any(s[4] for s in kept) or not all(
                math.isfinite(v) for v in losses) or not all(
                bool(torch.isfinite(x).all()) for x in tr.state.params):
            raise AssertionError("a kept step overflowed or is not finite")
        psnr = [h["test"]["psnr"] for h in tr.history]
        if [h["iteration"] for h in tr.history] != [1, PROD_ITERS] or \
                not psnr[1] > psnr[0]:
            raise AssertionError(f"held-out PSNR {psnr}")
        iter_ms = a["iteration_ms"]
        # the device's busy time over the profiled window's host time
        ops = [e for e in tr.profile.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ops) / 1e3
        if busy <= 0.0:
            raise AssertionError("the profiler recorded no device time")
        n_prof = len(PROD_PROFILED)
        ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
        rec.update({
            "device_busy_ms_per_iter": busy / n_prof,
            "profiled_wall_ms_per_iter": tr.profile_wall_ms / n_prof,
            "device_idle_share": 1.0 - busy / tr.profile_wall_ms,
            "device_ops_per_iter": sum(e.count for e in ops) / n_prof,
            "device_top_per_iter": [
                [e.key[:100], e.self_device_time_total / 1e3 / n_prof,
                 e.count / n_prof] for e in ops[:12]]})
        rec.update({
            "wall_s": wall_ms / 1e3, "gt_instances": run.gt_instances,
            "gt_ms_per_view": run.gt_seconds * 1e3 / n_views,
            "train_s": run.train_seconds, "launches": launches,
            "steps_dispatched": len(steps), "report_frames": 2 * n_report,
            "report_rerenders": tr.report_rerenders,
            "retries": a["retries"], "final_tier": tr.max_instances,
            "rounds": a["rounds"], "growths": a["growths"],
            "resets": a["resets"],
            "n_alive_per_round": [r["info"]["n_alive"] for r in a["rounds"]],
            "iteration_ms": {k: quartiles([iter_ms[i] for i in r])
                             for k, r in PROD_TIMED.items()},
            "iteration_ms_mean": {k: float(np.mean([iter_ms[i] for i in r]))
                                  for k, r in PROD_TIMED.items()},
            "losses": [losses[0], losses[-1]], "psnr": psnr,
            "history": tr.history, "final_n_alive": tr.state.n_alive,
            "final_capacity": tr.state.capacity,
            "step_kernels": capture.result})
        del run, tr, trace, capture

        # the second run: resumed from the checkpoint at 500, on to 600
        reset_counts()
        with recorded() as trace:
            run, rec["resume_wall_ms"] = timed(production_30k.main, [
                out, *R5_KNOBS, "--iterations", str(PROD_RESUMED),
                "--test_iterations",
                "--save_iterations", "--checkpoint_iterations"])
        launches = read_counts()
        steps = loop_summary(trace, first=PROD_CHECKPOINT + 1)
        n = len(steps["steps"])
        want = {"expand_instances": n_views + n, "composite_forward":
                n_views + n, "composite_backward": n, "reduce_instances": n}
        resumed = [s[3] for s in steps["kept"]]
        if run.first_iteration != PROD_CHECKPOINT or \
                run.trainer.iteration != PROD_RESUMED or \
                len(resumed) != PROD_RESUMED - PROD_CHECKPOINT or \
                not all(math.isfinite(v) for v in resumed) or \
                launches != want:
            raise AssertionError(f"the resumed run: from "
                                 f"{run.first_iteration} to "
                                 f"{run.trainer.iteration}, launches "
                                 f"{launches} (expected {want})")
        rec["resumed_launches"] = launches
        rec["resumed_losses"] = [resumed[0], resumed[-1]]
        del run, trace
    gc.collect()
    summary = {k: rec[k] for k in (
        "wall_s", "knn_ms", "gt_ms_per_view", "train_s", "steps_dispatched",
        "final_tier", "final_n_alive", "n_alive_per_round",
        "iteration_ms_mean", "peak_mib", "held_mib", "psnr", "losses",
        "device_busy_ms_per_iter", "profiled_wall_ms_per_iter",
        "device_idle_share", "device_ops_per_iter")}
    summary.update(gt_view0=rec["gt_instances"][0],
                   iteration1=[rec["retries"][0]["instances"],
                               rec["retries"][0]["tier_after"]],
                   tier_ladder=[[r["iteration"], r["tier_after"]]
                                for r in rec["retries"]],
                   report_rerenders=len(rec["report_rerenders"]),
                   resume_wall_ms=rec["resume_wall_ms"])
    print("production: " + json.dumps(summary))
    return rec


# --- 10. the A/B paths ----------------------------------------------------
AB_PATHS = {"kernel": {}, "scatter": {"reduce": "scatter"},
            "legacy": {"expand": "legacy"}}


def ab_render(state, cam, gt, **paths):
    """render of a training step's view through one A/B path, with every
    stage kept, and the gradients of the training loss in the params and
    the screen-space tap."""
    xs = [x.detach().clone().requires_grad_(True) for x in state.params]
    scales, quats, opac, shs = gmod.activate(gmod.GaussianParams(*xs))
    tap = torch.zeros((state.capacity, 2), device=DEV, requires_grad=True)
    seen = {}
    out = render_ops.render(
        xs[0], scales, quats, opac, shs, gmod.alive_mask(state), camera=cam,
        width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
        bg=torch.tensor(BG, device=DEV), low_pass=LOW_PASS,
        max_instances=MAX_INSTANCES, xy_tap=tap, on_stage=stage_hook(seen),
        **paths)
    loss_ops.training_loss(out.render, gt)[0].backward()
    return out, [x.grad for x in xs] + [tap.grad], seen


def ab_phase(state, cam, gt):
    """The A/B paths on the card at phase 4's step 0 (phase 10). Returns
    its record."""
    rec = {}
    torch.cuda.synchronize()
    reset_counts()
    runs = {name: [ab_render(state, cam, gt, **kw) for _ in range(2)]
            for name, kw in AB_PATHS.items()}
    rec["launches"] = read_counts()
    for name, ((o1, g1, _), (o2, g2, _)) in runs.items():
        if not (bitwise_equal(o1.render, o2.render) and all(
                bitwise_equal(a, b) for a, b in zip(g1, g2))):
            raise AssertionError(f"{name}: two runs differ")
    print("ab: two runs of each path (B2, the scatter reduction, the "
          "legacy expansion) are bitwise equal in image and gradients")
    names = list(gmod.GaussianParams._fields) + ["tap"]
    fused, g_kernel, seen = runs["kernel"][0]
    _, g_scatter, seen_s = runs["scatter"][0]
    legacy, g_legacy, seen_l = runs["legacy"][0]
    if "reduce_B2" in seen_s or "reduce_B2" in seen_l or tuple(seen_l) != \
            render_ops.LEGACY_STAGES + render_ops.BACKWARD_STAGES[:1]:
        raise AssertionError("an A/B path ran kernel B2")

    # the two sorts: one Binning
    prep = seen_l["preprocess"]
    grid_x, grid_y = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
    with torch.no_grad():
        binn = {s: binning_ops.bin_gaussians(prep, grid_x, grid_y,
                                             MAX_INSTANCES, sort=s)
                for s in binning_ops.SORTS}
    if not all(torch.equal(a, b) for a, b in zip(*binn.values())):
        raise AssertionError("bin_gaussians: the torch and the bitonic "
                             "sort differ")
    if not all(torch.equal(a, b) for a, b in zip(binn["torch"],
                                                 seen_l["bin_gaussians"])):
        raise AssertionError("bin_gaussians differs from the legacy path's")
    # legacy and fused: one image, n_contrib and instance order
    b = binn["torch"]
    total = int(b.num_instances)
    kept = min(total, MAX_INSTANCES)
    keys = torch.sort(seen["expand_B1"][1]).values[:kept]
    if not (torch.equal(keys >> 32, b.tile_id[:kept]) and torch.equal(
            keys & 0xFFFFFFFF, b.rank[:kept]) and bitwise_equal(
            seen["tile_sort_gather"], seen_l["pack_take"])):
        raise AssertionError("legacy and fused: instance order differs")
    for f in ("render", "depth", "alpha", "final_t", "n_contrib"):
        if not bitwise_equal(getattr(legacy, f).float(),
                             getattr(fused, f).float()):
            raise AssertionError(f"legacy and fused: {f} differs")
    if not all(bitwise_equal(a, b) for a, b in zip(g_legacy, g_scatter)):
        raise AssertionError("legacy and fused (scatter): gradients differ")
    # the scatter reduction against B2, at the gradient bar
    rel = {}
    for name, a, b in zip(names, g_scatter, g_kernel):
        scale = float(b.abs().max())
        rel[name] = float((a - b).abs().max()) / scale if scale else 0.0
    if not all(v < 1e-4 for v in rel.values()):
        raise AssertionError(f"scatter against B2: {rel}")
    rec.update({
        "instances": total, "kept": kept, "scatter_vs_b2_rel_err": rel,
        "scatter_bitwise_b2": all(bitwise_equal(a, b) for a, b in
                                  zip(g_scatter, g_kernel))})
    print(f"ab: {total} instances; torch and bitonic sorts one Binning; "
          f"legacy and fused one image, n_contrib and order; with the "
          f"scatter reduction one set of gradients; scatter vs B2 relative "
          f"error {json.dumps(rel)} (bitwise: {rec['scatter_bitwise_b2']})")
    del runs, seen, seen_s, seen_l, fused, legacy
    # times of one frame through each path, and of the two sorts
    with torch.no_grad():
        acts = gmod.activate(state.params)
        alive = gmod.alive_mask(state)

        def frame(**kw):
            return render_ops.render(
                state.params.xyz, *acts, alive, camera=cam, width=WIDTH,
                height=HEIGHT, sh_degree=SH_DEGREE,
                bg=torch.tensor(BG, device=DEV), low_pass=LOW_PASS,
                max_instances=MAX_INSTANCES, **kw)

        rec["frame_ms"] = {k: host_ms(lambda: frame(**kw), 5)[0]
                           for k, kw in (("fused", {}),
                                         ("legacy", {"expand": "legacy"}))}
        rec["bin_gaussians_ms"] = {
            s: host_ms(lambda: binning_ops.bin_gaussians(
                prep, grid_x, grid_y, MAX_INSTANCES, sort=s), 5)[0]
            for s in binning_ops.SORTS}
    print("ab: " + json.dumps({k: rec[k] for k in (
        "frame_ms", "bin_gaussians_ms", "launches")}))
    return rec


# --- 11. the sharded step, ranks sharing the card -------------------------
SHARD_WORLDS = (2, 4)
SHARD_TIMED = 5                   # sharded steps timed per rank
SHARD_TRAINER_ITERS = 12          # with a densify round at 10
SHARDING = tests_module("torch_sharding_cases")   # the band of row -1
# the share of a leaf's rows past the Trainers' 2e-3 bar: a gradient at
# its rounding's level takes either sign in the two runs, and Adam turns
# each such sign into a step of lr (tests/test_sharding.py:98-106)
SHARD_OUTLIERS = SHARDING.PLY_OUTLIERS


def sizes():
    """The scene's sizes, which phase 11's ranks take from the parent
    (they import this module afresh)."""
    return N_GAUSS, WIDTH, HEIGHT, MAX_INSTANCES


def adopt(parent_sizes):
    global N_GAUSS, WIDTH, HEIGHT, MAX_INSTANCES
    N_GAUSS, WIDTH, HEIGHT, MAX_INSTANCES = parent_sizes


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_rank(rank, dev, parent_sizes, ref_dir, floors, check, timed):
    """One rank of phase 11's sharded step at phase 4's step 0 (the
    perturbed 262k proxy, pose 0, its render as ground truth, the tier
    786,432 per band). The kernels' counts are set to 0 just before the
    step and read just after. The rank's rows of the step's state and
    moments are held against the single-device step's (ref_dir, .npy
    files read by rows): the params apart where the single-device step's
    Adam moment (0.1 of its gradient) lies below ``floors`` (one per leaf),
    where Adam's first step lr·g/(|g| + 1e-15) turns the gradients'
    rounding into a difference of up to 2·lr. With ``check`` B1-B4 of its
    band are held against their plain versions bit for bit (after the
    counts are read); then
    ``timed`` steps from the same shard are timed on the host clock, each
    ending in a synchronize. Returns the rank's record."""
    adopt(parent_sizes)
    ref_dir = Path(ref_dir)
    world = distributed.world_size()
    state = gmod.from_arrays(**perturbed(garden_proxy_state_arrays()),
                             device=dev)
    s = sharding.shard_state(state, rank, world)
    o = sharding.shard_opt(adam_mod.init(state.params), rank, world)
    del state
    cam = pose(0, WIDTH, HEIGHT).render_inputs(dev)
    gt = torch.from_numpy(np.load(ref_dir / "gt.npy")).to(dev)
    bg = torch.tensor(BG, device=dev)
    step_fn = sharding.make_sharded_train_step(
        width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
        max_instances_per_shard=MAX_INSTANCES)
    seen = {}
    sync(dev)
    reset_counts()
    s1, o1, aux = step_fn(s, o, cam, gt, bg, LOW_PASS, XYZ_LR, OPT_LEAVES,
                          on_stage=stage_hook(seen) if check else
                          binning_ops.no_stage_hook)
    sync(dev)
    launches = read_counts()
    rows = slice(rank * s.capacity, (rank + 1) * s.capacity)

    def ref(name):
        return torch.from_numpy(np.array(np.load(
            ref_dir / f"{name}.npy", mmap_mode="r")[rows])).to(dev)

    err, quiet = {}, {}
    for group, got in (("params", s1.params), ("mu", o1.mu), ("nu", o1.nu)):
        for name, t in got._asdict().items():
            d = (t - ref(f"{group}.{name}")).abs()
            if group == "params":
                small = ref(f"mu.{name}").abs() < floors[name]
                quiet[name] = (float(d[small].max()) if small.any()
                               else 0.0, int((d[small] >= 1e-5).sum()),
                               int(small.sum()))
                d = d[~small]
            err[f"{group}.{name}"] = float(d.max()) if d.numel() else 0.0
    err["xyz_gradient_accum"] = float(
        (s1.xyz_gradient_accum - ref("stats.xyz_gradient_accum"))
        .abs().max())
    exact = {k: bool(torch.equal(getattr(s1, k), ref(f"stats.{k}")))
             for k in ("denom", "max_radii2d")}
    h = hashlib.sha256()
    for t in list(s1.params) + list(o1.mu) + list(o1.nu) + \
            [getattr(s1, k) for k in gmod.STAT_FIELDS]:
        h.update(t.cpu().numpy().tobytes())
    rec = {"rank": rank, "loss": float(aux.loss), "l1": float(aux.l1),
           "num_instances": int(aux.num_instances),
           "overflow": bool(aux.instance_overflow), "launches": launches,
           "max_abs_err": err, "exact": exact, "digest": h.hexdigest(),
           "small_gradient_params": quiet,
           "band_instances": int(seen["depth_sort"].offs[-1]) if check
           else None}
    if check:
        layout = sharding.band_layout(WIDTH, HEIGHT, world)
        toff = sharding.band_offset(layout, rank)
        what = f"band {rank} of {world} (toff {toff})"
        b1, b3 = compare_forward(seen, WIDTH, HEIGHT, what, MAX_INSTANCES,
                                 band=(toff, layout.n_rows))
        b2, b4, _ = compare_backward(seen, what)
        rec["toff"] = toff
        rec["kernel_err"] = {"expand_instances": b1,
                             "composite_forward": b3,
                             "composite_backward": b4,
                             "reduce_instances": b2}
    del seen, s1, o1, aux
    ms = []
    for _ in range(timed):
        sync(dev)
        t = time.perf_counter()
        step_fn(s, o, cam, gt, bg, LOW_PASS, XYZ_LR, OPT_LEAVES)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    rec["step_ms"] = ms
    return rec


def negative_offset_band():
    """B1, B3 and B4 at tile offset -82 (the sharded step's band 0 at full
    width, 29 tile rows) on a band whose rects start in the row above the
    image (tests/torch_sharding_cases.py:band_case, 50,000 Gaussians):
    each bit for bit with its plain version on the card, and equal to the
    same band moved down one row at offset 0."""
    grid_x, n_rows, n, m = (WIDTH + 15) // 16, 29, 50_000, MAX_INSTANCES
    kw = dict(grid_x=grid_x, n_rows=n_rows, m=m, device=DEV)
    case = SHARDING.band_case(grid_x=grid_x, n_rows=n_rows, n=n)
    got = SHARDING.run_band(case, -grid_x, **kw)
    want = SHARDING.run_band(case, -grid_x, plain=True, **kw)
    moved = SHARDING.run_band(SHARDING.band_case(
        grid_x=grid_x, n_rows=n_rows, n=n, shift_rows=1), 0, **kw)
    row0 = int((got["end"] - got["start"])[:grid_x].sum())
    if row0 == 0:
        raise AssertionError("the band holds no instance in row -1")
    for k in got:
        a, b = got[k], want[k]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"toff -{grid_x}: {k} differs from its "
                                 f"plain version")
        if k not in ("cols", "pack") and not torch.equal(got[k], moved[k]):
            raise AssertionError(f"toff -{grid_x}: {k} differs from the "
                                 f"band moved down one row")
    total = int(got["end"][-1])
    print(f"B1, B3, B4 at toff -{grid_x} ({n_rows} rows, {total} instances, "
          f"{row0} in row -1): bitwise equal to their plain versions and "
          f"to the band moved down one row")
    return {"instances": total, "row_minus1_instances": row0}


def sharded_trainer_rank(rank, dev, scene_path, cfgs, single_dir, out_dir):
    """A Trainer of 2 ranks on phase 7's scene (``sharded_trainer``);
    rank 0 holds its params against the single-device run's. Returns
    rank 0's record."""
    with open(scene_path, "rb") as f:
        scene = pickle.load(f)
    log = []
    tr = trainer_mod.Trainer(scene, cfgs, out_dir,
                             device=dev, log_fn=log.append,
                             tensorboard=False)
    t = time.perf_counter()
    state = tr.train(iterations=SHARD_TRAINER_ITERS, test_iterations=(),
                     save_iterations=())
    sync(dev)
    train_s = time.perf_counter() - t
    if rank:
        return None
    n = state.n_alive
    err, over = {}, {}
    for name, t in state.params._asdict().items():
        d = np.abs(t.cpu().numpy()[:n] - np.load(
            Path(single_dir) / f"{name}.npy", mmap_mode="r")[:n])
        d = d.reshape(n, -1).max(axis=1)
        err[name] = float(np.sort(d)[-1 - int(SHARD_OUTLIERS * n)])
        over[name] = int((d >= 2e-3).sum())
    return {"n_alive": n, "capacity": state.capacity,
            "max_abs_err_but_outliers": err, "rows_over_2e-3": over,
            "tier": tr.max_instances, "train_s": train_s,
            "log": [line for line in log if line.startswith("[cap]")]}


def sharded_trainer_configs(devices):
    """Phase 7's configuration cut to SHARD_TRAINER_ITERS iterations with
    one densify round, at 10, as tests/test_sharding.py:114-125."""
    cfgs = trainer_configs(devices=devices)
    cfgs["opt"] = dataclasses.replace(
        cfgs["opt"], iterations=SHARD_TRAINER_ITERS, densify_from_iter=5,
        densification_interval=10, densify_until_iter=40,
        opacity_reset_interval=10_000)
    return cfgs


def ranks_where(share_device):
    return ("ranks sharing one card over gloo: not a scaling figure"
            if share_device else "one card per rank over nccl")


def sharded_trainer(arrays, tmp, share_device=True):
    """Trainer with devices=2 (two ranks sharing the card, or with
    ``share_device`` False one card each) against devices=1 on phase 7's
    scene: the same n_alive after the round at 10, params within 2e-3
    (tests/test_sharding.py:98-138) in all but SHARD_OUTLIERS of each
    leaf's rows."""
    scene = trainer_scene(arrays)
    scene_path = tmp / "scene.pkl"
    with open(scene_path, "wb") as f:
        pickle.dump(scene, f)
    t = time.perf_counter()
    tr = trainer_mod.Trainer(scene, sharded_trainer_configs(1), tmp / "one",
                             device=DEV, log_fn=lambda *a: None,
                             tensorboard=False)
    state = tr.train(iterations=SHARD_TRAINER_ITERS, test_iterations=(),
                     save_iterations=())
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    single = tmp / "single"
    single.mkdir()
    for name, v in state.params._asdict().items():
        np.save(single / f"{name}.npy", v.cpu().numpy())
    n1 = state.n_alive
    del tr, state
    rec = launch.spawn(sharded_trainer_rank, 2, device=DEV,
                       share_device=share_device, timeout_s=900,
                       args=(str(scene_path), sharded_trainer_configs(2),
                             str(single), str(tmp / "two")))[0]
    rec["single"] = {"n_alive": n1, "train_s": single_s}
    if rec["n_alive"] != n1:
        raise AssertionError(f"sharded Trainer: n_alive {rec['n_alive']} "
                             f"against {n1} on one device")
    worst = max(rec["max_abs_err_but_outliers"].values())
    if not worst < 2e-3:
        raise AssertionError(
            f"sharded Trainer: params off by "
            f"{rec['max_abs_err_but_outliers']} past the "
            f"{int(SHARD_OUTLIERS * n1)} farthest rows (rows off by 2e-3 "
            f"or more {rec['rows_over_2e-3']} of {n1})")
    print(f"sharded Trainer (2 ranks, {ranks_where(share_device)}) "
          f"against devices=1: "
          f"n_alive {n1} equal, params within {worst:.3g} but for "
          f"{int(SHARD_OUTLIERS * n1)} rows a leaf (rows off by 2e-3 or "
          f"more: {rec['rows_over_2e-3']}), tier {rec['tier']}, "
          f"{rec['train_s']:.1f} s against {single_s:.1f} s")
    return rec


# the train CLI's files in its output folder (phase 8's argv), besides at
# most one TensorBoard events file: rank 0's
CLI_FILES = {"cfg_args.json", "command_line.txt", "input.ply", "cameras.json",
             "log_file.txt", f"chkpnt{CLI_RESUME}.npz",
             f"point_cloud/iteration_{CLI_ITERS}/point_cloud.ply"}
CLI_PSNR_DB = 0.05      # the final reports' PSNRs of two CLI runs


def sharded_cli(src, out, world, backend, share_device, kernels):
    """Phase 8's train CLI on the COLMAP scene at ``src`` as a sharded run
    into ``out``: ``world`` processes, one per rank (--devices,
    --dist_init tcp://127.0.0.1:<free port>, --world_size, --rank,
    --dist_backend ``backend``), all on card 0 (``share_device``) or rank r
    on card r, each through tests/torch_cli_rank.py (the CLI's main, its
    launches written out). Checked: every rank exits 0; rank 0 alone
    writes the output folder (CLI_FILES and at most one TensorBoard file;
    only rank 0 prints "Training complete."); on every rank B4 and B2 run
    once per dispatched step (at least CLI_ITERS) and B1 and B3 once more
    per report frame and re-render. Adds each rank's launches to
    ``kernels`` under ``launches_cli_sharded``. Returns the record."""
    where = "sharing card 0" if share_device else "one card each"
    what = f"train CLI over {backend}, {world} ranks {where}"
    ranks_dir = out.with_name(out.name + "_ranks")
    argv = cli_argv(src) + [
        "-m", str(out), "--devices", str(world), "--dist_init",
        f"tcp://127.0.0.1:{SHARDING.free_port()}", "--world_size",
        str(world), "--dist_backend", backend]
    if share_device:
        argv += ["--device", "cuda:0"]
    torch.cuda.empty_cache()
    rcs, logs, wall_s = SHARDING.train_cli_ranks(argv, world, ranks_dir,
                                                 counts=True, timeout_s=600)
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        if rc != 0:
            raise AssertionError(f"{what}: rank {r} exited {rc}\n"
                                 f"{log[-4000:]}")
    ranks = [json.loads((ranks_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    for r, rk in enumerate(ranks):
        n, steps = rk["launches"], rk["launches"]["composite_backward"]
        frames = steps + rk["report_frames"] + rk["report_rerenders"]
        if steps < CLI_ITERS or n != {
                "expand_instances": frames, "composite_forward": frames,
                "composite_backward": steps, "reduce_instances": steps}:
            raise AssertionError(f"{what}: rank {r} launches {n}, "
                                 f"{rk['report_frames']} report frames")
    files = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
    events = {f for f in files if "tfevents" in Path(f).name}
    done = ["Training complete." in log for log in logs]
    if files - events != CLI_FILES or len(events) > 1 or \
            done != [True] + [False] * (world - 1):
        raise AssertionError(f"{what}: the output folder holds "
                             f"{sorted(files)}; 'Training complete.' "
                             f"printed by ranks {done}")
    ms = [rk["ms_per_iteration"] for rk in ranks]
    med = [rk["iteration_ms_median"] for rk in ranks]
    print(f"{what}: {wall_s:.1f} s wall, ms per iteration per rank "
          f"{[round(v, 2) for v in ms]} (Trainer.train over its "
          f"iterations), median {[round(v, 2) for v in med]} (iterations "
          f"5-{CLI_ITERS}), launches per rank "
          f"{[rk['launches'] for rk in ranks]} "
          f"({'; '.join(nvidia_smi().splitlines())})")
    for k in kernels:
        k.setdefault("launches_cli_sharded", {})[f"{backend}{world}"] = [
            rk["launches"][k["name"]] for rk in ranks]
    return {"backend": backend, "world": world, "share_device": share_device,
            "wall_s": wall_s, "ranks": ranks, "ms_per_iteration": ms,
            "iteration_ms_median": med,
            "files": sorted(files)}


def hold_cli(out, ref, what, capacity, ref_capacity, cfg_differs=(),
             params_bar=True):
    """A CLI run's output folder ``out`` against ``ref``'s, a run of the
    same argv: cfg_args.json equal but for the output folder and
    ``cfg_differs`` ((group, key) pairs), cameras.json and input.ply byte
    for byte, the same capacity and final PLY n_alive, the final report's
    PSNR within CLI_PSNR_DB, and, with ``params_bar``, the PLY's params
    within the sharded Trainer's bar (tests/torch_sharding_cases.py:
    ply_agreement: 2e-3 in all but 1 in 10,000 of each leaf's rows); the
    rows past 2e-3 are counted and printed either way. Returns the
    record."""
    cfg, cfg_ref = (json.loads((d / "cfg_args.json").read_text())
                    for d in (out, ref))
    for group, key in (("model", "model_path"), *cfg_differs):
        cfg[group].pop(key)
        cfg_ref[group].pop(key)
    if cfg != cfg_ref:
        raise AssertionError(f"{what}: cfg_args.json differs: {cfg} "
                             f"against {cfg_ref}")
    for name in ("cameras.json", "input.ply"):
        if (out / name).read_bytes() != (ref / name).read_bytes():
            raise AssertionError(f"{what}: {name} differs")
    ply = Path("point_cloud") / f"iteration_{CLI_ITERS}" / "point_cloud.ply"
    agree = SHARDING.ply_agreement(out / ply, ref / ply)
    if capacity != ref_capacity or agree["n_alive"] != agree["n_alive_ref"] \
            or (params_bar and not SHARDING.ply_agrees(agree)):
        raise AssertionError(f"{what}: capacity {capacity} against "
                             f"{ref_capacity}, PLY {agree}")
    reports = [json.loads((d / "log_file.txt").read_text().splitlines()[-1])
               for d in (out, ref)]
    psnr = [r["test"]["psnr"] for r in reports]
    if [r["iteration"] for r in reports] != [CLI_ITERS] * 2 or \
            not abs(psnr[0] - psnr[1]) <= CLI_PSNR_DB:
        raise AssertionError(f"{what}: final reports {reports}")
    print(f"{what}: cfg_args.json equal but for the output folder and "
          f"{list(cfg_differs)}, "
          f"cameras.json and input.ply byte for byte, capacity {capacity} "
          f"and n_alive {agree['n_alive']} equal, params within "
          f"{max(agree['max_abs_err_but_outliers'].values()):.3g} but for "
          f"{agree['outliers_allowed']} rows a leaf "
          f"({'held' if params_bar else 'not held'} to 2e-3; rows off by "
          f"2e-3 or more: {agree['rows_over_bar']}), test PSNR "
          f"{psnr[0]:.6f} against {psnr[1]:.6f}")
    return {"ply": agree, "psnr": psnr, "capacity": capacity}


def sharded_phase(arrays, gt0, aux0, first_step, kernels,
                  share_device=True, cli_dir=None, cli_capacity=None):
    """Phase 11: the sharded step at phase 4's step 0 at D = 2 and 4 ranks
    sharing the card over gloo (with ``share_device`` False, one card per
    rank over nccl), held against the single-device step (``first_step``:
    snapshot after step 0, ``aux0`` its aux) and timed beside it, its
    rerun at D = 2, the band kernels, the sharded Trainer and the dry run.
    With ``cli_dir`` (phase 8's directory) the train CLI then runs phase
    8's argv over gloo as 2 ranks sharing the card, held against phase
    8's run of one process, whose capacity is ``cli_capacity``
    (``sharded_cli``, ``hold_cli``). Adds each
    kernel's launches per rank to ``kernels``. Returns the phase's
    record."""
    where = ranks_where(share_device)
    rec = {"negative_offset_band": negative_offset_band(),
           "ranks": where}
    # the single-device step from the same start, timed as the ranks are
    state0 = gmod.from_arrays(**perturbed(arrays), device=DEV)
    opt0 = adam_mod.init(state0.params)
    cam0 = pose(0, WIDTH, HEIGHT).render_inputs(DEV)
    one_ms = []
    for _ in range(SHARD_TIMED):
        sync(DEV)
        t = time.perf_counter()
        step.train_step(
            state0, opt0, cam0, gt0, torch.tensor(BG, device=DEV), LOW_PASS,
            XYZ_LR, width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
            max_instances=MAX_INSTANCES, opt_cfg_leaves=OPT_LEAVES)
        sync(DEV)
        one_ms.append((time.perf_counter() - t) * 1e3)
    del state0, opt0
    rec["one_device_step_ms"] = one_ms
    params, opt, stats = first_step
    # a gradient below 1e-6 of its leaf's largest is at its rounding's
    # level; Adam's first step may move such a param by up to 2·lr
    floors = {k: 1e-6 * float(v.abs().max())
              for k, v in opt.mu._asdict().items()}
    lrs = dict(xyz=XYZ_LR, features_dc=OPT_LEAVES["feature_lr"],
               features_rest=OPT_LEAVES["feature_lr"] / 20,
               scaling=OPT_LEAVES["scaling_lr"],
               rotation=OPT_LEAVES["rotation_lr"],
               opacity=OPT_LEAVES["opacity_lr"])
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        np.save(tmp / "gt.npy", gt0.cpu().numpy())
        for group, leaves in (("params", params), ("mu", opt.mu),
                              ("nu", opt.nu)):
            for name, v in leaves._asdict().items():
                np.save(tmp / f"{group}.{name}.npy", v.cpu().numpy())
        for name, v in zip(gmod.STAT_FIELDS, stats):
            np.save(tmp / f"stats.{name}.npy", v.cpu().numpy())
        for world in SHARD_WORLDS:
            t = time.perf_counter()
            ranks = launch.spawn(sharded_rank, world, device=DEV,
                                 share_device=share_device, timeout_s=600,
                                 args=(sizes(), str(tmp), floors, True,
                                       SHARD_TIMED))
            wall_s = time.perf_counter() - t
            for r in ranks:
                what = f"sharded step D={world} rank {r['rank']}"
                if r["launches"] != {k: 1 for k in counters()}:
                    raise AssertionError(f"{what}: launches {r['launches']}")
                if r["overflow"]:
                    raise AssertionError(f"{what} overflowed "
                                         f"({r['num_instances']})")
                if abs(r["loss"] - float(aux0.loss)) >= 1e-5 or \
                        abs(r["l1"] - float(aux0.l1)) >= 1e-5:
                    raise AssertionError(f"{what}: loss {r['loss']} l1 "
                                         f"{r['l1']} against {aux0}")
                if not max(r["max_abs_err"].values()) < 1e-5 or \
                        not all(r["exact"].values()) or \
                        any(q[0] > 2 * lrs[k] for k, q in
                            r["small_gradient_params"].items()):
                    raise AssertionError(
                        f"{what}: {r['max_abs_err']} {r['exact']} "
                        f"{r['small_gradient_params']}")
                if r.get("kernel_err") and any(r["kernel_err"].values()):
                    raise AssertionError(f"{what}: {r['kernel_err']}")
            med = [float(np.median(r["step_ms"])) for r in ranks]
            n_small = sum(q[1] for r in ranks
                          for q in r["small_gradient_params"].values())
            print(f"sharded step D={world}: loss {ranks[0]['loss']:.7f} "
                  f"(one device {float(aux0.loss):.7f}), params and "
                  f"moments within "
                  f"{max(max(r['max_abs_err'].values()) for r in ranks):.3g}"
                  f", denom and max_radii2d exact, band instances "
                  f"{[r['band_instances'] for r in ranks]}, params with "
                  f"a gradient below 1e-6 of their leaf's largest off by "
                  f"1e-5 or more: {n_small}, B1-B4 bit for bit on every "
                  f"band; median ms per step per rank "
                  f"{[round(v, 3) for v in med]} ({where}; one device "
                  f"{float(np.median(one_ms)):.3f})")
            rec[f"D{world}"] = {"ranks": ranks, "median_step_ms": med,
                                "wall_s": wall_s}
            for k in kernels:
                k.setdefault("launches_sharded", {})[str(world)] = [
                    r["launches"][k["name"]] for r in ranks]
        again = launch.spawn(sharded_rank, 2, device=DEV,
                             share_device=share_device, timeout_s=600,
                             args=(sizes(), str(tmp), floors, False, 0))
        if [r["digest"] for r in again] != \
                [r["digest"] for r in rec["D2"]["ranks"]]:
            raise AssertionError("the sharded step at D=2 run again gives "
                                 "other bits")
        print("sharded step D=2 run again: the same bits on every rank")
        rec["rerun_bitwise"] = True
        rec["trainer"] = sharded_trainer(arrays, tmp, share_device)
    rec["dryrun"] = entry_mod.dryrun_multichip(4, share_device=share_device)
    if cli_dir is not None:
        cli = sharded_cli(cli_dir / "scene", cli_dir / "gloo2", 2, "gloo",
                          True, kernels)
        # 40 Adam steps (opacity lr 0.05) turn the gradients that sit at
        # their rounding's level, and so take either sign in one process
        # and in two ranks, into differences of several lr in a few
        # hundred rows (272 of 262,144 opacities past 2e-3 on the H100):
        # the sharded Trainer above holds the params at 12 iterations,
        # and this run is held to the same n_alive, capacity and PSNR
        cli["against_one_process"] = hold_cli(
            cli_dir / "gloo2", cli_dir / "out",
            "train CLI over gloo, 2 ranks, against one process",
            cli["ranks"][0]["capacity"], cli_capacity,
            cfg_differs=[("system", "devices")], params_bar=False)
        rec["cli"] = cli
    return rec


# --- 12. the end-state scale ---------------------------------------------
# the step-0 instance counts of bench.py's tiers at its camera from the TPU
# run BENCH_r05.json (its 262k count, 612,602, is phase 3's pose 2's);
# printed beside the port's, which must equal its CPU path's
BENCH_R05_INSTANCES = {"1m": 1_644_592, "4m": 5_436_763}
SCALE_TIERS = tuple(BENCH_R05_INSTANCES)
SCALE_ITERS = 10
GROWTH_ITERS = 1350
GROWTH_LOG_EVERY = 50
# docs/runs/sustained_growth_r5.log: alive at 1000 (held within 10 %), the
# capacity growths and the instance tiers that the cut run must cross
GROWTH_ALIVE = {1000: 496_434}
GROWTH_CAPACITIES = ((262_144, 524_288), (524_288, 1_048_576),
                     (1_048_576, 2_097_152))
GROWTH_TIERS = (1_572_864, 2_097_152)


def scale_tier(name, trace_dir):
    """Phase 12's tier ``name`` of scripts/probe_scale.py at full size:
    run_tier's step 0 (its on_stage hook kept) and SCALE_ITERS more steps,
    its launch counters set to 0 just before and read just after, then 3
    steps under torch.profiler; B1-B4 of step 0 against their plain
    versions bit for bit, then timed beside their bounds. Returns the
    tier's record."""
    n, m, _ = probe_scale.TIERS[name]
    seen = {}
    torch.cuda.synchronize()
    reset_counts()
    rec = probe_scale.run_tier(name, device=DEV, iters=SCALE_ITERS,
                               trace=trace_dir, on_stage=stage_hook(seen))
    launches = read_counts()
    want = 1 + SCALE_ITERS + probe_scale.TRACE_STEPS
    if launches != {k: want for k in counters()}:
        raise AssertionError(f"{name}: launches {launches}, expected {want} "
                             f"of each kernel")
    cpu = probe_scale.preprocess_instances(probe_scale.build_tier_state(
        n, probe_scale.TIERS[name][2], device="cpu"))
    if rec["instances"] != cpu or rec["overflow"]:
        raise AssertionError(
            f"{name}: step 0 has {rec['instances']} instances (overflow "
            f"{rec['overflow']}) at the tier {m}; the CPU path counts {cpu}")
    rec["cpu_instances"] = cpu
    rec["bench_r05_instances"] = BENCH_R05_INSTANCES[name]
    if tuple(seen) != TRAIN_STAGES:
        raise AssertionError(f"{name}: training stages seen {tuple(seen)}")
    what = f"{name} tier step 0 ({n} Gaussians)"
    errs = dict(zip(("expand_instances", "composite_forward"),
                    compare_forward(seen, WIDTH, HEIGHT, what, m)))
    errs["reduce_instances"], errs["composite_backward"], _ = \
        compare_backward(seen, what)
    # without autograd: the pack carries the step's graph, and the plain
    # compositor that counts the pairs would record its own
    with torch.no_grad():
        kernels, work = step_kernels(seen, WIDTH, HEIGHT, m)
        rows = {}
        for k, (call, _, _, nbytes, ops) in kernels.items():
            bound_ms, bound_by = bound(nbytes, ops)
            rows[k] = {"ms": device_ms(call), "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": errs[k]}
    del seen, kernels
    rec.update(launches=launches, kernels=rows, work=work)
    print(f"{what}: {rec['instances']} instances at the tier {m}, as on the "
          f"CPU path (BENCH_r05.json's TPU run: "
          f"{BENCH_R05_INSTANCES[name]}); B1-B4 bit for bit; kernels (ms, "
          f"bound ms) " +
          json.dumps({k: [r["ms"], r["bound_ms"]] for k, r in rows.items()}))
    print(f"{what}: first step {rec['first_step_ms']:.1f} ms, host median "
          f"of {SCALE_ITERS} steps {rec['step_ms_median']:.2f} ms, device "
          f"busy {rec['device_busy_ms']:.2f} ms per step, "
          f"{rec['device_ops']:.0f} device operations, peak "
          f"{rec['peak_mib']:.0f} MiB")
    return rec


def growth_run(tmp):
    """scripts/sustained_growth.py cut to GROWTH_ITERS iterations, its
    loop recorded (tests/torch_trainer_trace.py) and its launch counters
    set to 0 just before and read just after: each kernel once per
    dispatched step. Then the synchronising calls of one train_step at
    the run's end state. Returns the record."""
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    with recorded() as trace:
        tr = sustained_growth.main(["--iterations", str(GROWTH_ITERS),
                                    "--out", str(tmp)])
    wall_s = time.perf_counter() - t
    launches = read_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    a = loop_summary(trace)
    steps, kept = a["steps"], a["kept"]
    if launches != {k: len(steps) for k in counters()}:
        raise AssertionError(f"growth run: launches {launches} for "
                             f"{len(steps)} dispatched steps")
    if len(kept) != GROWTH_ITERS or any(s[4] for s in kept) or not all(
            math.isfinite(s[3]) for s in steps):
        raise AssertionError("growth run: a kept step overflowed, or a "
                             "loss is not finite")
    alive = {i: kept[i - 1][2]
             for i in range(GROWTH_LOG_EVERY, GROWTH_ITERS + 1,
                            GROWTH_LOG_EVERY)}
    print(f"growth run: alive every {GROWTH_LOG_EVERY} iterations "
          f"{json.dumps(alive)}")
    grown = [(g["from"], g["to"]) for g in a["growths"]]
    tiers = [r["tier_after"] for r in a["retries"]]
    print(f"growth run: capacity growths {grown}, instance tiers {tiers} "
          f"at iterations {[r['iteration'] for r in a['retries']]}")
    if any(g not in grown for g in GROWTH_CAPACITIES) or \
            any(t not in tiers for t in GROWTH_TIERS):
        raise AssertionError(f"growth run: expected the capacity growths "
                             f"{GROWTH_CAPACITIES} and the tiers "
                             f"{GROWTH_TIERS}")
    for i, want in GROWTH_ALIVE.items():
        if abs(alive[i] - want) > 0.1 * want:
            raise AssertionError(f"growth run: alive {alive[i]} at {i}, "
                                 f"more than 10 % from the log's {want}")
    syncs = end_state_syncs(tr)
    print(f"growth run: synchronising calls per train_step at "
          f"{tr.state.n_alive} alive: {syncs[0]} {syncs[1]}")
    if syncs[0]:
        raise AssertionError(f"train_step waits for the card: {syncs}")
    iter_ms = a["iteration_ms"]
    spans = {f"{lo}-{hi}": [iter_ms[i] for i in range(lo, hi)
                            if i in iter_ms]
             for lo, hi in ((2, 500), (500, 1000), (1000, GROWTH_ITERS))}
    rec = {"wall_s": wall_s, "launches": launches,
           "steps_dispatched": len(steps), "alive": alive,
           "growths": a["growths"], "retries": a["retries"],
           "rounds": a["rounds"], "final_n_alive": tr.state.n_alive,
           "final_capacity": tr.state.capacity,
           "final_tier": tr.max_instances, "peak_mib": peak_mib,
           "syncs_per_step": syncs[0], "sync_sites": syncs[1],
           "host_ms_per_iteration": {k: quartiles(v)
                                     for k, v in spans.items() if v}}
    del tr
    return rec


def scale_phase(kernels):
    """Phase 12: bench.py's 1m and 4m tiers at step 0, the KNN at
    knn_deviation's 1,572,864 points, and the sustained-growth run cut to
    GROWTH_ITERS. Adds each kernel's launches and, per tier, its ms and
    bound ms to ``kernels``. Returns the phase's record."""
    rec = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        for name in SCALE_TIERS:
            rec[name] = scale_tier(name, tmp / "trace")
            torch.cuda.empty_cache()
        knn = knn_deviation.run(knn_deviation.N_POINTS, device=DEV)
        if knn["rows_below_bound"]:
            raise AssertionError(f"the window KNN falls below the exact "
                                 f"one on {knn['rows_below_bound']} rows")
        rec["knn"] = knn
        torch.cuda.empty_cache()
        rec["growth"] = growth_run(tmp / "growth")
    for k in kernels:
        k["launches_scale"] = {
            **{t: rec[t]["launches"][k["name"]] for t in SCALE_TIERS},
            "growth": rec["growth"]["launches"][k["name"]]}
        k["scale_ms_bound_ms"] = {
            t: [rec[t]["kernels"][k["name"]]["ms"],
                rec[t]["kernels"][k["name"]]["bound_ms"]]
            for t in SCALE_TIERS}
    summary = {t: {f: rec[t][f] for f in (
        "instances", "bench_r05_instances", "first_step_ms",
        "step_ms_median", "device_busy_ms", "device_ops", "peak_mib")}
        for t in SCALE_TIERS}
    summary["knn"] = {f: knn[f] for f in ("exact_s", "morton_s", "rel_mean",
                                          "rel_max", "rows_below_bound")}
    summary["growth"] = {f: rec["growth"][f] for f in (
        "wall_s", "final_n_alive", "final_capacity", "final_tier",
        "peak_mib", "syncs_per_step")}
    print("scale: " + json.dumps(summary))
    return rec


# --- 13. the long end-to-end run from a sparse init ------------------------
GT_IMAGES = tests_module("torch_gt_images")   # GT images, flips by f64
# what the JAX runs' logs show after iteration 0, printed beside the port's
# and not checked: densification is chaotic across backends, and the two
# logs part after the first growth (docs/runs/e2e_long_tpu_r4.log,
# e2e_long_cpu_r3.log)
E2E_TPU_LOG = {"growths": [[512, 4096, 287], [4096, 8192, 2685]],
               "final_alive": 3847, "final_psnr": 54.89}
E2E_CPU_LOG = {"growths": [[512, 4096, 315]], "final_alive": 1901,
               "final_psnr": 54.60}
E2E_CUT = 600      # the compiled run held to the eager one: past the growth


def trainer_step_paths(tr):
    """A step of Trainer ``tr`` at its state, on its first training camera
    and as its _dispatch queues one (every per-call value a 0-d device
    tensor; SH degree 3), through its CompiledStep and through the eager
    step, each called once (the compiled one's key captured): {"eager":
    fn, "compiled": fn}."""
    cam = tr.scene.train_cameras[0]
    cam_in, gt = tr._camera_bundle(cam)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=DEV)

    args = (tr.state._replace(n_alive=torch.full(
        (), tr.state.n_alive, dtype=torch.int32, device=DEV)),
        tr.opt_state, cam_in, gt, tr.background, f32(tr.low_pass),
        f32(XYZ_LR))
    kw = dict(width=cam.width, height=cam.height,
              sh_degree=tr.model.sh_degree, max_instances=tr.max_instances,
              lambda_dssim=tr.opt_cfg.lambda_dssim,
              opt_cfg_leaves={k: f32(v) for k, v in OPT_LEAVES.items()})
    paths = {"eager": lambda: step.train_step(*args, **kw),
             "compiled": lambda: tr._steps.train_step(*args, **kw)}
    for fn in paths.values():
        fn()
    return paths


def path_record(paths):
    """Per path: path_times, device_profile and memory_of (three calls)."""
    rec = path_times(paths)
    for name, fn in paths.items():
        rec[name].update(device_profile(fn))
        rec[name]["peak_mib"], rec[name]["reserved_mib"] = memory_of(
            lambda: [fn() for _ in range(3)])
    return rec


def e2e_compiled_vs_eager(scene):
    """The long run's first E2E_CUT iterations (its 2,500-iteration
    schedule, past the first capacity growth at 500) through the compiled
    step and through the eager one (CompiledStep's methods replaced): the
    same steps, capacity events, reports and state, bit for bit. Returns
    each run's host ms per iteration, peak MiB and the compiled run's
    captures."""
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name in ("compiled", "eager"):
            with recorded(eager=name == "eager") as trace:
                r = e2e_long.run(scene, str(Path(tmp) / name), stop=E2E_CUT,
                                 device=DEV, log=lambda *a: None)
            t = r.pop("trainer")
            runs[name] = (r, loop_summary(trace)["steps"],
                          host_snapshot(t.state, t.opt_state),
                          [[list(k), ms] for k, ms in t._steps.captures])
            if name == "compiled":
                at_cut = path_record(trainer_step_paths(t))
            del t
    (rc, sc, hc, cc), (re_, se, he, ce) = runs["compiled"], runs["eager"]
    if sc != se or rc["report0"] != re_["report0"] or \
            rc["final"] != re_["final"] or ce or not cc or \
            [e["line"] for e in rc["cap_events"]] != \
            [e["line"] for e in re_["cap_events"]] or \
            not same_bits(hc, he):
        raise AssertionError(f"e2e: the compiled run to {E2E_CUT} differs "
                             f"from the eager one")
    out = {"iterations": E2E_CUT, "steps": len(sc),
           "host_ms_per_iteration_compiled": rc["host_ms_per_iteration"],
           "host_ms_per_iteration_eager": re_["host_ms_per_iteration"],
           "peak_mib_compiled": rc["peak_mib"],
           "peak_mib_eager": re_["peak_mib"], "captures": cc,
           "step_at_cut": at_cut}
    print(f"e2e: to {E2E_CUT} through the compiled step and the eager one: "
          f"{len(sc)} steps, capacity events, reports and state bit for "
          f"bit; host ms per iteration {rc['host_ms_per_iteration']:.3f} "
          f"against {re_['host_ms_per_iteration']:.3f}; peak "
          f"{rc['peak_mib']:.0f} and {re_['peak_mib']:.0f} MiB; "
          f"{len(cc)} captures (key, ms) {cc}")
    for name, r in at_cut.items():
        print(f"e2e: a step at {E2E_CUT}, {name}: host "
              f"{r['host_ms']['median']:.3f} ms ({r['queued_ms']:.3f} "
              f"queued), device busy {r['busy_ms']:.3f} ms "
              f"({r['launches']:.0f} operations), host launches "
              f"{r['host_launches']:.0f}, peak {r['peak_mib']:.1f} MiB")
    return out


def end_state_syncs(tr):
    """The synchronising calls of one train_step at a Trainer's end
    state, on its first training camera (count_syncs)."""
    cam = tr.scene.train_cameras[0]
    cam_in, gt = tr._camera_bundle(cam)
    return count_syncs(lambda: step.train_step(
        tr.state, tr.opt_state, cam_in, gt, tr.background, tr.low_pass,
        XYZ_LR, width=cam.width, height=cam.height,
        sh_degree=tr.model.sh_degree, max_instances=tr.max_instances,
        opt_cfg_leaves=OPT_LEAVES))


def e2e_phase(kernels):
    """Phase 13: rain_tpu_torch.scripts.e2e_long.main at its full 2,500
    iterations (the scene built on the card), its loop recorded and its
    launch counters set to 0 just before and read just after: B1 and B3
    once per ground-truth view, dispatched step, report frame and
    re-render, B4 and B2 once per dispatched step. main checks the JAX
    test's five assertions. B1-B4 are held against their plain versions
    bit for bit at the first step after the capacity growth (their
    launches there not counted). Checked besides: the iteration-0 report
    within one unit of the log's last printed digits; the card's
    ground-truth images against the CPU path's at the oracle tolerances,
    each value past them a threshold flip settled by an f64 render
    (tests/torch_gt_images.py), with the same instance counts and no
    overflow; a train_step at the end state makes no synchronising call.
    Adds the launches to ``kernels``. Returns the phase's record."""
    capture = KernelCapture(
        lambda state, kw: state.capacity > e2e_long.CAPACITY)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        with recorded(capture) as trace:
            rec = e2e_long.main(["--out", str(Path(tmp) / "e2e")])
        wall_s = time.perf_counter() - t
        launches = read_counts()
    tr = rec.pop("trainer")
    a = loop_summary(trace)
    steps = len(a["steps"])
    views = len(tr.scene.gt_instances)
    frames = 2 * (len(tr.scene.test_cameras) + 5) + len(tr.report_rerenders)
    want = {"expand_instances": views + steps + frames,
            "composite_forward": views + steps + frames,
            "composite_backward": steps, "reduce_instances": steps}
    print(f"e2e: launches {launches} for {views} ground-truth views, "
          f"{steps} dispatched steps and {frames} report frames")
    if launches != want:
        raise AssertionError(f"e2e: expected launches {want}")
    if capture.result is None:
        raise AssertionError("e2e: no step after the capacity growth")
    off = e2e_long.units_off(rec["report0"])
    print(f"e2e: iteration-0 report {json.dumps(rec['report0'])}; units "
          f"of the log's last printed digit off {off} (log "
          f"{e2e_long.LOG_ITER0})")
    if max(max(v) for v in off.values()) > 1:
        raise AssertionError("e2e: the iteration-0 report is more than one "
                             "unit of the log's last digit away")
    growths = [[g["from"], g["to"], e["line"]] for g, e in zip(
        a["growths"], [e for e in rec["cap_events"]
                       if "growing capacity" in e["line"]])]
    print(f"e2e: capacity growths {growths} at iterations "
          f"{[e['iteration'] for e in rec['cap_events']]}; final alive "
          f"{rec['n_alive']}, capacity {rec['capacity']}, test PSNR "
          f"{rec['final']['test']['psnr']:.6f} (information: the TPU log "
          f"{E2E_TPU_LOG}, the CPU log {E2E_CPU_LOG})")

    cpu = e2e_long.gt_scene("cpu")
    cams = tr.scene.train_cameras + tr.scene.test_cameras
    if list(cpu.gt_instances) != list(tr.scene.gt_instances) or \
            any(tr.scene.gt_overflow):
        raise AssertionError(f"e2e: ground-truth instances "
                             f"{tr.scene.gt_instances} (overflow "
                             f"{tr.scene.gt_overflow}), on the CPU "
                             f"{cpu.gt_instances}")
    flips = GT_IMAGES.compare(
        [c.image for c in cams],
        [c.image for c in cpu.train_cameras + cpu.test_cameras],
        GT_IMAGES.F64Views())
    print(f"e2e: ground truth on the card against the CPU path: "
          f"{json.dumps(flips)}")
    syncs = end_state_syncs(tr)
    print(f"e2e: synchronising calls per train_step at {tr.state.n_alive} "
          f"alive: {syncs[0]} {syncs[1]}")
    if syncs[0]:
        raise AssertionError(f"train_step waits for the card: {syncs}")
    for k in kernels:
        k["launches_e2e"] = launches[k["name"]]
    rec["compiled_vs_eager"] = e2e_compiled_vs_eager(tr.scene)
    rec["captures"] = [[list(k), ms] for k, ms in tr._steps.captures]
    summary = {f: rec[f] for f in (
        "n_alive", "capacity", "tier", "wall_s", "host_ms_per_iteration",
        "peak_mib", "scene_s")}
    summary.update(phase_s=wall_s, steps_dispatched=steps,
                   psnr=[rec["report0"]["test"]["psnr"],
                         rec["final"]["test"]["psnr"]],
                   growths=[g[:2] for g in growths])
    print("e2e: " + json.dumps(summary) + f" ({nvidia_smi()})")
    del tr
    rec.update(launches=launches, steps_dispatched=steps,
               retries=a["retries"], rounds=a["rounds"],
               growths=a["growths"], resets=a["resets"], phase_s=wall_s,
               iteration_ms=quartiles(list(a["iteration_ms"].values())),
               gt_flips=flips, units_off=off, syncs_per_step=syncs[0],
               sync_sites=syncs[1], step_kernels=capture.result)
    return rec


# --- 14. the part-mask overlays ------------------------------------------
TOOLS_FRAMES = 3
TOOLS_ALPHAS = (0.5, 0.3)


def every_value(rng, shape):
    """float32 ``shape`` filled with permutations of 0-255 end to end:
    every mask value, each about as often."""
    n = math.prod(shape)
    flat = np.concatenate([rng.permutation(256) for _ in range(-(-n // 256))])
    return flat[:n].reshape(shape).astype(np.float32)


def numpy_blend(base, masks, alpha):
    """rain_tpu/tools/combine_masks.py:49-59 in numpy (None: missing)."""
    final = base.copy()
    for mask, color in zip(masks, combine_masks.DEFAULT_COLORS.values()):
        if mask is None or not (mask > 0).any():
            continue
        color_img = (mask[..., None] / 255.0) * np.array(color, np.float32)
        a = (mask / 255.0 * alpha)[..., None]
        final = (1 - a) * final + a * color_img
    return final


def blend_cases(rng):
    """Phase 14's masks at 1297x840: four of every value 0-255; every
    value, an empty mask, an all-255 mask and a seeded binary one."""
    shape = (HEIGHT, WIDTH)
    binary = np.where(rng.random(shape) < 0.5, 255.0, 0.0).astype(np.float32)
    return {"every_value": [every_value(rng, shape) for _ in range(4)],
            "empty_full_binary": [every_value(rng, shape),
                                  np.zeros(shape, np.float32),
                                  np.full(shape, 255.0, np.float32), binary]}


def mask_frames(root, rng):
    """Phase 14's CLI input: TOOLS_FRAMES base frames of 1297x840 and their
    masks as 8-bit PNGs, written with the port's PNG writer; frame 1 has
    an empty 001 and no 002, frame 2 an all-255 003."""
    for k in range(TOOLS_FRAMES):
        frame = f"frame_{k:03d}"
        images.save_png(root / "base" / f"{frame}.png",
                        rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8))
        for j, name in enumerate(combine_masks.DEFAULT_COLORS):
            mask = every_value(rng, (HEIGHT, WIDTH)).astype(np.uint8)
            if (k, j) == (1, 1):
                mask[:] = 0
            elif (k, j) == (1, 2):
                continue
            elif (k, j) == (2, 3):
                mask[:] = 255
            images.save_png(root / "masks" / frame / name, mask)


def tools_phase():
    """Phase 14: rain_tpu_torch.tools.combine_masks on the card. ``blend``
    at 1297x840 on the card against the CPU path and against rain_tpu's
    numpy arithmetic, bit for bit, at every mask value and with an empty,
    an all-255 and a binary mask, at two alphas; then, where PIL imports
    (the frame-name stamp needs it), ``combine_masks.main --device cuda``
    over three frames against ``--device cpu``, pixel for pixel. Returns
    the phase's record."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    base = rng.integers(0, 256, (HEIGHT, WIDTH, 3)).astype(np.float32)
    base_dev = torch.from_numpy(base).to(DEV)
    cases, checked = blend_cases(rng), 0
    for name, masks in cases.items():
        cpu_masks = [torch.from_numpy(m) for m in masks]
        dev_masks = [m.to(DEV) for m in cpu_masks]
        for alpha in TOOLS_ALPHAS:
            want = numpy_blend(base, masks, alpha)
            on_cpu = combine_masks.blend(torch.from_numpy(base), cpu_masks,
                                         alpha)
            on_card = combine_masks.blend(base_dev, dev_masks, alpha).cpu()
            if not np.array_equal(on_cpu.numpy().view(np.uint32),
                                  want.view(np.uint32)):
                raise AssertionError(f"blend on the CPU differs from "
                                     f"rain_tpu's arithmetic ({name}, "
                                     f"alpha {alpha})")
            if not torch.equal(on_card.view(torch.int32),
                               on_cpu.view(torch.int32)):
                bad = int((on_card != on_cpu).sum())
                raise AssertionError(f"blend on the card differs from the "
                                     f"CPU path at {bad} values ({name}, "
                                     f"alpha {alpha})")
            checked += 1
    # for the record: torch's division by a host scalar on the card (a
    # product by its reciprocal) against numpy's, over the 256 mask values
    values = torch.arange(256, dtype=torch.float32)
    host_div = int(((values.to(DEV) / 255.0).cpu() !=
                    torch.from_numpy(values.numpy() / 255.0)).sum())
    masks_dev = [torch.from_numpy(m).to(DEV) for m in cases["every_value"]]
    blend_ms = device_ms(lambda: combine_masks.blend(base_dev, masks_dev,
                                                     0.5))
    print(f"tools: blend at {WIDTH}x{HEIGHT} on the card equals the CPU "
          f"path and rain_tpu's arithmetic bit for bit ({checked} cases); "
          f"{blend_ms:.4f} ms per frame on the card ({nvidia_smi()}); "
          f"dividing by a host scalar instead would part from numpy at "
          f"{host_div} of the 256 mask values")
    rec = {"blend_cases": checked, "blend_ms": blend_ms,
           "host_scalar_division_off": host_div}
    if importlib.util.find_spec("PIL") is None:
        print("tools: PIL does not import here; skipped the combine_masks "
              "CLI (its frame-name stamp needs PIL)")
        rec.update(cli="skipped: no PIL", phase_s=time.perf_counter() -
                   t_phase)
        return rec
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        mask_frames(tmp, rng)
        argv = ["--masks", str(tmp / "masks"), "--base", str(tmp / "base")]
        wall = {}
        for run, dev in (("card", "cuda"), ("cpu", "cpu"),
                         ("card_again", "cuda")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = combine_masks.main(argv + ["--out", str(tmp / run),
                                             "--device", dev])
            wall[run] = time.perf_counter() - t
            if got["overlays"] != TOOLS_FRAMES or \
                    not got["device"].startswith(dev):
                raise AssertionError(f"combine_masks --device {dev}: {got}")
        for k in range(TOOLS_FRAMES):
            png = f"frame_{k:03d}.png"
            for run in ("card", "card_again"):
                if not np.array_equal(images.load(tmp / run / png),
                                      images.load(tmp / "cpu" / png)):
                    raise AssertionError(f"combine_masks --device cuda: "
                                         f"{png} differs from --device cpu")
    ms = {run: 1e3 * s / TOOLS_FRAMES for run, s in wall.items()}
    print(f"tools: combine_masks --device cuda over {TOOLS_FRAMES} frames "
          f"of {WIDTH}x{HEIGHT} equals --device cpu pixel for pixel; ms per "
          f"frame (read, blend, stamp, PNG write): card "
          f"{ms['card']:.1f} (first call) and {ms['card_again']:.1f}, cpu "
          f"{ms['cpu']:.1f} ({nvidia_smi()})")
    rec.update(cli_ms_per_frame=ms, phase_s=time.perf_counter() - t_phase)
    return rec


# --- 15. the compiled step ----------------------------------------------
COMPILED_REPS = 10          # host-clock calls per path and turn


def memory_of(run):
    """(peak MiB allocated above what was held, MiB reserved above what
    was reserved) over ``run()``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    out = run()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    more = (torch.cuda.memory_reserved() - reserved) / 2**20
    del out
    return peak, more


def path_times(paths):
    """Host ms per call of each path (name: fn), each call ending in a
    synchronize, in turns a, b, b, a; and ms per call of 10 calls queued
    back to back, then one synchronize (a Trainer's pipelined loop). The
    medians of each path's calls."""
    times = {k: [] for k in paths}
    queued = {k: [] for k in paths}
    names = list(paths)
    for name in names + names[::-1]:
        times[name] += host_ms(paths[name], COMPILED_REPS)[3]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(COMPILED_REPS):
            paths[name]()
        torch.cuda.synchronize()
        queued[name].append((time.perf_counter() - t) * 1e3 / COMPILED_REPS)
    return {k: {"host_ms": quartiles(times[k]),
                "queued_ms": float(np.median(queued[k]))} for k in paths}


def equal_bits(a, b):
    """Tensors equal bit for bit (floats through their bits: signed zeros
    and NaNs included)."""
    return bitwise_equal(a, b) if a.is_floating_point() else \
        torch.equal(a, b)


def compiled_phase(kernels):
    """Phase 15: the compiled step (train.compiled) on the 262k proxy,
    held to the eager step bit for bit: the 5 poses rendered (each frame
    another camera, low_pass, scale_modifier and n_alive than the capture's
    frame 0) and 5 chained training steps from phase 4's perturbed state
    (another camera, ground truth, low_pass, xyz_lr and n_alive each), the
    launch counters counting each compiled call once; a replayed step and
    frame make no synchronising call. Recorded per path (eager, compiled):
    host ms per step and per frame (each call synchronised, and 10 queued
    calls), the device's busy time, device operations and host launches
    per call (torch.profiler), peak and reserved MiB over a first call and
    two more, and the captures (key, ms). Adds the launches to
    ``kernels``. Returns the phase's record."""
    arrays = garden_proxy_state_arrays()
    truth = gmod.from_arrays(**arrays, device=DEV)
    state = gmod.from_arrays(**perturbed(arrays), device=DEV)
    del arrays
    cams = [pose(k).render_inputs(DEV) for k in range(N_POSES)]
    bg = torch.tensor(BG, device=DEV)
    kw = dict(width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
              max_instances=MAX_INSTANCES)
    gts = [step.eval_render(truth, c, bg, LOW_PASS, **kw).render
           for c in cams]
    del truth

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=DEV)

    def alive(k):
        return torch.full((), N_GAUSS - 997 * k, dtype=torch.int32,
                          device=DEV)

    leaves = {k: f32(v) for k, v in OPT_LEAVES.items()}
    steps = compiled.CompiledStep()
    torch.cuda.synchronize()
    reset_counts()
    frames = []
    for k in range(N_POSES):
        args = (state._replace(n_alive=alive(k)), cams[k], bg,
                f32(LOW_PASS + 0.01 * k), f32(1.0 - 0.02 * k))
        counts = read_counts()
        got = steps.eval_render(*args, **kw)
        after = read_counts()
        want = step.eval_render(*args, **kw)
        set_counts(after)
        if not all(equal_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"compiled eval_render differs from the "
                                 f"eager one at pose {k}")
        frames.append(int(got.num_instances))
        if {n: after[n] - counts[n] for n in counts} != {
                "expand_instances": 1, "composite_forward": 1,
                "composite_backward": 0, "reduce_instances": 0}:
            raise AssertionError(f"compiled frame {k}: launches {after}")
    s, o = state, adam_mod.init(state.params)
    losses = []
    for k in range(N_POSES):
        args = (s._replace(n_alive=alive(k)), o, cams[k], gts[k], bg,
                f32(LOW_PASS + 0.01 * k), f32(XYZ_LR * (1.0 - 0.1 * k)))
        tkw = dict(kw, opt_cfg_leaves=leaves)
        counts = read_counts()
        got = steps.train_step(*args, **tkw)
        after = read_counts()
        want = step.train_step(*args, **tkw)
        set_counts(after)
        flat = [snapshot(*r[:2]) for r in (got, want)]
        if not same_bits(*flat) or not all(equal_bits(
                getattr(got[2], f), getattr(want[2], f)) for f in (
                "loss", "l1", "num_instances", "instance_overflow")):
            raise AssertionError(f"compiled train_step differs from the "
                                 f"eager one at step {k}")
        if any(after[n] - counts[n] != 1 for n in counts):
            raise AssertionError(f"compiled step {k}: launches {after}")
        losses.append(float(got[2].loss))
        s, o = got[0], got[1]
    launches = read_counts()
    print(f"compiled: {N_POSES} frames and {N_POSES} chained steps equal "
          f"the eager ones bit for bit (losses {losses}, frame instances "
          f"{frames}); launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"compiled: losses {losses}")

    # the replays' synchronising calls (both keys are captured by now)
    step_args = (s._replace(n_alive=alive(1)), o, cams[1], gts[1], bg,
                 f32(LOW_PASS), f32(XYZ_LR))
    frame_args = (state._replace(n_alive=alive(0)), cams[1], bg,
                  f32(LOW_PASS), f32(1.0))
    tkw = dict(kw, opt_cfg_leaves=leaves)
    syncs = {"train_step": count_syncs(
        lambda: steps.train_step(*step_args, **tkw)),
             "eval_render": count_syncs(
        lambda: steps.eval_render(*frame_args, **kw))}
    print(f"compiled: synchronising calls per replay {json.dumps(syncs)}")
    if any(n for n, _ in syncs.values()):
        raise AssertionError(f"a replay waits for the card: {syncs}")

    paths = {"eager": lambda: step.train_step(*step_args, **tkw),
             "compiled": lambda: steps.train_step(*step_args, **tkw)}
    frame_paths = {
        "eager": lambda: step.eval_render(*frame_args, **kw),
        "compiled": lambda: steps.eval_render(*frame_args, **kw)}
    rec = {"losses": losses, "frame_instances": frames,
           "launches": launches, "syncs": {k: v[0] for k, v in
                                           syncs.items()},
           "step": path_record(paths), "frame": path_record(frame_paths)}
    for what, ps in (("step", paths), ("frame", frame_paths)):
        for name, fn in ps.items():
            rec[what][name]["event_ms"] = device_ms(fn, reps=10)
    # memory of the compiled path from a fresh CompiledStep: a first call
    # (the capture's) and two more
    for what, make in (
            ("step", lambda c: c.train_step(*step_args, **tkw)),
            ("frame", lambda c: c.eval_render(*frame_args, **kw))):
        fresh = compiled.CompiledStep()
        rec[what]["compiled"]["peak_mib"], \
            rec[what]["compiled"]["reserved_mib"] = memory_of(
                lambda: [make(fresh) for _ in range(3)])
        rec[what]["compiled"]["capture_ms"] = fresh.captures[0][1]
        del fresh
    rec["captures"] = [[list(k), ms] for k, ms in steps.captures]
    for what in ("step", "frame"):
        for name in ("eager", "compiled"):
            r = rec[what][name]
            print(f"compiled: {what} {name}: host {r['host_ms']['median']:.3f}"
                  f" ms ({r['queued_ms']:.3f} queued), device busy "
                  f"{r['busy_ms']:.3f} ms ({r['launches']:.0f} operations, "
                  f"events "
                  f"{r['event_ms']:.3f} ms), host launches "
                  f"{r['host_launches']:.0f}, peak {r['peak_mib']:.0f} MiB "
                  f"(reserved {r['reserved_mib']:.0f})")
    print(f"compiled: captures (key, ms) {rec['captures']} ({nvidia_smi()})")
    for k in kernels:
        k["launches_compiled"] = launches[k["name"]]
    return rec


def main(out: Path | None = None):
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi()
    print(smi)
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(card))

    # --- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s ({len(logs)} sources built)")
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    for name, lines in ptxas.items():
        for line in lines:
            print(f"  {name}: {line}")
    blocks_per_sm = {name: occupancy(name) for name in
                     ("expand", "reduce", "tile_render_fwd",
                      "tile_render_bwd")}
    print(f"resident blocks per SM: {blocks_per_sm}")
    if len(list(_build.CSRC.glob("*.cu"))) != 4:
        raise AssertionError("expected four kernel sources")
    b1_cases = b1_edge_cases()
    b2_cases = b2_edge_cases()

    # --- 2. the scene, and each forward kernel against its plain version -
    arrays = garden_proxy_state_arrays()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / "point_cloud.ply"
        checkpoint.save_ply_snapshot(
            path, gmod.from_arrays(**arrays, device=DEV))
        state = checkpoint.load_ply_snapshot(path)
    if state.params.xyz.device.type != DEV.type or state.n_alive != N_GAUSS:
        raise AssertionError("load_ply_snapshot did not load onto the card")
    cams = [pose(k).render_inputs() for k in range(N_POSES)]
    first, seen = render_frame(state, cams[0], WIDTH, HEIGHT)
    b1_err, b3_err = compare_forward(seen, WIDTH, HEIGHT, f"{WIDTH}x{HEIGHT}",
                                     MAX_INSTANCES)
    del seen

    crop_arrays = {k: v[:20_000] for k, v in arrays.items()}
    crop_state = gmod.from_arrays(**crop_arrays, device=DEV)
    crop_cam = pose(0, 256, 256).render_inputs(DEV)
    crop_out, crop = render_frame(crop_state, crop_cam, 256, 256)
    b3_err = max(b3_err, compare_tiles(
        crop["composite_B3"], tile_render.composite_forward_torch(
            *kernel_inputs(crop, 256, 256, MAX_INSTANCES)[1]),
        "B3 256x256, 20k Gaussians"))

    small = {k: v[:3000] for k, v in arrays.items()}
    kw = dict(width=160, height=112, sh_degree=SH_DEGREE,
              max_instances=1 << 15)
    on_card = step.eval_render(
        gmod.from_arrays(**small, device=DEV), pose(1, 160, 112)
        .render_inputs(DEV), torch.tensor(BG, device=DEV), LOW_PASS, **kw)
    on_cpu = step.eval_render(
        gmod.from_arrays(**small, device="cpu"), pose(1, 160, 112)
        .render_inputs("cpu"), torch.tensor(BG), LOW_PASS, **kw)
    for f in ("render", "final_t", "alpha"):
        torch.testing.assert_close(getattr(on_card, f).cpu(),
                                   getattr(on_cpu, f), rtol=1e-4, atol=3e-5)
    torch.testing.assert_close(on_card.depth.cpu(), on_cpu.depth,
                               rtol=1e-4, atol=1e-3)
    for f in ("radii", "num_instances", "overflow"):
        if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)):
            raise AssertionError(f"eval_render card vs CPU: {f} differs")
    # the CPU's vectorised expf and the card's round apart by an ulp, which
    # can flip a pixel sitting on the 1/255 or 1e-4 threshold
    flips = int((on_card.n_contrib.cpu() != on_cpu.n_contrib).sum())
    if flips > 1e-3 * on_cpu.n_contrib.numel():
        raise AssertionError(f"eval_render card vs CPU: n_contrib differs "
                             f"at {flips} pixels")
    print("eval_render on the card matches the CPU path (160x112, 3k)")

    # --- 3. the render path -----------------------------------------------
    bg = torch.tensor(BG, device=DEV)
    kw = dict(width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
              max_instances=MAX_INSTANCES)
    torch.cuda.synchronize()
    reset_counts()
    outs, frame_ms = [], []
    for cam in cams:
        t = time.perf_counter()
        outs.append(step.eval_render(state, cam, bg, LOW_PASS, **kw))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    render_launches = read_counts()
    print(f"render path launches: {render_launches}")
    if render_launches != {"expand_instances": N_POSES,
                           "composite_forward": N_POSES,
                           "composite_backward": 0, "reduce_instances": 0}:
        raise AssertionError(f"expected {N_POSES} launches of B1 and B3")
    n_inst = [int(o.num_instances) for o in outs]
    for o in outs:
        if o.render.shape != (3, HEIGHT, WIDTH) or \
                not bool(torch.isfinite(o.render).all()) or \
                not bool(torch.isfinite(o.depth).all()):
            raise AssertionError("render path output is not finite")
        if bool(o.overflow) or int(o.num_instances) <= 0:
            raise AssertionError(f"overflow or no instances: {n_inst}")
    if not torch.equal(first.render, outs[0].render):
        raise AssertionError("pose 0 renders differently on a second call")
    print(f"render path: {N_POSES} frames, num_instances {n_inst}, "
          f"median frame {np.median(frame_ms):.3f} ms")
    gts = [o.render for o in outs]
    del outs, first

    # --- 4. the training main path ----------------------------------------
    p_arrays = perturbed(arrays)
    state0 = gmod.from_arrays(**p_arrays, device=DEV)
    opt0 = adam_mod.init(state0.params)
    torch.cuda.synchronize()
    reset_counts()
    s, o = state0, opt0
    auxes, step_ms, seen0, first_step = [], [], None, None
    for k in range(N_POSES):
        t = time.perf_counter()
        (s, o, aux), seen = train(s, o, cams[k], gts[k], WIDTH, HEIGHT)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        auxes.append(aux)
        if k == 0:
            seen0, first_step = seen, snapshot(s, o)
    train_launches = read_counts()
    print(f"training path launches: {train_launches}")
    if any(v != N_POSES for v in train_launches.values()):
        raise AssertionError(f"expected {N_POSES} launches of each kernel")
    losses = [float(a.loss) for a in auxes]
    n_inst_train = [int(a.num_instances) for a in auxes]
    if not all(math.isfinite(v) for v in losses) or \
            any(bool(a.instance_overflow) for a in auxes):
        raise AssertionError(f"training: losses {losses}, instances "
                             f"{n_inst_train}")
    if not all(bool(torch.isfinite(p).all()) for p in s.params):
        raise AssertionError("training: params are not finite")
    final = s
    loss0_after = float(loss_ops.training_loss(
        step.eval_render(final, cams[0], bg, LOW_PASS, **kw).render,
        gts[0])[0])
    print(f"training: {N_POSES} steps, losses {losses}, pose 0 loss "
          f"{losses[0]:.6f} -> {loss0_after:.6f}, num_instances "
          f"{n_inst_train}, median step {np.median(step_ms):.3f} ms")
    if not loss0_after < losses[0]:
        raise AssertionError("the loss at pose 0 did not go down")
    (s1, o1, _), _ = train(state0, opt0, cams[0], gts[0], WIDTH, HEIGHT)
    if not same_bits(first_step, snapshot(s1, o1)):
        raise AssertionError("step 0 taken again differs: not bitwise "
                             "reproducible")
    print("training: step 0 taken again is bitwise identical")
    del s1, o1

    # --- 5. backward kernels against their plain versions -----------------
    b2_err, b4_err, b2_scale = compare_backward(seen0, f"{WIDTH}x{HEIGHT}")
    crop_state = gmod.from_arrays(**perturbed(crop_arrays), device=DEV)
    _, crop_seen = train(crop_state, adam_mod.init(crop_state.params),
                         crop_cam, crop_out.render, 256, 256)
    errs = compare_backward(crop_seen, "256x256, 20k Gaussians")
    b2_err, b4_err = max(b2_err, errs[0]), max(b4_err, errs[1])
    del crop_seen, crop_state

    # anisotropic, so that the rotations take a gradient too
    rng = np.random.default_rng(2)
    small_p = dict(perturbed(small),
                   scaling=rng.uniform(-5.0, -3.5, (3000, 3)),
                   rotation=rng.normal(size=(3000, 4)))
    gt_small = torch.from_numpy(
        rng.uniform(0, 1, (3, 112, 160)).astype(np.float32))
    steps_small = []
    for dev in (DEV, torch.device("cpu")):
        st = gmod.from_arrays(**small_p, device=dev)
        steps_small.append(step.train_step(
            st, adam_mod.init(st.params), pose(1, 160, 112).render_inputs(dev),
            gt_small.to(dev), torch.tensor(BG, device=dev), LOW_PASS, XYZ_LR,
            width=160, height=112, sh_degree=SH_DEGREE,
            max_instances=1 << 15, opt_cfg_leaves=OPT_LEAVES))
    (sc, oc, ac), (sh, oh, ah) = steps_small
    torch.testing.assert_close(ac.loss.cpu(), ah.loss, rtol=1e-5, atol=0.0)
    if int(ac.num_instances) != int(ah.num_instances):
        raise AssertionError("train_step card vs CPU: num_instances differs")
    for name, mc, mh in zip(gmod.GaussianParams._fields, oc.mu, oh.mu):
        err = float((mc.cpu() - mh).abs().max())
        if not err <= 1e-4 * float(mh.abs().max()):
            raise AssertionError(f"train_step card vs CPU: Adam mu {name} "
                                 f"off by {err:.3g}")
    print("train_step on the card matches the CPU path (160x112, 3k)")
    del steps_small, sc, oc, sh, oh

    # --- 6. timing --------------------------------------------------------
    stages_ms = stage_split(
        lambda ev: render_frame(state, cams[0], WIDTH, HEIGHT, ev),
        render_ops.STAGES)
    frame = host_ms(lambda: step.eval_render(state, cams[0], bg, LOW_PASS,
                                             **kw), 20)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step.eval_render(state, cams[0], bg, LOW_PASS, **kw)
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    prof = device_profile(
        lambda: step.eval_render(state, cams[0], bg, LOW_PASS, **kw))
    del state

    ts = {"s": final, "o": o, "k": 0}

    def one_step(events=None):
        k = ts["k"] % N_POSES
        (ts["s"], ts["o"], _), _ = train(ts["s"], ts["o"], cams[k], gts[k],
                                         WIDTH, HEIGHT, events)
        ts["k"] += 1

    train_stages_ms = stage_split(one_step, TRAIN_STAGES)
    steps_host = host_ms(one_step, 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    one_step()
    train_peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    train_prof = device_profile(one_step)
    fwd = sum(train_stages_ms[s] for s in render_ops.STAGES)
    train_split = {
        "forward": fwd, "loss": train_stages_ms["loss"],
        "backward": sum(train_stages_ms[s] for s in
                        render_ops.BACKWARD_STAGES + ("grads",)),
        "densify_stats": train_stages_ms["densify_stats"],
        "adam": train_stages_ms["adam"]}

    # kernels, on the inputs of training step 0
    step0_kernels, work = step_kernels(seen0, WIDTH, HEIGHT, MAX_INSTANCES)
    calls = {}
    for name, (call, plain, library, _, _) in step0_kernels.items():
        calls[name], calls[name + "_torch"] = call, plain
        if library:
            calls[library[0]] = library[1]
    # the [16, M] zero fill that preceded B4 until B4 wrote its zeros
    pack = seen0["tile_sort_gather"]
    calls["zero_fill_16xM"] = lambda: torch.zeros_like(pack)
    plain_reps = {"composite_forward_torch": 2, "composite_backward_torch": 2}
    dev_ms = {k: device_ms(f, reps=plain_reps.get(k, 20))
              for k, f in calls.items()}
    errs = {"expand_instances": b1_err, "composite_forward": b3_err,
            "composite_backward": b4_err, "reduce_instances": b2_err}
    kernels = []
    for name, source, replaces in KERNELS:
        _, _, library, nbytes, ops = step0_kernels[name]
        bound_ms, bound_by = bound(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": errs[name], "ms": dev_ms[name],
            "plain_ms": dev_ms[name + "_torch"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": dev_ms[library[0]] if library else None})
    work["b2_max_abs_per_row"] = b2_scale
    # --- 7. the Trainer loop -----------------------------------------------
    del ts, seen0, step0_kernels, calls, pack
    trainer_rec = trainer_phase(arrays, out.parent if out else None)
    with tempfile.TemporaryDirectory(dir=ROOT) as cli_dir:
        cli_dir = Path(cli_dir)
        # --- 8. the CLIs, with PIL blocked ----------------------------------
        cli_rec = cli_phase(arrays, cli_dir)
        # --- 9. the 30k production run, cut to 1000 iterations -------------
        prod_rec = production_phase()
        # --- 10. the A/B paths, at phase 4's step 0 --------------------------
        ab_rec = ab_phase(state0, cams[0], gts[0])
        # --- 11. the sharded step and CLI, ranks sharing the card ----------
        del state0, opt0
        sharded_rec = sharded_phase(arrays, gts[0], auxes[0], first_step,
                                    kernels, cli_dir=cli_dir,
                                    cli_capacity=cli_rec["capacity"])
    # --- 12. the end-state scale --------------------------------------------
    del arrays, gts, auxes, first_step
    scale_rec = scale_phase(kernels)
    # --- 13. the long end-to-end run from a sparse init ---------------------
    torch.cuda.empty_cache()
    e2e_rec = e2e_phase(kernels)
    # --- 14. the part-mask overlays -----------------------------------------
    tools_rec = tools_phase()
    # --- 15. the compiled step ----------------------------------------------
    torch.cuda.empty_cache()
    compiled_rec = compiled_phase(kernels)
    for k in kernels:
        k["launches_cli"] = {"train": cli_rec["launches_train"][k["name"]],
                             "render": cli_rec["launches_render"][k["name"]]}
        k["launches_production"] = prod_rec["launches"][k["name"]]
        k["launches_ab"] = ab_rec["launches"][k["name"]]

    record = {
        "card": card, "build_s": build_s, "ptxas": ptxas,
        "blocks_per_sm": blocks_per_sm, "b1_cases": b1_cases,
        "b2_cases": b2_cases,
        "render": {
            "frame_ms_main_path": frame_ms,
            "frame_ms_median": frame[0], "frame_ms_quartiles": frame[1],
            "frame_ms_max": frame[2],
            "device_busy_ms": prof["busy_ms"],
            "device_idle_share": 1.0 - prof["busy_ms"] / frame[0],
            "device_launches_per_frame": prof["launches"],
            "device_top": prof["top"],
            "peak_mib_per_frame": peak_mib,
            "stages_ms": stages_ms,
            "stages_sum_ms": float(sum(stages_ms.values())),
            "num_instances": n_inst, "launches": render_launches},
        "train": {
            "losses": losses, "loss_pose0_after": loss0_after,
            "num_instances": n_inst_train,
            "step_ms_main_path": step_ms,
            "step_ms_median": steps_host[0],
            "step_ms_quartiles": steps_host[1],
            "step_ms_max": steps_host[2], "step_ms_all": steps_host[3],
            "device_busy_ms": train_prof["busy_ms"],
            "device_idle_share": 1.0 - train_prof["busy_ms"] / steps_host[0],
            "device_launches_per_step": train_prof["launches"],
            "device_top": train_prof["top"],
            "peak_mib_per_step": train_peak_mib,
            "stages_ms": train_stages_ms,
            "split_ms": train_split,
            "stages_sum_ms": float(sum(train_stages_ms.values())),
            "launches": train_launches},
        "work": work,
        "dev_ms": dev_ms,
        "kernels": kernels,
        "trainer": trainer_rec,
        "cli": cli_rec,
        "production": prod_rec,
        "ab": ab_rec,
        "sharded": sharded_rec,
        "scale": scale_rec,
        "e2e": e2e_rec,
        "tools": tools_rec,
        "compiled": compiled_rec,
        "wall_s": time.perf_counter() - t_start,
    }
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: record["train"][k] for k in (
        "step_ms_median", "step_ms_quartiles", "step_ms_max",
        "device_busy_ms", "device_idle_share", "device_launches_per_step",
        "peak_mib_per_step", "split_ms", "stages_ms")}))
    print(json.dumps({k: record["render"][k] for k in (
        "frame_ms_median", "device_busy_ms", "device_idle_share",
        "device_launches_per_frame", "peak_mib_per_frame", "stages_ms")}))
    print(json.dumps(record["work"]))
    print(f"chip_smoke: wall time {record['wall_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        help="write the run's full record to this JSON file")
    main(parser.parse_args().out)
