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
7. The Trainer loop at full width: rain_tpu_torch.train.trainer.Trainer
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
   bit. At B's first step after the growth (iteration 21: capacity
   786,432 with dead rows at its tail, the grown tier) B1, B3, B4 and B2
   are held against their plain versions bit for bit on that step's
   inputs, and timed there beside their bounds. A run with pipeline 0
   (C) equals B bit for bit, and a run resumed from the checkpoint at 30
   (D) reaches 60 with finite losses. Recorded: the KNN's time, host ms
   per iteration with pipeline 1 and 0, ms per densify round, capacity
   growth (the state's) and retried step, tiers and instance counts of
   every step, n_alive per round, the device's busy time per iteration
   and its idle share over B's profiled window (busy time over that
   window's host-clock time), peak memory, the synchronising calls of one
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

It prints the nvidia-smi line, one {"kernels": [...]} line and, last, the
{"ok": true, "device": {...}} line; with --out it also writes every
number it took to that JSON file, and B2's tiles and M at the Trainer step
to b2_trainer_step.npz beside it (the input of chip_ablate.py --b2-step).
"""

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import json
import math
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
from rain_tpu_torch.data import colmap as colmap_io
from rain_tpu_torch.data import images
from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.data.cameras import Camera, fov2focal
from rain_tpu_torch.data.dataset import SceneData, nerfpp_norm
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import knn as knn_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.sh import rgb_to_sh_dc, sh_dc_to_rgb
from rain_tpu_torch.scripts import metrics as metrics_cli
from rain_tpu_torch.scripts import render as render_cli
from rain_tpu_torch.scripts import train as train_cli
from rain_tpu_torch.train import checkpoint
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
# as two operations; the kernels are built with -fmad=false, so each add
# or multiply issues alone, at half that rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_NOFMA_OPS_S = 67e12 / 2
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


def kernel_inputs(seen, width, height, max_instances=None):
    """The inputs that kernels B1 and B3 were given in a frame or step
    (at the tier max_instances, MAX_INSTANCES if None): B1's (args,
    kwargs) and B3's args."""
    grid_x = (width + 15) // 16
    n_tiles = grid_x * ((height + 15) // 16)
    d = seen["depth_sort"]
    start, end = seen["tile_ranges"]
    return (((d.table, d.tiles, d.offs, d.rect_w, d.rect_base),
             dict(grid_x=grid_x, tile_offset=0, n_tiles=n_tiles,
                  max_instances=max_instances or MAX_INSTANCES)),
            (seen["tile_sort_gather"], start, end, 0, grid_x))


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
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_NOFMA_OPS_S
    return max(t_bytes, t_ops) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes"


def step_kernels(seen, width, height, max_instances):
    """B1–B4 of one training step, on the inputs the step gave them (its
    on_stage hook). Returns ({kernel: (its wrapper's call, its plain
    version's call, (the library call's name, the call) or None, bytes,
    f32 operations)}, the step's work): the bytes count each input read
    once and each output written once, the operations the pairs this
    step's data makes the compositors evaluate and composite; instances
    past the tier are dropped, so min(instances, M) columns count."""
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
        "b3_ops": OPS_EVAL * n_eval + OPS_COMP * n_comp,
        "b3_bytes": 10 * 4 * live + 2 * 4 * n_tiles +
        n_tiles * 256 * 8 * 4,
        "b4_pairs_evaluated": b4_eval,
        "b4_ops": OPS_EVAL * b4_eval + OPS_BWD_COMP * n_comp,
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


def device_profile(run_once, reps=3):
    """torch.profiler over `reps` calls: per call, the device's busy time
    (the sum of its kernels' and copies' times; one stream, so they do not
    overlap), the number of device operations launched and the largest of
    them by time."""
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


def bitwise_equal(a, b):
    """Equal bit for bit, signed zeros included (torch.equal takes -0.0
    for +0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def compare_tiles(got, want, what):
    """Kernel vs plain compositor output, bit for bit in all 8 channels:
    the kernel does the plain loop's operations in its order (built with
    -fmad=false) and skips only pairs that the loop skips. Returns the max
    abs error (0)."""
    if not bitwise_equal(got, want):
        n_px = got[..., 0].numel()
        flips = int((got[..., tile_render.CH_NCONTRIB] !=
                     want[..., tile_render.CH_NCONTRIB]).sum())
        raise AssertionError(
            f"{what}: B3 differs from its plain version (max abs "
            f"{float((got - want).abs().max()):.3g}, n_contrib at {flips} "
            f"of {n_px} pixels)")
    print(f"{what}: B3 bitwise equal to its plain version")
    return float((got - want).abs().max())


@torch.no_grad()
def compare_forward(seen, width, height, what, max_instances=None):
    """B1 and B3 of one frame or step against their plain versions on the
    inputs it gave them, bit for bit (B1 in columns and keys). Returns
    their max abs errors. Without autograd: a training step's pack
    carries its graph, and the plain loops would record theirs."""
    b1_args, b3_args = kernel_inputs(seen, width, height, max_instances)
    cols_k, keys_k = seen["expand_B1"]
    cols_p, keys_p = expand_ops.expand_instances_torch(*b1_args[0],
                                                       **b1_args[1])
    if not (bitwise_equal(cols_k, cols_p) and torch.equal(keys_k, keys_p)):
        raise AssertionError(f"B1 {what} differs from "
                             f"expand_instances_torch")
    print(f"B1 {what}, M={b1_args[1]['max_instances']}: bitwise equal to "
          f"its plain version")
    b1_err = float((cols_k - cols_p).abs().max())
    del cols_p, keys_p
    return b1_err, compare_tiles(
        seen["composite_B3"], tile_render.composite_forward_torch(*b3_args),
        f"B3 {what}")


@torch.no_grad()
def compare_backward(seen, what):
    """B2 and B4 of one training step against their plain versions on the
    inputs the step gave them. B2 sums each segment from 0.0 in the plain
    version's order, so the two are equal bit for bit; the gradients of a
    loss averaged over millions of pixels are small, so no absolute bar
    would do (each row's max |value| is printed). B4 follows the plain
    version's arithmetic and pixel-sum order, so the two are equal bit for
    bit in every row, zero rows and columns included. Returns (B2's,
    B4's) max abs error and B2's max |value| per row."""
    d_rank, exc, tiles, d_depth = seen["reduce_B2"]
    want = expand_ops.reduce_instances_torch(d_rank, exc, tiles)
    scale = want.abs().amax(dim=1).tolist()
    print(f"B2 {what}: max |value| per row {[f'{v:.3g}' for v in scale]}")
    if not torch.equal(d_depth, want):
        raise AssertionError(f"B2 {what} differs from its plain version")
    b2_err = float((d_depth - want).abs().max())
    args, d_pack = seen["composite_bwd_B4"]
    want = tile_render.composite_backward_torch(*args)
    err = (d_pack - want).abs()
    if not bitwise_equal(d_pack, want):
        raise AssertionError(
            f"B4 {what} differs from its plain version: max abs error per "
            f"row {[f'{float(e):.3g}' for e in err.amax(dim=1)]}")
    print(f"B2 {what}: bitwise equal; B4 {what}: bitwise equal in all "
          f"{d_pack.shape[0]} rows")
    return b2_err, float(err.max()), scale


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


def tests_module(name):
    """A helper module of tests/ that imports numpy and torch only."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    for f in counters().values():
        f.launches = 0


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
def recorded(capture=None):
    """A Trainer's loop recorded while active by the wrappers of
    tests/torch_trainer_trace.py, which the Trainer tests share: every
    step's call, round, reset and growth, each round and growth timed with
    a synchronize on each side. ``capture`` (a KernelCapture) wraps
    train_step once more."""
    with TRACE.Patches() as patches:
        trace = TRACE.record(patches.setattr, step, densify_mod, gmod,
                             timer=timed)
        if capture is not None:
            patches.setattr(step, "train_step",
                            capture.wrap(step.train_step))
        yield trace


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
    """Runs trainer_step_kernels on the first step a Trainer dispatches at
    a capacity above ``after_capacity`` (after a growth, so with dead rows
    at the tail of the state) that does not overflow its tier. Such steps
    run with an on_stage hook, and the checks run as the step returns."""

    def __init__(self, after_capacity):
        self.after = after_capacity
        self.result = None
        self.b2_tiles = None   # B2's tiles and M there, for chip_ablate.py

    def wrap(self, train_step):
        def wrapped(state, opt, *a, **kw):
            if self.result is not None or state.capacity <= self.after:
                return train_step(state, opt, *a, **kw)
            seen = {}
            out = train_step(state, opt, *a, on_stage=stage_hook(seen), **kw)
            if not bool(out[2].instance_overflow):
                self.result = trainer_step_kernels(
                    seen, kw["width"], kw["height"], kw["max_instances"],
                    state)
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
    calls, t = trace["calls"], trace["t"]
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
        del tr, ply, cam_in, gt, gt_bucket

        # B: the same seed, pipelined, to 25: profiled over 10 iterations,
        # and B1-B4 held against their plain versions at iteration 21, the
        # first step after the growth (run A's inputs: B equals A bit for
        # bit, and its launches are not counted)
        with np.load(tmp / "a" / f"chkpnt{BITWISE_AT}.npz") as z:
            saved = {k: z[k] for k in z.files}
        capture = KernelCapture(after_capacity=trainer_configs()[
            "system"].capacity)
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
            height=HEIGHT, sh_degree=SH_DEGREE, max_instances=MAX_INSTANCES)
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


def cli_phase(arrays):
    """The train, render and metrics CLIs on a COLMAP scene at full width,
    with PIL blocked (phase 8). Returns its record."""
    rec = {}
    bg = torch.tensor(BG, device=DEV)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp, pil_blocked():
        tmp = Path(tmp)
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
        argv = ["-s", str(src), "--num_cams", str(CLI_VIEWS // 2),
                "--iterations", str(CLI_ITERS), "--test_iterations", "0",
                str(CLI_ITERS), "--save_iterations", str(CLI_ITERS),
                "--checkpoint_iterations", str(CLI_RESUME)]
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

        # test view 0: the PNG is the truncated eval_render of the PLY, bit
        # for bit, and B3 on that frame is its plain version's bits
        tier = max(8 * state.n_alive, 262_144)
        cam_in = test_cam.render_inputs(DEV)
        frame, second = trainer_mod.render_whole(
            state, cam_in, bg, LOW_PASS, width=WIDTH, height=HEIGHT,
            sh_degree=SH_DEGREE, max_instances=tier)
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


def main(out: Path | None = None):
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
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
    b1_err, b3_err = compare_forward(seen, WIDTH, HEIGHT, f"{WIDTH}x{HEIGHT}")
    del seen

    crop_arrays = {k: v[:20_000] for k, v in arrays.items()}
    crop_state = gmod.from_arrays(**crop_arrays, device=DEV)
    crop_cam = pose(0, 256, 256).render_inputs(DEV)
    crop_out, crop = render_frame(crop_state, crop_cam, 256, 256)
    b3_err = max(b3_err, compare_tiles(
        crop["composite_B3"], tile_render.composite_forward_torch(
            *kernel_inputs(crop, 256, 256)[1]),
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
    # --- 8. the CLIs, with PIL blocked --------------------------------------
    cli_rec = cli_phase(arrays)
    for k in kernels:
        k["launches_cli"] = {"train": cli_rec["launches_train"][k["name"]],
                             "render": cli_rec["launches_render"][k["name"]]}

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
