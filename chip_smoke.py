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
   the kernel failed to write shows.
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

It prints the nvidia-smi line, one {"kernels": [...]} line and, last, the
{"ok": true, "device": {...}} line; with --out it also writes every
number it took to that JSON file.
"""

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import _build
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.sh import rgb_to_sh_dc
from rain_tpu_torch.train import checkpoint
from rain_tpu_torch.train import step

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


def kernel_inputs(seen, width, height):
    """The inputs that kernels B1 and B3 were given in a frame or step:
    B1's (args, kwargs) and B3's args."""
    grid_x = (width + 15) // 16
    n_tiles = grid_x * ((height + 15) // 16)
    d = seen["depth_sort"]
    start, end = seen["tile_ranges"]
    return (((d.table, d.tiles, d.offs, d.rect_w, d.rect_base),
             dict(grid_x=grid_x, tile_offset=0, n_tiles=n_tiles,
                  max_instances=MAX_INSTANCES)),
            (seen["tile_sort_gather"], start, end, 0, grid_x))


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
    """Resident blocks per SM of B1 or a compositor kernel (its C entry
    rain_expand_occupancy or rain_composite_{forward,backward}_occupancy)."""
    entry = {"expand": "rain_expand_occupancy",
             "tile_render_fwd": "rain_composite_forward_occupancy",
             "tile_render_bwd": "rain_composite_backward_occupancy"}[lib]
    blocks = ctypes.c_int(0)
    _build.launch(_build.kernel(lib, entry, (ctypes.c_void_p,)), DEV,
                  ctypes.addressof(blocks))
    return blocks.value


def b1_edge_cases():
    """B1 against its plain version at the edge cases of
    tests/torch_expand_cases.py (numpy and torch only), bit for bit, at the
    main path's N and M unless the case sets them. Returns {case: (N, M,
    instances)}."""
    spec = importlib.util.spec_from_file_location(
        "torch_expand_cases", ROOT / "tests" / "torch_expand_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
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
                     ("expand", "tile_render_fwd", "tile_render_bwd")}
    print(f"resident blocks per SM: {blocks_per_sm}")
    if len(list(_build.CSRC.glob("*.cu"))) != 4:
        raise AssertionError("expected four kernel sources")
    b1_cases = b1_edge_cases()

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
    b1_args, b3_args = kernel_inputs(seen, WIDTH, HEIGHT)
    cols_k, keys_k = seen["expand_B1"]
    cols_p, keys_p = expand_ops.expand_instances_torch(*b1_args[0],
                                                       **b1_args[1])
    if not (bitwise_equal(cols_k, cols_p) and torch.equal(keys_k, keys_p)):
        raise AssertionError("B1 differs from expand_instances_torch")
    b1_err = float((cols_k - cols_p).abs().max())
    print(f"B1 at M={MAX_INSTANCES}: bitwise equal to its plain version")
    b3_err = compare_tiles(seen["composite_B3"],
                           tile_render.composite_forward_torch(*b3_args),
                           f"B3 {WIDTH}x{HEIGHT}")
    del seen, b1_args, b3_args, cols_k, keys_k, cols_p, keys_p

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
    b1_args, b3_args = kernel_inputs(seen0, WIDTH, HEIGHT)
    d_args, d_kw = b1_args
    n, m = d_args[0].shape[1], MAX_INSTANCES
    total = int(d_args[2][-1])
    live = min(total, m)
    b1_bytes = (10 * 4 + 4 + 8 + 4 + 4) * n + (10 * 4 + 8) * m
    n_eval, n_comp = tile_render.composite_work(*b3_args)
    n_tiles = b3_args[1].shape[0]
    b3_bytes = 10 * 4 * live + 2 * 4 * n_tiles + n_tiles * 256 * 8 * 4
    b3_ops = OPS_EVAL * n_eval + OPS_COMP * n_comp
    b4_args = seen0["composite_bwd_B4"][0]
    d_rank, exc, tiles_n, _ = seen0["reduce_B2"]
    # B4 re-evaluates each pixel's pairs up to its n_contrib and
    # differentiates the composited ones (the forward's)
    b4_eval = int(b4_args[5][..., tile_render.CH_NCONTRIB].sum())
    b4_ops = OPS_EVAL * b4_eval + OPS_BWD_COMP * n_comp
    rows = tile_render.GRAD_ROWS
    b4_bytes = (2 * rows * 4 * live + 4 * n_tiles +
                2 * n_tiles * 256 * 8 * 4)
    b2_bytes = rows * 4 * live + (8 + 4) * n + rows * 4 * n
    b2_ops = rows * live
    seg_lengths = tiles_n.to(torch.int64).expand(rows, n).contiguous()
    seg_data = d_rank[:, :live].contiguous()

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_NOFMA_OPS_S
        return max(t_bytes, t_ops) * 1e3, \
            "operations" if t_ops > t_bytes else "bytes"

    calls = {
        "expand_instances": lambda: expand_ops.expand_instances(
            *d_args, **d_kw),
        "expand_instances_torch": lambda: expand_ops.expand_instances_torch(
            *d_args, **d_kw),
        "repeat_interleave": lambda: torch.repeat_interleave(
            d_args[0], d_args[1], dim=1, output_size=total),
        "composite_forward": lambda: tile_render.composite_forward(*b3_args),
        "composite_forward_torch":
            lambda: tile_render.composite_forward_torch(*b3_args),
        "composite_backward": lambda: tile_render.composite_backward(
            *b4_args),
        "composite_backward_torch":
            lambda: tile_render.composite_backward_torch(*b4_args),
        "reduce_instances": lambda: expand_ops.reduce_instances(
            d_rank, exc, tiles_n),
        "reduce_instances_torch": lambda: expand_ops.reduce_instances_torch(
            d_rank, exc, tiles_n),
        "segment_reduce": lambda: torch.segment_reduce(
            seg_data, "sum", lengths=seg_lengths, axis=1),
        # the [16, M] zero fill that preceded B4 until B4 wrote its zeros
        "zero_fill_16xM": lambda: torch.zeros_like(b3_args[0]),
    }
    plain_reps = {"composite_forward_torch": 2, "composite_backward_torch": 2}
    dev_ms = {k: device_ms(f, reps=plain_reps.get(k, 20))
              for k, f in calls.items()}
    launches = train_launches
    rows = [
        ("expand_instances", "rain_tpu_torch/csrc/expand.cu",
         "rain_tpu/ops/expand.py:49", b1_err, "expand_instances_torch",
         (b1_bytes, 0), "repeat_interleave"),
        ("composite_forward", "rain_tpu_torch/csrc/tile_render_fwd.cu",
         "rain_tpu/ops/tile_render.py:212", b3_err, "composite_forward_torch",
         (b3_bytes, b3_ops), None),
        ("composite_backward", "rain_tpu_torch/csrc/tile_render_bwd.cu",
         "rain_tpu/ops/tile_render.py:279", b4_err,
         "composite_backward_torch", (b4_bytes, b4_ops), None),
        ("reduce_instances", "rain_tpu_torch/csrc/reduce.cu",
         "rain_tpu/ops/expand.py:145", b2_err, "reduce_instances_torch",
         (b2_bytes, b2_ops), "segment_reduce"),
    ]
    kernels = []
    for name, source, replaces, err, plain, work, library in rows:
        bound_ms, bound_by = bound(*work)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": dev_ms[name],
            "plain_ms": dev_ms[plain], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": dev_ms[library] if library else None})
    record = {
        "card": card, "build_s": build_s, "ptxas": ptxas,
        "blocks_per_sm": blocks_per_sm, "b1_cases": b1_cases,
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
        "work": {
            "n": n, "m": m, "total": total, "n_tiles": n_tiles,
            "b1_bytes": b1_bytes, "b3_pairs_evaluated": n_eval,
            "pairs_composited": n_comp, "b3_ops": b3_ops,
            "b3_bytes": b3_bytes, "b4_pairs_evaluated": b4_eval,
            "b4_ops": b4_ops, "b4_bytes": b4_bytes, "b2_bytes": b2_bytes,
            "b2_max_abs_per_row": b2_scale},
        "dev_ms": dev_ms,
        "kernels": kernels,
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
