"""Drive the PyTorch/CUDA port (rain_tpu_torch) on one NVIDIA card.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py [--out RECORD.json]

Phases, in order; any failure exits non-zero before the result lines:

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel under rain_tpu_torch/csrc with nvcc, timed.
2. The garden-proxy 262k scene of bench.py (262,144 Gaussians, SH degree
   3 with random f_rest) is saved with save_ply_snapshot and loaded onto
   the card with load_ply_snapshot. Each kernel's output in a frame of
   eval_render (kept by its on_stage hook) is held against its plain
   PyTorch version on the same inputs: B1 (expand_instances) at the main
   path's shapes, bit for bit; B3 (composite_forward) on the main path's
   frame and on a 256x256 view of 20k Gaussians, to rtol 1e-5 / atol 1e-6
   with n_contrib exact up to 1e-4 of the pixels. The whole eval_render
   on the card is held against the port's CPU path on a small scene, at
   the CPU tests' tolerances.
3. The main path at full width: eval_render from 5 poses at 1297x840
   with max_instances=786,432. The kernels' launch counters are set to 0
   just before and read just after; each kernel must have launched once
   per frame. The output must be finite, not overflow, and pose 0 must
   render as it did in phase 2.
4. Timing: per frame (host clock), per stage of eval_render (CUDA events
   from the on_stage hook), per kernel (median of CUDA-event times, beside
   its plain version, the library call that computes the same function
   where one exists, and its bound from the H100 SXM's published peaks).

It prints the nvidia-smi line, one {"kernels": [...]} line and, last, the
{"ok": true, "device": {...}} line; with --out it also writes every
number it took to that JSON file.
"""

import argparse
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
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
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


def render_frame(state, cam, width, height, events=None):
    """eval_render of one view with an on_stage hook. Returns the output
    and {stage: result} (see ops.render.STAGES). With `events` (a list),
    appends a CUDA event before the frame and one after each stage."""
    bg = torch.tensor(BG, device=state.params.xyz.device)
    seen = {}

    def on_stage(name, value):
        seen[name] = value
        if events is not None:
            events.append(_event())

    if events is not None:
        events.append(_event())
    out = step.eval_render(state, cam, bg, LOW_PASS, width=width,
                           height=height, sh_degree=SH_DEGREE,
                           max_instances=MAX_INSTANCES, on_stage=on_stage)
    if tuple(seen) != render_ops.STAGES:
        raise AssertionError(f"stages seen: {tuple(seen)}")
    return out, seen


def kernel_inputs(seen, width, height):
    """The inputs that kernels B1 and B3 were given in a frame: B1's
    (args, kwargs) and B3's args."""
    grid_x = (width + 15) // 16
    n_tiles = grid_x * ((height + 15) // 16)
    d = seen["depth_sort"]
    start, end = seen["tile_ranges"]
    return (((d.table, d.tiles, d.offs, d.rect_w, d.rect_base),
             dict(grid_x=grid_x, tile_offset=0, n_tiles=n_tiles,
                  max_instances=MAX_INSTANCES)),
            (seen["tile_sort_gather"], start, end, 0, grid_x))


def device_profile(render_once, frames=3):
    """torch.profiler over `frames` renders: per frame, the device's busy
    time (the sum of its kernels' and copies' times; one stream, so they do
    not overlap), the number of device operations launched and the
    largest of them by time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_once()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "busy_ms": sum(e.self_device_time_total for e in ops) / 1e3 / frames,
        "launches": sum(e.count for e in ops) / frames,
        "top": [[e.key[:100], e.self_device_time_total / 1e3 / frames,
                 e.count / frames] for e in ops[:12]],
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
    for _ in range(3):
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


def compare_tiles(got, want, what):
    """Kernel vs plain compositor output: floats to rtol 1e-5 / atol 1e-6,
    n_contrib exact but for at most 1e-4 of the pixels: a pixel whose
    alpha or transmittance sits on a threshold (1/255, 1e-4) can flip if
    expf or a product rounds one ulp apart. Returns the max abs error."""
    torch.testing.assert_close(got[..., :6], want[..., :6], rtol=1e-5,
                               atol=1e-6, msg=lambda m: f"{what}: {m}")
    n_px = got[..., 0].numel()
    flips = int((got[..., tile_render.CH_NCONTRIB] !=
                 want[..., tile_render.CH_NCONTRIB]).sum())
    print(f"{what}: n_contrib differs at {flips} of {n_px} pixels")
    if flips > 1e-4 * n_px:
        raise AssertionError(f"{what}: n_contrib differs at {flips} pixels")
    return float((got[..., :6] - want[..., :6]).abs().max())


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
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # --- 2. the scene, and each kernel against its plain version ----------
    # The kernels are checked on the inputs the main path gave them: the
    # warm-up frame of pose 0 of the PLY-loaded scene, and the same frame
    # at 256x256 with 20k Gaussians, where the plain compositor is quick.
    arrays = garden_proxy_state_arrays()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / "point_cloud.ply"
        checkpoint.save_ply_snapshot(
            path, gmod.from_arrays(**arrays, device=DEV))
        state = checkpoint.load_ply_snapshot(path)
    if state.params.xyz.device.type != "cuda" or state.n_alive != N_GAUSS:
        raise AssertionError("load_ply_snapshot did not load onto the card")
    cams = [pose(k).render_inputs() for k in range(N_POSES)]
    first, seen = render_frame(state, cams[0], WIDTH, HEIGHT)
    b1_args, b3_args = kernel_inputs(seen, WIDTH, HEIGHT)
    cols_k, keys_k = seen["expand_B1"]
    cols_p, keys_p = expand_ops.expand_instances_torch(*b1_args[0],
                                                       **b1_args[1])
    if not (torch.equal(cols_k, cols_p) and torch.equal(keys_k, keys_p)):
        raise AssertionError("B1 differs from expand_instances_torch")
    b1_err = float((cols_k - cols_p).abs().max())
    print(f"B1 at M={MAX_INSTANCES}: bitwise equal to its plain version")
    b3_err = compare_tiles(seen["composite_B3"],
                           tile_render.composite_forward_torch(*b3_args),
                           f"B3 {WIDTH}x{HEIGHT}")

    crop_state = gmod.from_arrays(
        **{k: v[:20_000] for k, v in arrays.items()}, device=DEV)
    _, crop = render_frame(crop_state, pose(0, 256, 256).render_inputs(DEV),
                           256, 256)
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

    # --- 3. main path -----------------------------------------------------
    bg = torch.tensor(BG, device=DEV)
    kw = dict(width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
              max_instances=MAX_INSTANCES)
    torch.cuda.synchronize()
    expand_ops.expand_instances.launches = 0
    tile_render.composite_forward.launches = 0
    outs, frame_ms = [], []
    for cam in cams:
        t = time.perf_counter()
        outs.append(step.eval_render(state, cam, bg, LOW_PASS, **kw))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"expand_instances": expand_ops.expand_instances.launches,
                "composite_forward": tile_render.composite_forward.launches}
    print(f"main path launches: {launches}")
    if any(v != N_POSES for v in launches.values()):
        raise AssertionError(f"expected {N_POSES} launches of each kernel")
    n_inst = [int(o.num_instances) for o in outs]
    for o in outs:
        if o.render.shape != (3, HEIGHT, WIDTH) or \
                not bool(torch.isfinite(o.render).all()) or \
                not bool(torch.isfinite(o.depth).all()):
            raise AssertionError("main path output is not finite")
        if bool(o.overflow) or int(o.num_instances) <= 0:
            raise AssertionError(f"overflow or no instances: {n_inst}")
    if not torch.equal(first.render, outs[0].render):
        raise AssertionError("pose 0 renders differently on a second call")
    print(f"main path: {N_POSES} frames, num_instances {n_inst}, "
          f"median frame {np.median(frame_ms):.3f} ms")

    # --- 4. timing --------------------------------------------------------
    split = {s: [] for s in render_ops.STAGES}
    for _ in range(10):
        events = []
        render_frame(state, cams[0], WIDTH, HEIGHT, events)
        torch.cuda.synchronize()
        for s, a, b in zip(render_ops.STAGES, events, events[1:]):
            split[s].append(a.elapsed_time(b))
    stages_ms = {s: float(np.median(v)) for s, v in split.items()}
    frame_loop = []
    for _ in range(20):
        t = time.perf_counter()
        step.eval_render(state, cams[0], bg, LOW_PASS, **kw)
        torch.cuda.synchronize()
        frame_loop.append((time.perf_counter() - t) * 1e3)
    # the frame's own peak, above the scene and the inputs kept for timing
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step.eval_render(state, cams[0], bg, LOW_PASS, **kw)
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    prof = device_profile(
        lambda: step.eval_render(state, cams[0], bg, LOW_PASS, **kw))
    if prof["busy_ms"] <= 0.0:
        raise AssertionError("the profiler recorded no device time")

    d_args, d_kw = b1_args
    n, m = d_args[0].shape[1], MAX_INSTANCES
    total = int(d_args[2][-1])
    b1_bytes = (10 * 4 + 4 + 8 + 4 + 4) * n + (10 * 4 + 8) * m
    n_eval, n_comp = tile_render.composite_work(*b3_args)
    live = min(total, m)
    n_tiles = b3_args[1].shape[0]
    b3_bytes = 10 * 4 * live + 2 * 4 * n_tiles + n_tiles * 256 * 8 * 4
    b3_ops = OPS_EVAL * n_eval + OPS_COMP * n_comp
    b3_bound = max(b3_bytes / PEAK_BYTES_S,
                   b3_ops / PEAK_F32_NOFMA_OPS_S) * 1e3
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
    }
    plain_reps = {"composite_forward_torch": 2}
    dev_ms = {k: device_ms(f, reps=plain_reps.get(k, 20))
              for k, f in calls.items()}
    kernels = [
        {"name": "expand_instances", "route": "cuda",
         "source": "rain_tpu_torch/csrc/expand.cu",
         "replaces": "rain_tpu/ops/expand.py:49",
         "launches": launches["expand_instances"], "max_abs_err": b1_err,
         "ms": dev_ms["expand_instances"],
         "plain_ms": dev_ms["expand_instances_torch"],
         "bound_ms": b1_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
         "library_ms": dev_ms["repeat_interleave"]},
        {"name": "composite_forward", "route": "cuda",
         "source": "rain_tpu_torch/csrc/tile_render_fwd.cu",
         "replaces": "rain_tpu/ops/tile_render.py:212",
         "launches": launches["composite_forward"], "max_abs_err": b3_err,
         "ms": dev_ms["composite_forward"],
         "plain_ms": dev_ms["composite_forward_torch"],
         "bound_ms": b3_bound,
         "bound_by": "operations" if b3_ops / PEAK_F32_NOFMA_OPS_S >
         b3_bytes / PEAK_BYTES_S else "bytes",
         "library_ms": None},
    ]
    record = {
        "card": card, "build_s": build_s,
        "frame_ms_main_path": frame_ms,
        "frame_ms_median": float(np.median(frame_loop)),
        "frame_ms_quartiles": [float(np.percentile(frame_loop, q))
                               for q in (25, 75)],
        "frame_ms_max": float(np.max(frame_loop)),
        "device_busy_ms": prof["busy_ms"],
        "device_idle_share": 1.0 - prof["busy_ms"] /
        float(np.median(frame_loop)),
        "device_launches_per_frame": prof["launches"],
        "device_top": prof["top"],
        "peak_mib_per_frame": peak_mib,
        "stages_ms": stages_ms,
        "stages_sum_ms": float(sum(stages_ms.values())),
        "num_instances": n_inst,
        "b1": {"n": n, "m": m, "total": total, "bytes": b1_bytes},
        "b3": {"n_tiles": n_tiles, "pairs_evaluated": n_eval,
               "pairs_composited": n_comp, "ops": b3_ops,
               "bytes": b3_bytes},
        "kernels": kernels,
    }
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: record[k] for k in (
        "frame_ms_median", "device_busy_ms", "device_idle_share",
        "device_launches_per_frame", "peak_mib_per_frame", "stages_ms",
        "stages_sum_ms", "b3")}))
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
