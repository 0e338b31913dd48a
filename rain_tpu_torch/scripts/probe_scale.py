"""Scaling probe: the full train step at garden's end-state tiers.

Port of tools/probe_scale.py. Each tier is bench.py's scene
(bench.py:58-72: uniform means in a 6 x 6 x 10 box, random colours, zero
SH rest, one log-scale for every axis, opacity logit -1) at garden's
images_4 resolution (1297x840), trained from bench.py's camera at the
tier's instance capacity through the compiled step
(train.compiled.CompiledStep.train_step, as the tool times rain_tpu's
jitted ``train_step``), or with ``--eager`` through the eager
``train_step``. Per tier it reports:

- the first step (step 0, always eager: it keeps its ``on_stage`` hook),
  on the host clock up to a synchronize (no compilation here: it holds
  the allocator's and the libraries' first use, and the kernels' nvcc
  build if they were not built yet);
- the step-0 instance count and overflow flag;
- the second step, alone: on the compiled path the key's capture (its
  warm-up and the graph's capture; ``captures``: key and ms);
- the median of ``iters`` further steps (replays on the compiled path),
  each on the host clock up to a synchronize (the tool divides one
  back-to-back loop by its count);
- the peak device memory allocated and reserved (the graph's pool
  included) and the launches of kernels B1-B4.

Run:  python -m rain_tpu_torch.scripts.probe_scale [tier ...]
      [--iters 10] [--trace DIR] [--eager] [--device cpu]

With no tier it runs all seven, in the tool's order. ``--trace DIR`` (the
tool's PROBE_TRACE) profiles 3 more steps of each tier with
torch.profiler: DIR/<tier>.json is the Chrome trace, DIR/<tier>.txt the
table of device time by kernel, and the record gains per step the
device's busy time and operations, the host's launch calls, and the
device time of the compiled step's copies of the inputs in and the
outputs out (the operations launched inside its ``rain.compiled.copy_in``
and ``copy_out`` spans; none on the eager path). A tier
that runs out of device memory is reported as such and the probe goes on
with the next, on either path. Like the port's other entry points it
runs on the CUDA card and raises without one unless --device cpu, where
the compiled step runs the eager one.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import projection
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.sh import rgb_to_sh_dc
from rain_tpu_torch.train import compiled as compiled_mod
from rain_tpu_torch.train import step as step_mod

# name -> (Gaussians, instance tier, log-scale), tools/probe_scale.py:18-28
TIERS = {
    "262k": (262_144, 786_432, -4.5),
    "262k-pow2": (262_144, 1 << 20, -4.5),
    "1m": (1 << 20, 1 << 21, -5.2),     # 1.64M instances -> 2^21 tier
    "1m-wide": (1 << 20, 1 << 22, -5.2),
    "4m": (1 << 22, 6_291_456, -5.9),
    "4m-pow2": (1 << 22, 1 << 23, -5.9),
    # the tool's headroom probe: 8.4M Gaussians at the 2^24 instance tier
    # (exhausted the memory of the TPU it was written for)
    "8m-16minst": (1 << 23, 1 << 24, -5.9),
}
WIDTH, HEIGHT = 1297, 840
SH_DEGREE = 3
LOW_PASS = 0.3
XYZ_LR = 1.6e-4                                              # bench.py:85
OPT_LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05,      # bench.py:79
              "scaling_lr": 0.005, "rotation_lr": 0.001}
TRACE_STEPS = 3
# the CUDA runtime's launch calls: kernels, graphs, copies and fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
# the compiled step's host spans around its copies into and out of a graph
COPY_SPANS = (compiled_mod.SPAN + "copy_in", compiled_mod.SPAN + "copy_out")


class TierState(NamedTuple):
    """A tier's scene: the state, Adam's, bench.py's camera, the target."""
    state: gmod.GaussianState
    opt: adam_mod.AdamState
    camera: dict                 # Camera.render_inputs
    gt: torch.Tensor             # [3, H, W] uniform noise
    bg: torch.Tensor             # black


def bench_camera() -> Camera:
    """bench.py's camera: at the origin looking down +z, fov 1.0 x 0.7."""
    return Camera(uid=0, image_name="probe", R=np.eye(3), T=np.zeros(3),
                  fovx=1.0, fovy=0.7, image=None, width=WIDTH, height=HEIGHT)


def bench_arrays(n: int, width: int, height: int, seed: int = 0):
    """bench.py:58-72's arrays from the numpy stream ``default_rng(seed)``,
    in its order: ``n`` means in a 6 x 6 x 10 box, their colours, then a
    uniform-noise target of [3, height, width] (float32 each)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        rng.uniform(-3, 3, (n, 2)), rng.uniform(2.0, 12.0, (n, 1))],
        axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    img = rng.uniform(0, 1, (3, height, width)).astype(np.float32)
    return pts, cols, img


def build_tier_state(n: int, log_scale: float, *, device=None,
                     seed: int = 0) -> TierState:
    """bench.py:58-72's scene of ``n`` Gaussians at WIDTH x HEIGHT
    (bench_arrays)."""
    dev = device_mod.resolve(device)
    pts, cols, img = bench_arrays(n, WIDTH, HEIGHT, seed)
    state = gmod.from_arrays(
        xyz=pts, f_dc=rgb_to_sh_dc(cols)[:, None, :],
        f_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.full((n, 3), log_scale, np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n, 1), -1.0, np.float32), capacity=n, device=dev)
    return TierState(state, adam_mod.init(state.params),
                     bench_camera().render_inputs(dev),
                     torch.from_numpy(img).to(dev),
                     torch.zeros(3, dtype=torch.float32, device=dev))


def preprocess_instances(ts: TierState) -> int:
    """The instances of a step on ``ts`` from ``preprocess`` alone: the
    tiles each visible Gaussian touches, which ``sorted_pack`` sums.
    Rects do not depend on SH, so at degree 0."""
    scales, quats, opac, shs = gmod.activate(ts.state.params)
    prep = projection.preprocess(
        ts.state.params.xyz, scales, quats, opac, shs[:, :1],
        gmod.alive_mask(ts.state), sh_degree=0,
        world_view=ts.camera["world_view"], full_proj=ts.camera["full_proj"],
        camera_center=ts.camera["camera_center"],
        tan_fovx=ts.camera["tanfovx"], tan_fovy=ts.camera["tanfovy"],
        width=WIDTH, height=HEIGHT,
        grid=((WIDTH + 15) // 16, (HEIGHT + 15) // 16), low_pass=LOW_PASS)
    return int(prep.tiles_touched.sum())


def train_once(ts: TierState, state, opt, max_instances: int, *,
               on_stage=binning_ops.no_stage_hook, steps=None):
    """One bench.py step (bench.py:74-88) from (state, opt): through
    ``steps`` (a CompiledStep; it takes no hook), or eager with None."""
    kw = dict(width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
              max_instances=max_instances, opt_cfg_leaves=OPT_LEAVES,
              update_densify_stats=True)
    if steps is not None:
        return steps.train_step(state, opt, ts.camera, ts.gt, ts.bg,
                                LOW_PASS, XYZ_LR, **kw)
    return step_mod.train_step(state, opt, ts.camera, ts.gt, ts.bg,
                               LOW_PASS, XYZ_LR, on_stage=on_stage, **kw)


def kernel_launches() -> dict:
    """The launch counts of kernels B1-B4 (their wrappers' counters)."""
    return {"expand_instances": expand_ops.expand_instances.launches,
            "composite_forward": tile_render.composite_forward.launches,
            "composite_backward": tile_render.composite_backward.launches,
            "reduce_instances": expand_ops.reduce_instances.launches}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def span_ops(events: list, spans=COPY_SPANS) -> dict:
    """{name: (device us, count)} of the device operations in a Chrome
    trace's ``events`` that were launched while one of the host ranges
    ``spans`` was open (their runtime call and the operation share a
    correlation id)."""
    ranges, launched = [], {}
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in spans and \
                "dur" in e:
            ranges.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launched[e["args"].get("correlation")] = e["ts"]
    out = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in ranges):
            us, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (us + e["dur"], n + 1)
    return out


def _profile(run, dev, path: Path) -> dict:
    """torch.profiler over TRACE_STEPS calls of ``run``: the Chrome trace
    and the table to ``path`` (.json, .txt); per call (on the card) the
    device's busy time and operations, the host's launch calls
    (HOST_LAUNCH_CALLS) and the device time of the compiled step's copies
    into and out of its graph (the operations launched inside its
    COPY_SPANS; none on the eager path), with each operation's ms and
    count."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(TRACE_STEPS):
            run()
        _sync(dev)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path.with_suffix(".json")))
    by = "self_device_time_total" if dev.type == "cuda" else \
        "self_cpu_time_total"
    events = prof.key_averages()
    path.with_suffix(".txt").write_text(events.table(sort_by=by,
                                                     row_limit=40))
    if dev.type != "cuda":
        return {}
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    with open(path.with_suffix(".json")) as f:
        copies = span_ops(json.load(f)["traceEvents"])
    return {"device_busy_ms": sum(e.self_device_time_total for e in ops) /
            1e3 / TRACE_STEPS,
            "device_ops": sum(e.count for e in ops) / TRACE_STEPS,
            "host_launches": sum(e.count for e in events
                                 if e.key in HOST_LAUNCH_CALLS) / TRACE_STEPS,
            "copy_ms": sum(us for us, _ in copies.values()) / 1e3 /
            TRACE_STEPS,
            "copy_ops": [[name[:100], us / 1e3 / TRACE_STEPS,
                          n / TRACE_STEPS]
                         for name, (us, n) in copies.items()]}


def run_tier(name: str, *, device=None, iters: int = 10, trace=None,
             on_stage=binning_ops.no_stage_hook, log_fn=print,
             compiled: bool = True, finish=None) -> dict:
    """Step 0 (eager, with ``on_stage``, ``train_step``'s hook), then for
    ``iters`` > 0 a second step timed alone (on the compiled path the
    capture) and ``iters`` more steps of tier ``name``, through a CompiledStep of its own (``compiled``)
    or the eager step. With ``trace`` (a directory), TRACE_STEPS more
    steps under torch.profiler. ``finish(state, opt)``, if given, gets the
    state after the last step. Returns the record."""
    dev = device_mod.resolve(device)
    n, m, log_scale = TIERS[name]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ts = build_tier_state(n, log_scale, device=dev)
    cur = {"state": ts.state, "opt": ts.opt}
    steps = compiled_mod.CompiledStep() if compiled else None

    def one(hook=None):
        cur["state"], cur["opt"], aux = train_once(
            ts, cur["state"], cur["opt"], m,
            on_stage=hook or binning_ops.no_stage_hook,
            steps=None if hook else steps)
        return aux

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, (time.perf_counter() - t) * 1e3

    before = kernel_launches()
    _sync(dev)
    aux, first_ms = timed(lambda: one(on_stage))
    instances = int(aux.num_instances)
    overflow = bool(aux.instance_overflow)
    second_ms = timed(one)[1] if iters else None
    times = [timed(one)[1] for _ in range(iters)]
    after = kernel_launches()
    rec = {"tier": name, "n": n, "max_instances": m,
           "width": WIDTH, "height": HEIGHT, "device": str(dev),
           "path": "compiled" if compiled else "eager",
           "instances": instances, "overflow": overflow,
           "first_step_ms": first_ms, "second_step_ms": second_ms,
           "captures": [] if steps is None else
           [[list(k), ms] for k, ms in steps.captures],
           "step_ms_median": float(np.median(times)) if times else None,
           "step_ms": times,
           "launches": {k: after[k] - before[k] for k in after}}
    if trace is not None:
        rec.update(_profile(one, dev, Path(trace) / name))
    rec["peak_mib"], rec["peak_reserved_mib"] = (
        (torch.cuda.max_memory_allocated(dev) / 2**20,
         torch.cuda.max_memory_reserved(dev) / 2**20)
        if dev.type == "cuda" else (None, None))
    if finish is not None:
        finish(cur["state"], cur["opt"])
    if steps is not None:
        steps.clear()
    log_fn(f"[{name}] {rec['path']} n={n} M={m} instances={instances} "
           f"overflow={overflow} first={first_ms:.1f}ms "
           f"second={second_ms}ms step={rec['step_ms_median']}ms "
           f"peak={rec['peak_mib']}MiB (reserved {rec['peak_reserved_mib']}"
           f") launches={json.dumps(rec['launches'])} on {dev}")
    return rec


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tiers", nargs="*",
                   help=f"of {list(TIERS)} (default: all, in order)")
    p.add_argument("--iters", type=int, default=10,
                   help="steps timed after step 0")
    p.add_argument("--trace", type=Path, default=None,
                   help="write a torch.profiler trace of each tier here")
    p.add_argument("--eager", action="store_true",
                   help="step through the eager train_step, not the "
                   "compiled one")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--out", type=Path, default=None,
                   help="write the records to this JSON file")
    return p


def main(argv=None) -> list[dict]:
    parser = _parser()
    args = parser.parse_args(argv)
    unknown = [t for t in args.tiers if t not in TIERS]
    if unknown:
        parser.error(f"unknown tiers {unknown}; the tiers are {list(TIERS)}")
    dev = device_mod.resolve(args.device)
    records = []
    for name in args.tiers or list(TIERS):
        try:
            rec = run_tier(name, device=dev, iters=args.iters,
                           trace=args.trace, compiled=not args.eager)
        except torch.OutOfMemoryError as exc:
            rec = {"tier": name, "path": "eager" if args.eager else
                   "compiled",
                   "out_of_memory": str(exc).splitlines()[0]}
            print(f"[{name}] out of device memory: {rec['out_of_memory']}",
                  flush=True)
        records.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    main()
