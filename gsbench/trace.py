"""The traced window: torch.profiler's record of the device and the host,
reduced to what the per-layer readers read.

Every device operation (kernel, copy, fill) is kept with the CUDA runtime
call that launched it: a ``cudaGraphLaunch`` for an operation of a
replayed graph, a kernel launch, copy or fill otherwise. Each is placed
in the harness's span (``gsbench.*``, recorded around its calls into the
program) that was open on the host when it was launched. The busy time
is the union of the device operations' intervals inside the window; an
idle gap is a stretch of the window with none, labelled by what the
host was doing when it began (the innermost host operation or span open
then).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

import torch

WINDOW = "gsbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GRAPH_LAUNCH = "cudaGraphLaunch"


class Op(NamedTuple):
    name: str
    start: float              # us
    dur: float                # us
    graph: bool               # launched by a graph replay
    span: str | None          # the harness span open at its launch


class Trace(NamedTuple):
    kind: str                 # the loop's kind: "train" or "render"
    ops: list                 # [Op]
    spans: dict               # harness span name -> count in the window
    window_s: float
    busy_s: float
    gaps: list                # [(host label, seconds)], longest first
    work: list                # per traced step: (Work, {kernel: Work})


def record(run) -> dict:
    """Profile ``run()`` inside the window span, with a synchronise at its
    end; returns the Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            run()
            if card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _innermost(intervals, t):
    """The shortest (start, end, name) interval holding time t."""
    best = None
    for s, e, name in intervals:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "none"


def reduce(events: list, kind: str, work: list) -> Trace:
    launches = {}
    host = []
    window = None
    for e in events:
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver"):
            launches[e["args"].get("correlation")] = (e["name"], e["ts"])
        elif cat in ("user_annotation", "cpu_op") and "dur" in e:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if e["name"] == WINDOW and cat == "user_annotation":
                window = (e["ts"], e["ts"] + e["dur"])
    if window is None:
        raise RuntimeError("the trace holds no window span")
    spans = sorted((s, e, n) for s, e, n in host if n.startswith("gsbench.")
                   and n != WINDOW)
    counted = {}
    for _, _, n in spans:
        counted[n] = counted.get(n, 0) + 1
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        name, t = launches.get(e["args"].get("correlation"), ("", None))
        span = None
        if t is not None:
            for s, end, n in spans:
                if s <= t <= end:
                    span = n
                    break
        ops.append(Op(e["name"], e["ts"], e["dur"], name == GRAPH_LAUNCH,
                      span))
    ops.sort(key=lambda o: o.start)
    busy, gaps = 0.0, []
    cursor = window[0]
    for o in ops:
        s, e = max(o.start, window[0]), min(o.start + o.dur, window[1])
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s - cursor))
        busy += e - max(s, cursor)
        cursor = e
    if window[1] > cursor:
        gaps.append((cursor, window[1] - cursor))
    gaps.sort(key=lambda g: -g[1])
    labelled = [(_innermost(host, t), d / 1e6) for t, d in gaps[:10]]
    return Trace(kind, ops, counted, (window[1] - window[0]) / 1e6,
                 busy / 1e6, labelled, work)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time and the longest idle
    gaps, at most 10 each, in seconds."""
    by = {}
    for o in tr.ops:
        by[o.name] = by.get(o.name, 0.0) + o.dur / 1e6
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n[:200], s] for n, s in tr.gaps]}
