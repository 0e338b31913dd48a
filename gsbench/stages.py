"""Stage intervals inside the program's replayed graphs.

The program marks the stages of each captured step on the device: after
each stage its graph holds a one-thread kernel named ``rain_mark_<stage>``
(and ``rain_mark_begin`` first), so a traced replay shows every stage
boundary by name. Within each traced call of a loop (the graph's
operations in the harness's span, between the copies in and out), a
stage's time is the start of its mark minus the end of the mark before
it: device time, with the gaps between the graph's nodes. A reader names
the marks that bound its intervals; a call counts only where each of them
is present once and in that order, as the profiler has dropped tiny
kernels' records before. The marks are known by name alone: nothing of
the program is imported.
"""

from __future__ import annotations

import re

from gsbench import readers

MARK = re.compile(r"rain_mark_(\w+)")

# the marks that bound each metric's intervals, in order
PREPROCESS = ("begin", "preprocess")
BINNING = ("preprocess", "depth_sort", "expand_B1", "tile_sort_gather",
           "tile_ranges")
LOSS = ("assemble", "loss", "loss_bwd")
PREPROCESS_BWD = ("reduce_B2", "grads")
ADAM = ("densify_stats", "adam")


def calls(tr, kind: str) -> list[list]:
    """The replayed graph's operations of each traced call of the
    ``kind`` loop, in order: each run of graph operations inside the
    loop's span, ended by an operation of the span that no replay
    launched (the copies in and out)."""
    span = readers.SPANS[kind]
    out, cur = [], []
    for o in tr.ops:
        if o.span != span:
            continue
        if o.graph:
            cur.append(o)
        elif cur:
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def marks(call: list) -> list[tuple]:
    """[(stage, op)] of the marks among a call's operations, in order."""
    out = []
    for o in call:
        m = MARK.search(o.name)
        if m:
            out.append((m.group(1), o))
    return out


def interval_ms(tr, kind: str, bounds: tuple) -> float | None:
    """Device ms per call of the intervals between consecutive marks of
    ``bounds`` (each named by its later mark), summed, over the traced
    calls of the ``kind`` loop that hold every one of ``bounds`` once and
    in order; None where no call does (or the trace is of another loop)."""
    if tr.kind != kind:
        return None
    got = []
    for call in calls(tr, kind):
        found = marks(call)
        names = [n for n, _ in found]
        if any(names.count(b) != 1 for b in bounds):
            continue
        at = [names.index(b) for b in bounds]
        if at != sorted(at):
            continue
        ops = [found[i][1] for i in at]
        got.append(sum(b.start - (a.start + a.dur)
                       for a, b in zip(ops, ops[1:])) / 1e3)
    return sum(got) / len(got) if got else None
