"""What the per-layer readers share, and how the harness finds them.

A per-layer metric is the file ``metrics/<name>.py`` with ``UNIT`` and
``read(trace)``: the metric's value from a reduced trace
(``trace.Trace``), or None where the trace holds nothing it reads. The
harness runs every reader and leaves a None out of the result.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from gsbench.work import bound_s

SPANS = {"train": "gsbench.train_step", "render": "gsbench.eval_render"}
KERNELS = {"composite_fwd": "composite_fwd_kernel",
           "composite_bwd": "composite_bwd_kernel"}


def load_all(folder: Path) -> dict:
    """{metric name: module} of every reader in ``folder``."""
    out = {}
    for path in sorted(folder.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "gsbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def read_all(folder: Path, tr) -> dict:
    """{metric name: {value, unit}} of every reader in ``folder`` that
    finds something to read in the reduced trace ``tr``."""
    out = {}
    for name, reader in load_all(folder).items():
        value = reader.read(tr)
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def per_step_ms(tr, kind: str, keep) -> float | None:
    """Device ms per call of the ``kind`` loop's span, of the operations
    launched inside it that ``keep(op)``; None without such spans."""
    span = SPANS[kind]
    n = tr.spans.get(span, 0)
    if tr.kind != kind or n == 0:
        return None
    return sum(o.dur for o in tr.ops if o.span == span and keep(o)) / n / 1e3


def roofline_pct(tr, kind: str, kernel: str) -> float | None:
    """The kernel's share of its roofline over the traced calls: the
    least time of its counted work over its device time."""
    ms = per_step_ms(tr, kind, lambda o: KERNELS[kernel] in o.name)
    if not ms or not tr.work:
        return None
    least = sum(bound_s(*k[kernel]) for _, k in tr.work) / len(tr.work)
    return 100.0 * least * 1e3 / ms


def step_mfu(tr, kind: str) -> float | None:
    """The whole step's or frame's share of the chip's peak: the least
    time of its counted work over the traced time per call (the window
    over the calls in it)."""
    n = tr.spans.get(SPANS[kind], 0)
    if tr.kind != kind or n == 0 or not tr.work:
        return None
    least = sum(bound_s(*w) for w, _ in tr.work) / len(tr.work)
    return 100.0 * least / (tr.window_s / n)


def idle_pct(tr, kind: str) -> float | None:
    if tr.kind != kind:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
