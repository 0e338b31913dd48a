"""The stage readers (gsbench/stages.py and metrics/stage.*) on synthetic
traces: each traced call a copy in, the graph's operations with a mark
after each stage, and a copy out."""

import pytest

from gsbench import readers, stages
from gsbench.tests.conftest import GSBENCH
from gsbench.trace import Op, Trace

RENDER = ("begin", "preprocess", "depth_sort", "expand_B1",
          "tile_sort_gather", "tile_ranges", "composite_B3", "assemble")
TRAIN = RENDER + ("loss", "loss_bwd", "composite_bwd_B4", "reduce_B2",
                  "grads", "densify_stats", "adam")
SPAN = {"train": "gsbench.train_step", "render": "gsbench.eval_render"}
MARK_US, GAP_US = 2.0, 1.0
# metric -> (loop kind, the stages whose intervals it sums)
METRICS = {
    "stage.preprocess_ms.train": ("train", ("preprocess",)),
    "stage.binning_ms.train": ("train", ("depth_sort", "expand_B1",
                                         "tile_sort_gather", "tile_ranges")),
    "stage.loss_ms.train": ("train", ("loss", "loss_bwd")),
    "stage.preprocess_bwd_ms.train": ("train", ("grads",)),
    "stage.adam_ms.train": ("train", ("adam",)),
    "stage.preprocess_ms.render": ("render", ("preprocess",)),
    "stage.binning_ms.render": ("render", ("depth_sort", "expand_B1",
                                           "tile_sort_gather",
                                           "tile_ranges")),
}
READERS = readers.load_all(GSBENCH / "metrics")


def _work_us(k: int) -> dict:
    """Each stage's work in call k, us: all differ."""
    return {s: 100.0 * (i + 1) + 7.0 * k for i, s in enumerate(TRAIN)}


def _call(t0, kind, work, drop=(), extra=(), suffix=""):
    """One traced call from t0: its ops and its end. Each stage's work,
    a gap, then its mark (left out for the stages in ``drop``; a second
    mark of each stage in ``extra``)."""
    span = SPAN[kind]
    ops = [Op("multi_tensor_apply_kernel", t0, 50.0, False, span)]
    t = t0 + 60.0
    for i, s in enumerate(RENDER if kind == "render" else TRAIN):
        if i:
            ops.append(Op(f"elementwise_kernel_{s}", t, work[s], True, span))
            t += work[s] + GAP_US
        for _ in range(1 + (s in extra)):
            if s not in drop:
                ops.append(Op(f"rain_mark_{s}{suffix}", t, MARK_US, True,
                              span))
            t += MARK_US
    ops.append(Op("vectorized_elementwise_kernel", t + 5.0, 40.0, False,
                  span))
    return ops, t + 100.0


def _trace(kind, calls):
    """A trace of ``calls``: per call (drop, extra)."""
    ops, t = [], 0.0
    for k, (drop, extra) in enumerate(calls):
        got, t = _call(t, kind, _work_us(k), drop, extra,
                       suffix="(unsigned long*)" if k % 2 else "")
        ops += got
    return Trace(kind, ops, {SPAN[kind]: len(calls)}, t / 1e6, t / 2e6, [],
                 [])


def _want_ms(metric, ks):
    """The metric's mean over calls ``ks``: each stage's work and gap."""
    _, names = METRICS[metric]
    return sum(sum(_work_us(k)[s] + GAP_US for s in names)
               for k in ks) / len(ks) / 1e3


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_intervals_are_named_by_their_end_mark(metric):
    kind, _ = METRICS[metric]
    tr = _trace(kind, [((), ())] * 4)
    assert len(stages.calls(tr, kind)) == 4
    assert READERS[metric].UNIT == "ms"
    assert READERS[metric].read(tr) == pytest.approx(
        _want_ms(metric, range(4)), rel=1e-12)


def test_every_stage_reader_is_in_the_benchmark():
    import json
    entries = {m["name"]: m for m in json.loads(
        (GSBENCH.parent / "BENCHMARK.json").read_text())["per_layer"]}
    for metric, (kind, _) in METRICS.items():
        e = entries[metric]
        assert (e["source"], e["better"], e["unit"]) == \
            ("device_trace", "lower", "ms")
        assert all(w.endswith("." + kind) for w in e["workloads"])


@pytest.mark.parametrize("metric,drop", [
    ("stage.binning_ms.train", "expand_B1"),
    ("stage.binning_ms.train", "preprocess"),
    ("stage.loss_ms.train", "loss_bwd"),
    ("stage.adam_ms.train", "densify_stats"),
    ("stage.preprocess_ms.render", "begin")])
def test_a_call_missing_a_mark_is_left_out(metric, drop):
    kind, _ = METRICS[metric]
    tr = _trace(kind, [((), ()), ((drop,), ()), ((), ())])
    assert READERS[metric].read(tr) == pytest.approx(
        _want_ms(metric, [0, 2]), rel=1e-12)


def test_a_call_with_a_mark_twice_is_left_out():
    tr = _trace("train", [((), ("grads",)), ((), ())])
    assert READERS["stage.preprocess_bwd_ms.train"].read(tr) == \
        pytest.approx(_want_ms("stage.preprocess_bwd_ms.train", [1]),
                      rel=1e-12)
    # the other intervals of that call still count
    assert READERS["stage.adam_ms.train"].read(tr) is not None


def test_marks_out_of_order_are_left_out():
    ops, t = _call(0.0, "train", _work_us(0))
    swapped = [o._replace(name="rain_mark_densify_stats")
               if o.name == "rain_mark_adam" else
               o._replace(name="rain_mark_adam")
               if o.name == "rain_mark_densify_stats" else o for o in ops]
    tr = Trace("train", swapped, {SPAN["train"]: 1}, t / 1e6, t / 2e6, [],
               [])
    assert READERS["stage.adam_ms.train"].read(tr) is None
    assert READERS["stage.preprocess_ms.train"].read(tr) is not None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_none_when_no_call_is_complete(metric):
    kind, names = METRICS[metric]
    tr = _trace(kind, [((names[-1],), ())] * 3)
    assert READERS[metric].read(tr) is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_none_for_the_other_loop_kind(metric):
    kind, _ = METRICS[metric]
    other = "render" if kind == "train" else "train"
    assert READERS[metric].read(_trace(other, [((), ())] * 2)) is None


def test_none_without_marks():
    """A program whose graphs carry no marks gives every stage reader
    nothing to read: the result line leaves the stage metrics out."""
    for kind in ("train", "render"):
        ops, t = _call(0.0, kind, _work_us(0))
        tr = Trace(kind, [o for o in ops if "rain_mark_" not in o.name],
                   {SPAN[kind]: 1}, t / 1e6, t / 2e6, [], [])
        assert all(READERS[m].read(tr) is None for m in METRICS)


def test_operations_outside_the_loop_span_are_not_a_call():
    ops, t = _call(0.0, "train", _work_us(0))
    stray = [o._replace(span=None, start=o.start + t) for o in ops]
    tr = Trace("train", ops + stray, {SPAN["train"]: 1}, 2 * t / 1e6,
               t / 1e6, [], [])
    assert len(stages.calls(tr, "train")) == 1
