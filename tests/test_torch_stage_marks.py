"""The stage marks and host spans of the compiled step, on the CPU.

The marks themselves are kernels (csrc/marks.cu) and run only on the
card (tests/test_torch_cuda.py). Here: the stages the eager step and
frame report, in order, with the loss's backward in place; the mark
kernels' list against the Python stages; the intervals' names; the
compiled step's host spans under a CPU profiler and without one; the
Trainer's report of a step's stages; probe_scale's copies told by span.
No JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_round_cases as rounds
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.scripts import probe_scale
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import marks
from rain_tpu_torch.train import step as step_mod
from test_torch_trainer_port import configs, make_scene, trainer

torch.set_num_threads(1)

W, H, M, N, CAPACITY = 48, 32, 4096, 200, 256
OPT = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
       "rotation_lr": 0.001}
MARKS_CU = Path(marks.__file__).parents[1] / "csrc" / "marks.cu"


def _state(seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          rng.uniform(2.0, 6.0, (N, 1))], 1)
    return gmod.from_arrays(
        xyz, rng.normal(0, 0.5, (N, 1, 3)), rng.normal(0, 0.1, (N, 15, 3)),
        rng.uniform(-3.5, -2.0, (N, 3)), rng.normal(size=(N, 4)),
        rng.normal(0, 1.5, (N, 1)), capacity=CAPACITY, device="cpu")


def _camera():
    return Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                  fovx=0.8, fovy=0.6, image=None, width=W,
                  height=H).render_inputs("cpu")


def _gt():
    return torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, H, W)).astype(np.float32))


def _train(steps=None, **kw):
    state = _state()
    call = step_mod.train_step if steps is None else steps.train_step
    return call(state, adam_mod.init(state.params), _camera(), _gt(),
                torch.zeros(3), 0.3, 1.6e-4, width=W, height=H,
                sh_degree=3, max_instances=M, opt_cfg_leaves=OPT, **kw)


def _render(steps=None, **kw):
    call = step_mod.eval_render if steps is None else steps.eval_render
    return call(_state(), _camera(), torch.zeros(3), 0.3, width=W, height=H,
                sh_degree=3, max_instances=M, **kw)


# -- the stages the eager step reports ---------------------------------------
def test_the_backward_opens_with_the_loss_backward():
    assert render_ops.BACKWARD_STAGES == ("loss_bwd", "composite_bwd_B4",
                                          "reduce_B2")


@pytest.mark.parametrize("update_densify_stats", [True, False])
def test_train_step_reports_its_stages_in_order(update_densify_stats):
    seen = []
    _train(on_stage=lambda *kv: seen.append(kv),
           update_densify_stats=update_densify_stats)
    after = step_mod.TRAIN_STAGES[1:] if update_densify_stats else \
        ("grads", "adam")
    assert tuple(k for k, _ in seen) == render_ops.STAGES + ("loss",) + \
        render_ops.BACKWARD_STAGES + after
    stages = dict(seen)
    # the loss's backward reports the tiles' cotangent, B4's input
    g = stages["loss_bwd"]
    assert g.shape == stages["composite_B3"].shape
    assert torch.equal(g.contiguous(), stages["composite_bwd_B4"][0][-1])
    assert bool(g.abs().sum() > 0)


def test_eval_render_reports_its_stages_in_order():
    seen = []
    _render(on_stage=lambda *kv: seen.append(kv[0]))
    assert tuple(seen) == render_ops.STAGES


# -- the mark kernels --------------------------------------------------------
def _marks_cu_list():
    text = MARKS_CU.read_text()
    block = re.search(r"#define RAIN_MARKS\(X\)(.*?)\n\n", text, re.S)
    return tuple(re.findall(r"X\((\w+)\)", block.group(1)))


def test_marks_cu_lists_the_python_stages():
    assert _marks_cu_list() == marks.STAGES


def test_every_reported_stage_has_a_mark():
    graphs = (("begin",) + render_ops.STAGES + ("loss",) +
              render_ops.BACKWARD_STAGES + step_mod.TRAIN_STAGES[1:] +
              ("round", "reset"))
    assert set(graphs) == set(marks.STAGES)
    assert len(set(marks.STAGES)) == len(marks.STAGES)
    assert marks.STAGES[0] == "begin"
    # a training graph's marks fit its buffer
    assert 1 + len(render_ops.STAGES) + 1 + len(
        render_ops.BACKWARD_STAGES) + 3 <= marks.SLOTS


def test_intervals_are_named_by_the_mark_that_ends_them():
    names = ["begin", "preprocess", "depth_sort", "preprocess"]
    ns = [1_000_000, 3_500_000, 4_000_000, 10_000_000]
    assert marks.intervals(names, ns) == {"preprocess": 2.5 + 6.0,
                                          "depth_sort": 0.5}
    assert list(marks.intervals(names[:3], ns)) == ["preprocess",
                                                    "depth_sort"]
    assert marks.intervals(["begin"], [5]) == {}


def test_stage_ms_is_empty_without_a_replayed_graph():
    steps = compiled.CompiledStep()
    _train(steps)
    key, = steps.train_keys
    assert steps.stage_ms(key) == {} and steps.stage_ms(None) == {}
    assert steps.last_step_key is None      # the CPU path captures none


# -- the host spans ----------------------------------------------------------
def _round(steps):
    st, opt = rounds.seeded(_state(), N, seed=0)
    return steps.densify_and_prune(st, opt, rounds.noise(CAPACITY, "cpu",
                                                         seed=1),
                                   **rounds.scalars(0, "cpu", extent=5.0))


def _reset(steps):
    st, opt = rounds.seeded(_state(), N, seed=0)
    return steps.reset_opacity(st, opt)


CALLS = {"train_step": _train, "eval_render": _render,
         "densify_and_prune": _round, "reset_opacity": _reset}


@pytest.mark.parametrize("method", sorted(CALLS))
def test_a_profiled_call_records_its_span(method):
    from torch.profiler import ProfilerActivity, profile
    steps = compiled.CompiledStep()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CALLS[method](steps)
    names = [e.name for e in prof.events()]
    assert names.count(compiled.SPAN + method) == 1
    # the CPU path copies, replays and captures nothing
    assert not [n for n in names if n.startswith(compiled.SPAN) and
                n != compiled.SPAN + method]


@pytest.mark.parametrize("method", sorted(CALLS))
def test_a_call_without_a_profiler_opens_no_span(method, monkeypatch):
    opened = []
    real = compiled.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(compiled, "record_function", counting)
    steps = compiled.CompiledStep()
    CALLS[method](steps)
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        CALLS[method](steps)
    assert opened == [compiled.SPAN + method]


def test_spans_inside_a_call_follow_its_check(monkeypatch):
    """The inner spans open only in a traced call: ``_span`` reads the
    check its call made."""
    steps = compiled.CompiledStep()
    assert steps._span("copy_in") is compiled._NO_SPAN
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled",
                        lambda: True)
    seen = []
    monkeypatch.setattr(step_mod, "eval_render",
                        lambda *a, **k: seen.append(steps._span("replay")))
    steps.eval_render(_state(), _camera(), torch.zeros(3), 0.3, width=W,
                      height=H, sh_degree=3, max_instances=M)
    assert isinstance(seen[0], torch.profiler.record_function)


# -- the Trainer's report ----------------------------------------------------
class _Writer:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = (value, step)

    def add_histogram(self, *a):
        pass

    def add_images(self, *a):
        pass


@pytest.mark.parametrize("split", [{}, {"preprocess": 1.25, "adam": 0.5}])
def test_the_report_logs_the_last_steps_stages(split, tmp_path,
                                               monkeypatch):
    logs = []
    tr = trainer(make_scene(n_cams=3, n_pts=60, size=32),
                 configs({}, dict(capacity=128, max_instances=4096)),
                 tmp_path, tensorboard=False)
    tr.log = logs.append
    tr.tb = _Writer()
    asked = []

    def stage_ms(key):
        asked.append(key)
        return split

    monkeypatch.setattr(tr._steps, "stage_ms", stage_ms)
    tr._steps.last_step_key = "key"
    tr.report(7)
    assert asked == ["key"]
    lines = [x for x in logs if "stage ms" in x]
    if not split:
        assert lines == [] and not any(t.startswith("stage_ms/")
                                       for t in tr.tb.scalars)
        return
    assert lines == ["[ITER 7] stage ms of the last step: preprocess 1.250 "
                     "adam 0.500"]
    assert tr.tb.scalars["stage_ms/preprocess"] == (1.25, 7)
    assert tr.tb.scalars["stage_ms/adam"] == (0.5, 7)


# -- probe_scale's copies ----------------------------------------------------
def test_probe_scale_counts_the_operations_launched_in_the_copy_spans():
    def span(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur}

    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "args": {"correlation": corr}}

    def op(corr, name, dur, cat="kernel"):
        return {"cat": cat, "name": name, "ts": 1000 + corr, "dur": dur,
                "args": {"correlation": corr}}

    events = [
        span("rain.compiled.train_step", 0, 100),
        span("rain.compiled.copy_in", 10, 10),
        span("rain.compiled.replay", 20, 5),
        span("rain.compiled.copy_out", 30, 10),
        launch(1, 12), launch(2, 15), launch(3, 22), launch(4, 31),
        launch(5, 50),
        op(1, "multi_tensor_apply_kernel", 4.0),
        op(2, "Memset (Device)", 1.5, "gpu_memset"),
        op(3, "direct_copy_kernel", 7.0),     # the step's own copy
        op(4, "multi_tensor_apply_kernel", 2.0),
        op(5, "vectorized_elementwise_kernel", 3.0)]
    assert probe_scale.span_ops(events) == {
        "multi_tensor_apply_kernel": (6.0, 2),
        "Memset (Device)": (1.5, 1)}
    assert not hasattr(probe_scale, "_is_copy")
