"""The compiled step: ``train_step`` and ``eval_render`` captured once per
key and replayed as CUDA graphs.

The counterpart of rain_tpu's compilation (rain_tpu/train/step.py:32-35,
102-104): rain_tpu jits both functions, keyed by their static arguments
and the shapes, with every value that changes from call to call traced as
a device input of the one compiled program. Here the program is a
``torch.cuda.CUDAGraph`` of the unchanged eager step (train.step), and the
per-call values are device inputs of the graph:

- **Key.** ``train_key``: width, height, sh_degree, max_instances,
  lambda_dssim, update_densify_stats, the capacity and whether the step
  is bucketed (``real_wh`` given); ``eval_key``: width, height, sh_degree,
  max_instances and the capacity. The inputs' shapes follow from the key;
  an input of another shape raises ValueError.
- **Capture.** The first call of a key copies its inputs into static
  buffers, runs the eager step on them once on a side stream (the
  warm-up that ``torch.cuda.graphs`` asks for under autograd: lazy set-up
  happens outside the capture), whose outputs are that call's result, and
  then captures the step from the CompiledStep's one memory pool. A
  capture that fails raises; nothing falls back to the eager step.
- **Replay.** A call copies its inputs into the buffers (device to device,
  one multi-tensor copy per dtype; a Python number is a fill), replays
  the graph and copies its outputs into new tensors, so the inputs are
  left untouched and the outputs are the caller's, as with the eager step
  (the Trainer's one-step-late rollback keeps the pre-step state). An
  output that is one of the inputs (the statistics when
  update_densify_stats is False) is the caller's input, as the eager step
  returns it. No call waits for the device.
- **Per-call values.** ``low_pass``, ``xyz_lr``, ``scale_modifier``, the
  four ``opt_cfg_leaves`` (f32), ``real_wh`` and ``state.n_alive`` (int32)
  are 0-d device tensors or numbers, filled into their buffers either way;
  the camera, ground truth, background, state and Adam state are copied.
- **Launch counters.** A replay adds to B1–B4's ``launches`` the
  launches its capture recorded; the capture itself adds none, and the
  warm-up counts as the eager step it is: one count per call and kernel.
- **Memory.** All graphs of one CompiledStep share one memory pool, and
  the graphs whose inputs have the same shapes share their input buffers.
  ``retire`` drops the graphs of keys whose capacity or tier has been
  outgrown, returning their memory to the pool (or, with the last graph,
  releasing the pool).

A state on the CPU runs the eager step, as the kernel wrappers run their
plain versions there; the key is recorded on both paths (``train_keys``,
``eval_keys``). No ``on_stage`` hook: the hooks stay on the eager step.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.train import step as step_mod

# the kernel wrappers whose launch counters a replay adds to: B1–B4
COUNTED = (expand_ops.expand_instances, expand_ops.reduce_instances,
           tile_render.composite_forward, tile_render.composite_backward)
CAMERA = ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy")
OPT_LEAVES = ("feature_lr", "opacity_lr", "scaling_lr", "rotation_lr")


class TrainKey(NamedTuple):
    width: int
    height: int
    sh_degree: int
    max_instances: int
    lambda_dssim: float
    update_densify_stats: bool
    capacity: int
    bucketed: bool


class EvalKey(NamedTuple):
    width: int
    height: int
    sh_degree: int
    max_instances: int
    capacity: int


def train_key(state: gmod.GaussianState, *, width: int, height: int,
              sh_degree: int, max_instances: int, lambda_dssim: float = 0.2,
              update_densify_stats: bool = True,
              real_wh=None) -> TrainKey:
    """The key of a ``train_step`` call: its static keywords, the
    capacity and whether it is bucketed."""
    return TrainKey(int(width), int(height), int(sh_degree),
                    int(max_instances), float(lambda_dssim),
                    bool(update_densify_stats), state.capacity,
                    real_wh is not None)


def eval_key(state: gmod.GaussianState, *, width: int, height: int,
             sh_degree: int, max_instances: int) -> EvalKey:
    """The key of an ``eval_render`` call."""
    return EvalKey(int(width), int(height), int(sh_degree),
                   int(max_instances), state.capacity)


def _spec(value, dtype) -> tuple:
    """(shape, dtype) of an input's static buffer: a number or a 0-d
    tensor takes a 0-d ``dtype`` buffer (``dtype`` None: the tensor's
    own)."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), dtype or value.dtype
    return (), dtype


def _copy(dsts, srcs) -> None:
    """dst.copy_(src) for every pair, one multi-tensor copy per pair of
    dtypes; a Python number is a fill."""
    groups = {}
    for d, s in zip(dsts, srcs):
        if isinstance(s, torch.Tensor):
            groups.setdefault((d.dtype, s.dtype), ([], []))
            groups[d.dtype, s.dtype][0].append(d)
            groups[d.dtype, s.dtype][1].append(s)
        else:
            d.fill_(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _Graph:
    """One key's graph: the static input buffers, the CUDA graph, its
    static outputs and the launches of B1–B4 it holds.

    Built by the key's first call, whose result is the warm-up's: the
    eager step on the buffers, on a side stream, with its launches counted
    as launches. The capture that follows launches nothing and counts
    nothing, so each call counts its kernels once."""

    def __init__(self, fn, inputs, buffers, device, pool):
        self.inputs = buffers
        self.check(inputs, device)
        _copy(self.inputs, inputs)
        here = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            first = fn(self.inputs)
        here.wait_stream(side)
        ids = {id(x): i for i, x in enumerate(self.inputs)}
        for x in first:
            if id(x) not in ids:
                x.record_stream(here)   # made on the side stream, used here
        self.first = (first, [ids.get(id(x)) for x in first])
        before = [k.launches for k in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(self.inputs)
        finally:
            self.launches = [k.launches - n for k, n in zip(COUNTED, before)]
            for k, n in zip(COUNTED, before):
                k.launches = n
        self.alias = [ids.get(id(x)) for x in self.outputs]

    def check(self, inputs, device) -> None:
        for i, (buf, x) in enumerate(zip(self.inputs, inputs)):
            if isinstance(x, torch.Tensor) and (
                    x.shape != buf.shape or x.device != device):
                raise ValueError(
                    f"input {i} of the compiled step is {tuple(x.shape)} on "
                    f"{x.device}; its graph takes {tuple(buf.shape)} on "
                    f"{device}")

    @staticmethod
    def _result(outputs, alias, inputs) -> list:
        """``outputs`` with each that is an input buffer (``alias``: its
        index, or None) replaced by the caller's input."""
        return [x if a is None else inputs[a] for x, a in zip(outputs, alias)]

    def take_first(self, inputs) -> list:
        """The first call's result: the warm-up's outputs."""
        (first, alias), self.first = self.first, None
        return self._result(first, alias, inputs)

    def __call__(self, inputs, device) -> list:
        """A replay on ``inputs``: the outputs as new tensors."""
        self.check(inputs, device)
        _copy(self.inputs, inputs)
        self.graph.replay()
        for k, n in zip(COUNTED, self.launches):
            k.launches += n
        fresh = [x for x, a in zip(self.outputs, self.alias) if a is None]
        outs = [torch.empty_like(x) for x in fresh]
        _copy(outs, fresh)
        it = iter(outs)
        return self._result([next(it) if a is None else None
                             for a in self.alias], self.alias, inputs)


N_PARAMS = len(gmod.GaussianParams._fields)


def _flat(*groups):
    """(values, dtypes) of groups (values, dtype): a dtype is that of the
    group's buffers (None: each tensor's own)."""
    xs, dtypes = [], []
    for values, dtype in groups:
        xs += values
        dtypes += [dtype] * len(values)
    return xs, dtypes


def _taker(values):
    """take(n): the next n of ``values``."""
    it = iter(values)
    return lambda n: [next(it) for _ in range(n)]


def _state(take, with_stats: bool) -> gmod.GaussianState:
    """A GaussianState from the buffers: params, then (with_stats) the
    statistics, then n_alive."""
    params = gmod.GaussianParams(*take(N_PARAMS))
    stats = take(len(gmod.STAT_FIELDS)) if with_stats else \
        [None] * len(gmod.STAT_FIELDS)
    n_alive, = take(1)
    return gmod.GaussianState(params, n_alive, *stats)


class CompiledStep:
    """``train_step`` and ``eval_render`` of train.step, each key captured
    once into a CUDA graph (see the module docstring). One instance holds
    one memory pool for all its graphs: one per Trainer, or per render
    CLI run. ``captures`` lists (key, warm-up and capture ms) in order."""

    def __init__(self):
        self.graphs = {}
        self.train_keys = set()
        self.eval_keys = set()
        self.captures = []
        self._pool = None
        # static input buffers, shared by the graphs whose inputs have the
        # same shapes and dtypes (the keys of one capacity differ in their
        # static arguments only): replays run one at a time, each after
        # its own copy-in
        self._buffers = {}

    def _run(self, key, fn, inputs, dtypes, device) -> list:
        """fn's outputs on ``inputs``: replayed from the key's graph, or,
        at the key's first call, the warm-up's before the capture."""
        g = self.graphs.get(key)
        if g is not None:
            return g(inputs, device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        kind = type(key), tuple(_spec(x, t) for x, t in zip(inputs, dtypes))
        if kind not in self._buffers:
            self._buffers[kind] = [torch.empty(shape, dtype=t, device=device)
                                   for shape, t in kind[1]]
        g = _Graph(fn, inputs, self._buffers[kind], device, self._pool)
        g.kind = kind
        self.graphs[key] = g
        self.captures.append((key, (time.perf_counter() - t0) * 1e3))
        return g.take_first(inputs)

    def retire(self, capacity: int, max_instances: int) -> None:
        """Drop the graphs of keys below ``capacity`` or below the tier
        ``max_instances``: a Trainer's capacity and tier only grow. A pool
        left without a graph is released, and the next capture starts
        another (a pool's handle is not reused once its last graph is
        gone)."""
        for key in [k for k in self.graphs if k.capacity < capacity or
                    k.max_instances < max_instances]:
            del self.graphs[key]
        kinds = {g.kind for g in self.graphs.values()}
        self._buffers = {k: v for k, v in self._buffers.items()
                         if k in kinds}
        if not self.graphs:
            self._pool = None

    def train_step(self, state: gmod.GaussianState, opt: adam_mod.AdamState,
                   camera: dict, gt_image: torch.Tensor, bg: torch.Tensor,
                   low_pass, xyz_lr, *, width: int, height: int,
                   sh_degree: int, max_instances: int, opt_cfg_leaves: dict,
                   lambda_dssim: float = 0.2,
                   update_densify_stats: bool = True, real_wh=None):
        """``step.train_step`` (same arguments but ``on_stage``, same
        results), replayed from the key's graph on the card."""
        key = train_key(state, width=width, height=height,
                        sh_degree=sh_degree, max_instances=max_instances,
                        lambda_dssim=lambda_dssim,
                        update_densify_stats=update_densify_stats,
                        real_wh=real_wh)
        self.train_keys.add(key)
        kw = dict(width=key.width, height=key.height,
                  sh_degree=key.sh_degree, max_instances=key.max_instances,
                  lambda_dssim=key.lambda_dssim,
                  update_densify_stats=key.update_densify_stats)
        dev = _device(state)
        if dev.type == "cpu":
            return step_mod.train_step(
                state, opt, camera, gt_image, bg, low_pass, xyz_lr,
                opt_cfg_leaves=opt_cfg_leaves, real_wh=real_wh, **kw)

        f32, i32 = torch.float32, torch.int32
        wh = list(real_wh or ())
        xs, dtypes = _flat(
            (list(state.params), None),
            ([getattr(state, k) for k in gmod.STAT_FIELDS], None),
            ([state.n_alive], i32),
            (list(opt.mu) + list(opt.nu) + [opt.step], None),
            ([camera[k] for k in CAMERA] + [gt_image, bg], None),
            ([low_pass, xyz_lr] + [opt_cfg_leaves[k] for k in OPT_LEAVES],
             f32),
            (wh, i32))

        def run(b):
            take = _taker(b)
            st = _state(take, with_stats=True)
            params = gmod.GaussianParams(*take(N_PARAMS))
            op = adam_mod.AdamState(
                params, gmod.GaussianParams(*take(N_PARAMS)), *take(1))
            cam = dict(zip(CAMERA, take(len(CAMERA))))
            gt, bgv, lp, lr = take(4)
            leaves = dict(zip(OPT_LEAVES, take(len(OPT_LEAVES))))
            s2, o2, aux = step_mod.train_step(
                st, op, cam, gt, bgv, lp, lr, opt_cfg_leaves=leaves,
                real_wh=tuple(take(len(wh))) or None, **kw)
            return (list(s2.params) +
                    [getattr(s2, k) for k in gmod.STAT_FIELDS] +
                    list(o2.mu) + list(o2.nu) + [o2.step] +
                    [aux.loss, aux.l1, aux.num_instances,
                     aux.instance_overflow])

        take = _taker(self._run(key, run, xs, dtypes, dev))
        params = gmod.GaussianParams(*take(N_PARAMS))
        new_state = gmod.GaussianState(params, state.n_alive,
                                       *take(len(gmod.STAT_FIELDS)))
        mu = gmod.GaussianParams(*take(N_PARAMS))
        new_opt = adam_mod.AdamState(
            mu, gmod.GaussianParams(*take(N_PARAMS)), *take(1))
        loss, l1, n_inst, overflow = take(4)
        return new_state, new_opt, step_mod.StepAux(
            loss=loss, l1=l1, num_instances=n_inst,
            instance_overflow=overflow, n_alive=state.n_alive)

    def eval_render(self, state: gmod.GaussianState, camera: dict,
                    bg: torch.Tensor, low_pass, scale_modifier=1.0, *,
                    width: int, height: int, sh_degree: int,
                    max_instances: int) -> render_ops.RenderOutput:
        """``step.eval_render`` (same arguments but ``on_stage``, same
        results), replayed from the key's graph on the card."""
        key = eval_key(state, width=width, height=height,
                       sh_degree=sh_degree, max_instances=max_instances)
        self.eval_keys.add(key)
        kw = dict(width=key.width, height=key.height,
                  sh_degree=key.sh_degree, max_instances=key.max_instances)
        dev = _device(state)
        if dev.type == "cpu":
            return step_mod.eval_render(state, camera, bg, low_pass,
                                        scale_modifier, **kw)

        xs, dtypes = _flat(
            (list(state.params), None), ([state.n_alive], torch.int32),
            ([camera[k] for k in CAMERA] + [bg], None),
            ([low_pass, scale_modifier], torch.float32))

        def run(b):
            take = _taker(b)
            st = _state(take, with_stats=False)
            cam = dict(zip(CAMERA, take(len(CAMERA))))
            bgv, lp, sm = take(3)
            return list(step_mod.eval_render(st, cam, bgv, lp, sm, **kw))

        return render_ops.RenderOutput(*self._run(key, run, xs, dtypes, dev))


def _device(state: gmod.GaussianState) -> torch.device:
    dev = state.params.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no compiled step for device {dev}")
    return dev
