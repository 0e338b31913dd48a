"""The compiled step: ``train_step``, ``eval_render``, the sharded step,
the densify round and the opacity reset captured once per key and
replayed as CUDA graphs.

The counterpart of rain_tpu's compilation (rain_tpu/train/step.py:32-35,
102-104, rain_tpu/parallel/sharding.py:271-290,
rain_tpu/model/densify.py:73,144-147): rain_tpu jits all five, keyed by
their static arguments and the shapes, with every value that changes from
call to call traced as a device input of the one compiled program. Here
the program is a ``torch.cuda.CUDAGraph`` of the unchanged eager function
(train.step, parallel.sharding, model.densify's fixed-shape
``densify_round`` and ``reset_logits``), and the per-call values are
device inputs of the graph:

- **Key.** ``train_key``: width, height, sh_degree, max_instances,
  lambda_dssim, update_densify_stats, the capacity and whether the step
  is bucketed (``real_wh`` given), a ``TrainKey``; a step with the depth
  term (``depth`` given) keys by the same fields in a ``DepthTrainKey``,
  so its graph is its own and every other key is as it was;
  ``eval_key``: width, height, sh_degree, max_instances and the
  capacity; ``sharded_key``: width, height,
  sh_degree, the tier per shard, lambda_dssim, update_densify_stats, the
  world size, the rank and the shard's capacity (the sharded step of each
  key is made once, as rain_tpu/train/trainer.py:272-283 caches it);
  ``DensifyKey``: the capacity, n_split, abe_split and
  use_size_threshold (rain_tpu's static arguments); ``ResetKey``: the
  capacity and the shards the whole state is split into. The inputs'
  shapes follow from the key; an input of another shape raises
  ValueError.
- **Capture.** The first call of a key copies its inputs into static
  buffers, runs the eager step on them once on a side stream (the
  warm-up that ``torch.cuda.graphs`` asks for under autograd: lazy set-up
  happens outside the capture), whose outputs are that call's result, and
  then captures the step from the CompiledStep's one memory pool. A
  capture that fails raises; nothing falls back to the eager step. In a
  process of an NCCL group the capture runs in "thread_local" mode
  (``capture_mode``), else in torch's default "global" one. Python's
  cyclic collector is off while a graph is captured: a collection there
  could destroy another, unreachable graph (a dropped Trainer's), and a
  "global" capture does not permit that call: the capture would fail.
- **Replay.** A call copies its inputs into the buffers (device to device,
  one multi-tensor copy per dtype; a Python number is a fill), replays
  the graph and copies its outputs into new tensors, so the inputs are
  left untouched and the outputs are the caller's, as with the eager step
  (the Trainer's one-step-late rollback keeps the pre-step state). An
  output that is one of the inputs (the statistics when
  update_densify_stats is False) is the caller's input, as the eager step
  returns it. No call waits for the device.
- **Per-call values.** ``low_pass``, ``xyz_lr``, ``scale_modifier``, the
  four ``opt_cfg_leaves``, the round's six thresholds, the depth term's
  weight (f32), ``real_wh`` and ``state.n_alive`` (int32) are 0-d device
  tensors or numbers, filled into their buffers either way; the camera,
  ground truth, background, state, Adam state, the depth term's target
  and mask and split noise are copied. The reset copies in the
  opacity alone, the one leaf it reads.
- **The round's one read.** ``densify_and_prune`` returns what
  model.densify's does: it reads the round's packed info once (the
  round's only wait for the device, as rain_tpu's Trainer reads
  ``info.overflow`` once) and gives the new state a Python n_alive.
- **Launch counters.** A replay adds to the launch counters of B1–B4,
  of preprocess's two kernels, of the SSIM map's two, of B4's depth
  variant and of Adam's (``COUNTED``) the launches its capture
  recorded; the capture itself adds none, and the warm-up counts as the
  eager step it is: one count per call and kernel.
- **Memory.** All graphs of one CompiledStep share one memory pool, and
  the graphs whose inputs have the same shapes share their input buffers.
  ``retire`` drops the graphs of keys whose capacity, or tier where the
  key has one, has been outgrown, returning their memory to the pool (or,
  with the last graph, releasing the pool).

Which path runs: a state on the CPU runs the eager step, as the kernel
wrappers run their plain versions there. The round and the reset hold
no collective: a state on the card captures them whatever the group. The sharded step is captured on
a group whose backend is NCCL, with the state on the card: its
collectives (the gathers, the rank-ordered reduce-scatter of the gathers'
backward, the all-reduces) are captured with the rest. Every rank
captures, and then replays, its graph of a key at the same call: the
ranks' keys differ in the rank alone, and the flags that decide a
rollback are all-reduced. The warm-up's collectives make NCCL's
communicator before any capture. On a gloo group it runs the eager step:
gloo's collectives are host calls, which a graph cannot hold. The rule is
the group's backend, not a fallback: a capture that fails on NCCL raises.
The key is recorded on every path (``train_keys``, ``eval_keys``,
``sharded_train_keys``, ``densify_keys``, ``reset_keys``). ``clear`` drops
every graph, which an NCCL group's communicator must outlive.

- **Stage marks.** A capture passes the eager function a marking
  ``on_stage`` hook (train.marks): each stage it reports (ops.render's,
  the loss's and the step's; the round's and the reset's graphs end with
  "round" and "reset") launches a one-thread kernel, ``rain_mark_<stage>``,
  that writes the device clock into the graph's slot for it, after a
  "begin" mark that opens every graph. So every replay stamps its
  stages, and a profiler's record names them. ``stage_ms(key)`` reads
  the key's last replay as {stage: ms} (one copy to the host, which
  waits); ``last_step_key`` is the key of the last training step. The
  warm-up and the CPU path run the eager function with no hook.
- **Host spans.** While a profiler is on, each call opens the range
  ``rain.compiled.<method>`` and inside it ``rain.compiled.copy_in``,
  ``.replay``, ``.copy_out``, ``.capture`` (a key's warm-up and capture)
  and ``.round_read`` (the round's one read); with none on, a call costs
  one check.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import preprocess as prep_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.parallel import distributed
from rain_tpu_torch.parallel import sharding
from rain_tpu_torch.train import marks as marks_mod
from rain_tpu_torch.train import step as step_mod

# the launch counters a replay adds to, (wrapper, attribute): B1–B4's,
# preprocess's forward and backward, the SSIM map's forward and backward,
# B4's depth variant's (also counted in B4's), Adam's
COUNTED = tuple((f, "launches") for f in (
    expand_ops.expand_instances, expand_ops.reduce_instances,
    tile_render.composite_forward, tile_render.composite_backward,
    prep_ops.preprocess_forward, prep_ops.preprocess_backward)) + (
    (loss_ops.ssim_map, "launches_fwd"), (loss_ops.ssim_map, "launches_bwd"),
    (tile_render.composite_backward, "launches_depth"),
    (adam_mod.update, "launches"))
CAMERA = ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy")
OPT_LEAVES = ("feature_lr", "opacity_lr", "scaling_lr", "rotation_lr")
# the densify round's per-call thresholds, f32
ROUND_SCALARS = ("max_grad", "min_opacity", "extent", "percent_dense",
                 "divide_ratio", "size_threshold")
# the host spans' prefix (rain.compiled.<method>, .copy_in, ...)
SPAN = "rain.compiled."
_NO_SPAN = contextlib.nullcontext()


def launch_counts() -> list[int]:
    """The counters of ``COUNTED``, in its order."""
    return [getattr(f, attr) for f, attr in COUNTED]


class TrainKey(NamedTuple):
    width: int
    height: int
    sh_degree: int
    max_instances: int
    lambda_dssim: float
    update_densify_stats: bool
    capacity: int
    bucketed: bool


class DepthTrainKey(TrainKey):
    """The key of a ``train_step`` with the depth term: TrainKey's fields
    in a type of their own, which equals and hashes apart from the
    TrainKey of the same fields (tuples would compare equal)."""
    __slots__ = ()

    def __eq__(self, other):
        return type(other) is DepthTrainKey and tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((DepthTrainKey, tuple(self)))


class EvalKey(NamedTuple):
    width: int
    height: int
    sh_degree: int
    max_instances: int
    capacity: int


class ShardedKey(NamedTuple):
    width: int
    height: int
    sh_degree: int
    max_instances: int       # per band: max_instances_per_shard
    lambda_dssim: float
    update_densify_stats: bool
    world: int
    rank: int
    capacity: int            # the shard's


class DensifyKey(NamedTuple):
    capacity: int
    n_split: int
    abe_split: bool
    use_size_threshold: bool


class ResetKey(NamedTuple):
    capacity: int            # the state's: a shard's in a sharded run
    world: int               # the shards of the whole state


def train_key(state: gmod.GaussianState, *, width: int, height: int,
              sh_degree: int, max_instances: int, lambda_dssim: float = 0.2,
              update_densify_stats: bool = True,
              real_wh=None, depth: bool = False):
    """The key of a ``train_step`` call: its static keywords, the
    capacity and whether it is bucketed; a DepthTrainKey with ``depth``
    (a DepthTarget given), else a TrainKey."""
    key = TrainKey(int(width), int(height), int(sh_degree),
                   int(max_instances), float(lambda_dssim),
                   bool(update_densify_stats), state.capacity,
                   real_wh is not None)
    return DepthTrainKey(*key) if depth else key


def eval_key(state: gmod.GaussianState, *, width: int, height: int,
             sh_degree: int, max_instances: int) -> EvalKey:
    """The key of an ``eval_render`` call."""
    return EvalKey(int(width), int(height), int(sh_degree),
                   int(max_instances), state.capacity)


def sharded_key(state: gmod.GaussianState, *, width: int, height: int,
                sh_degree: int, max_instances_per_shard: int,
                lambda_dssim: float = 0.2, update_densify_stats: bool = True,
                group=None) -> ShardedKey:
    """The key of a sharded step's call: rain_tpu's ``_get_sharded_step``
    key (rain_tpu/train/trainer.py:273-274: width, height, sh_degree, the
    tier per shard, the devices, update_densify_stats) with lambda_dssim,
    this rank and the shard's capacity (``state``: this rank's shard)."""
    return ShardedKey(int(width), int(height), int(sh_degree),
                      int(max_instances_per_shard), float(lambda_dssim),
                      bool(update_densify_stats),
                      distributed.world_size(group), distributed.rank(group),
                      state.capacity)


def _whole_capacity(key) -> int:
    """The capacity of the whole state a key's graph steps, renders,
    densifies or resets: a shard's times the shards."""
    return key.capacity * getattr(key, "world", 1)


def capture_mode() -> str:
    """The capture's cudaStreamCaptureMode: "thread_local" in a process of
    an NCCL group, whose watchdog thread queries the events of earlier
    collectives while a capture runs (in "global" mode a call of another
    thread can invalidate the capture); "global", torch's default, in any
    other process."""
    return "thread_local" if distributed.backend() == "nccl" else "global"


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
    static outputs, its stage marks and the kernel launches it holds.

    Built by the key's first call, whose result is the warm-up's: the
    eager step on the buffers, on a side stream, with its launches counted
    as launches and no stage hook. The capture that follows launches
    nothing and counts nothing, so each call counts its kernels once; it
    passes ``fn`` the graph's ``Marks`` as its hook, after the "begin"
    mark. ``fn(buffers, on_stage)`` returns the outputs."""

    def __init__(self, fn, inputs, buffers, device, pool):
        self.inputs = buffers
        self.check(inputs, device)
        _copy(self.inputs, inputs)
        here = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            first = fn(self.inputs, tile_render.no_stage_hook)
        here.wait_stream(side)
        ids = {id(x): i for i, x in enumerate(self.inputs)}
        for x in first:
            if id(x) not in ids:
                x.record_stream(here)   # made on the side stream, used here
        self.first = (first, [ids.get(id(x)) for x in first])
        before = launch_counts()
        self.marks = marks_mod.Marks(device)
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()    # see the module docstring's Capture
        try:
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode=capture_mode()):
                self.marks("begin")
                self.outputs = fn(self.inputs, self.marks)
        finally:
            if collecting:
                gc.enable()
            self.launches = [k - n for k, n in zip(launch_counts(), before)]
            for (f, attr), n in zip(COUNTED, before):
                setattr(f, attr, n)
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

    def __call__(self, inputs, device, span) -> list:
        """A replay on ``inputs``: the outputs as new tensors. ``span(name)``
        gives the host range of each part."""
        with span("copy_in"):
            self.check(inputs, device)
            _copy(self.inputs, inputs)
        with span("replay"):
            self.graph.replay()
        self.replays += 1
        for (f, attr), n in zip(COUNTED, self.launches):
            setattr(f, attr, getattr(f, attr) + n)
        with span("copy_out"):
            fresh = [x for x, a in zip(self.outputs, self.alias)
                     if a is None]
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


def _opt(take) -> adam_mod.AdamState:
    """An AdamState from the buffers: the moments, then the step count."""
    mu = gmod.GaussianParams(*take(N_PARAMS))
    return adam_mod.AdamState(mu, gmod.GaussianParams(*take(N_PARAMS)),
                              *take(1))


def _step_inputs(state, opt, camera, gt_image, bg, low_pass, xyz_lr,
                 leaves, wh=(), depth=None):
    """(values, dtypes) of a training step's inputs, in the order
    ``_step_args`` takes them back; n_alive, real_wh (``wh``) int32, the
    rates f32; then, with ``depth`` (a step.DepthTarget), its target and
    mask and its weight (f32)."""
    f32, i32 = torch.float32, torch.int32
    extra = () if depth is None else (
        ([depth.inv_depth, depth.mask], None), ([depth.weight], f32))
    return _flat(
        (list(state.params), None),
        ([getattr(state, k) for k in gmod.STAT_FIELDS], None),
        ([state.n_alive], i32),
        (list(opt.mu) + list(opt.nu) + [opt.step], None),
        ([camera[k] for k in CAMERA] + [gt_image, bg], None),
        ([low_pass, xyz_lr] + [leaves[k] for k in OPT_LEAVES], f32),
        (list(wh), i32), *extra)


def _step_args(buffers, n_wh: int) -> tuple:
    """(state, opt, camera, gt_image, bg, low_pass, xyz_lr, leaves, wh)
    from the buffers of ``_step_inputs`` (a depth term's three, last,
    are the caller's)."""
    take = _taker(buffers)
    st = _state(take, with_stats=True)
    op = _opt(take)
    cam = dict(zip(CAMERA, take(len(CAMERA))))
    gt, bgv, lp, lr = take(4)
    leaves = dict(zip(OPT_LEAVES, take(len(OPT_LEAVES))))
    return st, op, cam, gt, bgv, lp, lr, leaves, tuple(take(n_wh))


def _step_outputs(state, opt, aux) -> list:
    """A training step's results as the list of tensors a graph returns."""
    return (list(state.params) +
            [getattr(state, k) for k in gmod.STAT_FIELDS] +
            list(opt.mu) + list(opt.nu) + [opt.step] +
            [aux.loss, aux.l1, aux.num_instances, aux.instance_overflow])


def _step_results(outputs, n_alive) -> tuple:
    """(state, opt, (loss, l1, num_instances, instance_overflow[,
    inv_depth])) from ``_step_outputs``' list (the rendered inverse depth
    after it in a step with the depth term); the state's n_alive is
    ``n_alive``."""
    take = _taker(outputs)
    params = gmod.GaussianParams(*take(N_PARAMS))
    state = gmod.GaussianState(params, n_alive, *take(len(gmod.STAT_FIELDS)))
    # the aux's 4 or 5 follow the leaves, statistics, moments and step
    n_aux = len(outputs) - 3 * N_PARAMS - len(gmod.STAT_FIELDS) - 1
    return state, _opt(take), take(n_aux)


def _spanned(method):
    """A CompiledStep method inside the host range rain.compiled.<its
    name> while a profiler is on. The call's one check of the profiler;
    its inner spans (``CompiledStep._span``) read the answer."""
    name = SPAN + method.__name__

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        self._profiling = torch._C._autograd._profiler_enabled()
        if not self._profiling:
            return method(self, *args, **kwargs)
        with record_function(name):
            return method(self, *args, **kwargs)
    return call


class CompiledStep:
    """``train_step`` and ``eval_render`` of train.step, the sharded step
    of parallel.sharding, and model.densify's round and opacity reset,
    each key captured once into a CUDA graph (see the module docstring). One instance holds one memory pool for all
    its graphs: one per Trainer, or per render CLI run. ``captures`` lists
    (key, warm-up and capture ms) in order."""

    def __init__(self):
        self.graphs = {}
        self.train_keys = set()
        self.eval_keys = set()
        self.sharded_train_keys = set()
        self.densify_keys = set()
        self.reset_keys = set()
        self.captures = []
        self._pool = None
        # static input buffers, shared by the graphs whose inputs have the
        # same shapes and dtypes (the keys of one capacity differ in their
        # static arguments only): replays run one at a time, each after
        # its own copy-in
        self._buffers = {}
        # the sharded step of each key, made once (rain_tpu/train/
        # trainer.py:272-283)
        self._sharded_fns = {}
        self.last_step_key = None   # of the last train or sharded step
        self._profiling = False     # whether the current call is traced

    def _span(self, name: str):
        """The host range rain.compiled.<name> in a traced call."""
        return record_function(SPAN + name) if self._profiling else _NO_SPAN

    def _run(self, key, fn, inputs, dtypes, device) -> list:
        """fn's outputs on ``inputs``: replayed from the key's graph, or,
        at the key's first call, the warm-up's before the capture."""
        g = self.graphs.get(key)
        if g is not None:
            return g(inputs, device, self._span)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        kind = type(key), tuple(_spec(x, t) for x, t in zip(inputs, dtypes))
        if kind not in self._buffers:
            self._buffers[kind] = [torch.empty(shape, dtype=t, device=device)
                                   for shape, t in kind[1]]
        with self._span("capture"):
            g = _Graph(fn, inputs, self._buffers[kind], device, self._pool)
        g.kind = kind
        self.graphs[key] = g
        self.captures.append((key, (time.perf_counter() - t0) * 1e3))
        return g.take_first(inputs)

    def stage_ms(self, key) -> dict:
        """{stage: device ms} of the key's last replay, in the order of its
        marks (train.marks: each interval named by the mark that ends
        it); {} for a key with no graph or not replayed yet. One copy to
        the host, which waits for the device: never on the step's path."""
        g = self.graphs.get(key)
        if g is None or not g.replays:
            return {}
        return g.marks.ms()

    def retire(self, capacity: int, max_instances: int) -> None:
        """Drop the graphs of keys below the whole capacity ``capacity``
        (a shard's key's capacity times its shards) or, for the keys with
        a tier, below the tier ``max_instances``: a Trainer's capacity and
        tier only grow. A pool left without a graph is released, and the
        next capture starts another (a pool's handle is not reused once
        its last graph is gone)."""
        def outgrown(k):
            return _whole_capacity(k) < capacity or \
                getattr(k, "max_instances", max_instances) < max_instances
        for key in [k for k in self.graphs if outgrown(k)]:
            del self.graphs[key]
        self._sharded_fns = {k: f for k, f in self._sharded_fns.items()
                             if not outgrown(k)}
        kinds = {g.kind for g in self.graphs.values()}
        self._buffers = {k: v for k, v in self._buffers.items()
                         if k in kinds}
        if not self.graphs:
            self._pool = None

    def clear(self) -> None:
        """Drop every graph, after the device has run what was queued. An
        NCCL group's communicator must not be destroyed while a graph
        holds its collectives: NCCL waits for such graphs to go, and a
        process that destroys the group first hangs there."""
        if self.graphs:
            torch.cuda.synchronize()
        self.graphs, self._buffers, self._sharded_fns = {}, {}, {}
        self._pool = None

    @_spanned
    def train_step(self, state: gmod.GaussianState, opt: adam_mod.AdamState,
                   camera: dict, gt_image: torch.Tensor, bg: torch.Tensor,
                   low_pass, xyz_lr, *, width: int, height: int,
                   sh_degree: int, max_instances: int, opt_cfg_leaves: dict,
                   lambda_dssim: float = 0.2,
                   update_densify_stats: bool = True, real_wh=None,
                   depth: step_mod.DepthTarget | None = None):
        """``step.train_step`` (same arguments but ``on_stage``, same
        results), replayed from the key's graph on the card."""
        key = train_key(state, width=width, height=height,
                        sh_degree=sh_degree, max_instances=max_instances,
                        lambda_dssim=lambda_dssim,
                        update_densify_stats=update_densify_stats,
                        real_wh=real_wh, depth=depth is not None)
        self.train_keys.add(key)
        kw = dict(width=key.width, height=key.height,
                  sh_degree=key.sh_degree, max_instances=key.max_instances,
                  lambda_dssim=key.lambda_dssim,
                  update_densify_stats=key.update_densify_stats)
        dev = _device(state)
        if dev.type == "cpu":
            return step_mod.train_step(
                state, opt, camera, gt_image, bg, low_pass, xyz_lr,
                opt_cfg_leaves=opt_cfg_leaves, real_wh=real_wh, depth=depth,
                **kw)

        wh = tuple(real_wh or ())
        xs, dtypes = _step_inputs(state, opt, camera, gt_image, bg, low_pass,
                                  xyz_lr, opt_cfg_leaves, wh, depth)

        def run(b, on_stage):
            st, op, cam, gt, bgv, lp, lr, leaves, rwh = _step_args(b, len(wh))
            target = None if depth is None else step_mod.DepthTarget(*b[-3:])
            st, op, aux = step_mod.train_step(
                st, op, cam, gt, bgv, lp, lr, opt_cfg_leaves=leaves,
                real_wh=rwh or None, on_stage=on_stage, depth=target, **kw)
            return _step_outputs(st, op, aux) + (
                [] if depth is None else [aux.inv_depth])

        new_state, new_opt, aux = _step_results(
            self._run(key, run, xs, dtypes, dev), state.n_alive)
        self.last_step_key = key
        return new_state, new_opt, step_mod.StepAux(*aux[:4], state.n_alive,
                                                    *aux[4:])

    @_spanned
    def sharded_train_step(self, state: gmod.GaussianState,
                           opt: adam_mod.AdamState, camera: dict,
                           gt_image: torch.Tensor, bg: torch.Tensor,
                           low_pass, xyz_lr, opt_leaves: dict, *, width: int,
                           height: int, sh_degree: int,
                           max_instances_per_shard: int,
                           lambda_dssim: float = 0.2,
                           update_densify_stats: bool = True, group=None,
                           depth=None):
        """The step of ``sharding.make_sharded_train_step(group, ...)``
        (same arguments but ``on_stage``, same results) on this rank's
        shard, made once per key; on an NCCL group with the state on the
        card replayed from the key's graph, with its collectives inside.
        Every rank of the group calls it together, with the same key.
        The sharded step has no depth term: ``depth`` other than None
        raises ValueError."""
        sharding.refuse_depth(depth)
        key = sharded_key(state, width=width, height=height,
                          sh_degree=sh_degree,
                          max_instances_per_shard=max_instances_per_shard,
                          lambda_dssim=lambda_dssim,
                          update_densify_stats=update_densify_stats,
                          group=group)
        self.sharded_train_keys.add(key)
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = self._sharded_fns[key] = sharding.make_sharded_train_step(
                group, width=key.width, height=key.height,
                sh_degree=key.sh_degree,
                max_instances_per_shard=key.max_instances,
                lambda_dssim=key.lambda_dssim,
                update_densify_stats=key.update_densify_stats)
        dev = _device(state)
        if dev.type == "cpu" or distributed.backend(group) != "nccl":
            return fn(state, opt, camera, gt_image, bg, low_pass, xyz_lr,
                      opt_leaves)

        xs, dtypes = _step_inputs(state, opt, camera, gt_image, bg, low_pass,
                                  xyz_lr, opt_leaves)

        def run(b, on_stage):
            st, op, cam, gt, bgv, lp, lr, leaves, _ = _step_args(b, 0)
            return _step_outputs(*fn(st, op, cam, gt, bgv, lp, lr, leaves,
                                     on_stage))

        new_state, new_opt, (loss, l1, n_inst, overflow) = _step_results(
            self._run(key, run, xs, dtypes, dev), state.n_alive)
        self.last_step_key = key
        return new_state, new_opt, sharding.ShardedAux(
            loss=loss, l1=l1, num_instances=n_inst,
            instance_overflow=overflow, n_alive=state.n_alive)

    @_spanned
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

        def run(b, on_stage):
            take = _taker(b)
            st = _state(take, with_stats=False)
            cam = dict(zip(CAMERA, take(len(CAMERA))))
            bgv, lp, sm = take(3)
            return list(step_mod.eval_render(st, cam, bgv, lp, sm,
                                             on_stage=on_stage, **kw))

        return render_ops.RenderOutput(*self._run(key, run, xs, dtypes, dev))


    @_spanned
    def densify_and_prune(self, state: gmod.GaussianState,
                          opt: adam_mod.AdamState, noise: torch.Tensor, *,
                          max_grad, min_opacity, extent, percent_dense,
                          divide_ratio, size_threshold=20.0,
                          use_size_threshold: bool = False, n_split: int = 2,
                          abe_split: bool = False):
        """``densify.densify_and_prune`` (same arguments, same results: a
        new state with a Python n_alive, Adam's state and a DensifyInfo
        of Python numbers), its round replayed from the key's graph on the
        card. The info's read is the call's one wait for the device."""
        key = DensifyKey(state.capacity, int(n_split), bool(abe_split),
                         bool(use_size_threshold))
        self.densify_keys.add(key)
        static = dict(n_split=key.n_split, abe_split=key.abe_split,
                      use_size_threshold=key.use_size_threshold)
        scalars = dict(max_grad=max_grad, min_opacity=min_opacity,
                       extent=extent, percent_dense=percent_dense,
                       divide_ratio=divide_ratio,
                       size_threshold=size_threshold)
        dev = _device(state)
        if dev.type == "cpu":
            return densify_mod.densify_and_prune(state, opt, noise,
                                                 **scalars, **static)

        xs, dtypes = _flat(
            (list(state.params), None),
            ([getattr(state, k) for k in gmod.STAT_FIELDS], None),
            ([state.n_alive], torch.int32),
            (list(opt.mu) + list(opt.nu) + [opt.step, noise], None),
            ([scalars[k] for k in ROUND_SCALARS], torch.float32))

        def run(b, on_stage):
            take = _taker(b)
            st = _state(take, with_stats=True)
            op = _opt(take)
            nz, = take(1)
            sc = dict(zip(ROUND_SCALARS, take(len(ROUND_SCALARS))))
            new, new_op, info = densify_mod.densify_round(st, op, nz, **sc,
                                                          **static)
            on_stage("round", info)
            return (list(new.params) +
                    [getattr(new, k) for k in gmod.STAT_FIELDS] +
                    list(new_op.mu) + list(new_op.nu) + [new_op.step, info])

        take = _taker(self._run(key, run, xs, dtypes, dev))
        params = gmod.GaussianParams(*take(N_PARAMS))
        stats = take(len(gmod.STAT_FIELDS))
        new_opt = _opt(take)
        with self._span("round_read"):
            info = densify_mod.unpack_info(*take(1))
        return gmod.GaussianState(params, info.n_alive, *stats), new_opt, info

    @_spanned
    def reset_opacity(self, state: gmod.GaussianState,
                      opt: adam_mod.AdamState, *, world: int = 1):
        """``densify.reset_opacity`` (same results), replayed from the
        key's graph on the card: the opacity copied in, its reset logits
        and zero moments out. ``world``: the shards the whole state is
        split into, of which ``state`` is one (``retire`` compares the
        whole capacity)."""
        key = ResetKey(state.capacity, int(world))
        self.reset_keys.add(key)
        dev = _device(state)
        if dev.type == "cpu":
            return densify_mod.reset_opacity(state, opt)

        def run(b, on_stage):
            op, = b
            out = [densify_mod.reset_logits(op), torch.zeros_like(op),
                   torch.zeros_like(op)]
            on_stage("reset", out)
            return out

        opacity, mu, nu = self._run(key, run, [state.params.opacity], [None],
                                    dev)
        params = state.params._replace(opacity=opacity)
        return state._replace(params=params), adam_mod.AdamState(
            mu=opt.mu._replace(opacity=mu), nu=opt.nu._replace(opacity=nu),
            step=opt.step)


def _device(state: gmod.GaussianState) -> torch.device:
    dev = state.params.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no compiled step for device {dev}")
    return dev
