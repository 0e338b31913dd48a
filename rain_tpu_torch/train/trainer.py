"""The host-side training loop.

Port of rain_tpu/train/trainer.py, the counterpart of reference
train.py:training() (:24-151): camera sampling, schedule evaluation (LR /
SH degree / c2f low-pass), densify cadence, opacity resets, eval reports
and checkpoints around ``train_step``. What the fixed-capacity design adds
to the reference, as in rain_tpu:

- capacity growth before densification can overflow;
- instance-buffer tiers grown on overflow, with the overflowed step thrown
  away and run again at the grown tier (the reference resizes its binning
  buffers exactly and never trains on truncated data,
  rasterize_points.cu:16-22);
- one-step-late verification: each step's [loss, overflow,
  num_instances, l1] is copied to pinned host memory without a wait and
  read only after the next step has been queued, so the host never drains
  the device's queue to read a flag (see ``_enqueue_step``).

Sharded mode (``system.devices`` N > 1, rain_tpu's n_devices; 0 means the
group's world size): one Trainer per rank of an initialised
``torch.distributed`` group of world size N (parallel.distributed), every
rank with the same scene and configuration. Rank r holds shard r of the
parameters, Adam's moments and the densify statistics, and trains with
parallel.sharding's step through its CompiledStep (one graph per key and
rank on an NCCL group, the eager step on gloo), whose flags are already
reduced over the ranks, so every rank takes the same decisions (an
overflow on any band retries the step on every rank). The capacity is a multiple of N (at creation, at
growth and at resume); the instance tier is per band,
max(round_up(2·base/N, 65536), 65536); cameras are never bucketed.
Densify rounds and capacity growth gather the whole state on every rank,
run the single-device code there with the Trainer's seeded generator
(the same draws on every rank; the round through the CompiledStep, as on
one device) and keep shard r; the opacity reset is elementwise and runs
on the shard. Reports and saves gather the state (a
collective every rank joins); only rank 0 renders, through the same
CompiledStep's eval_render, logs to TensorBoard and writes files, as
rain_tpu's process 0.

Depth regularization (port only; graphdeco-inria/gaussian-splatting's
2024 train.py): with ``model.depths`` set, each step on a camera that
carries a reliable inverse depth map, while the schedule's weight
(``schedules.depth_l1_weight``) is above 0, passes the map, its mask and
the weight to the step (``step.DepthTarget``: its own graph key); any
other step has no depth term, as upstream's. The sharded step has none
and refuses the target.
"""

from __future__ import annotations

import collections
import contextlib
import json
import random
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.eval.lpips import lpips_fn_or_none
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.parallel import distributed
from rain_tpu_torch.parallel import sharding
from rain_tpu_torch.train import checkpoint as ckpt
from rain_tpu_torch.train import compiled
from rain_tpu_torch.train import schedules
from rain_tpu_torch.train import step as step_mod

# the bound past which an instance tier means a pathological scene
MAX_INSTANCE_TIER = 1 << 27
# the host ranges' prefix (rain.trainer.schedule, .dispatch, ...)
SPAN = "rain.trainer."
_NO_SPAN = contextlib.nullcontext()
COUNTERS = ("syncs", "rounds", "appended", "pruned", "resets",
            "capacity_grows", "tier_grows", "refires")


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


def _next_instance_tier(m: int) -> int:
    """Next instance-buffer tier above m on the half-step ladder
    {2^k, 3·2^(k-1)} (rain_tpu/train/trainer.py:47-59). The port's
    expansion takes any M; the ladder is kept so that both packages grow
    their tiers in the same sequence."""
    p = 1 << (int(m).bit_length() - 1)         # largest pow2 <= m
    for cand in (p + (p >> 1), 2 * p, 3 * p):
        if cand > m:
            return cand
    return 4 * p


def _fitting_tier(m: int, needed: int) -> int:
    """The first tier of the ladder above m that holds ``needed``
    instances (at least the next one), within MAX_INSTANCE_TIER."""
    m = _next_instance_tier(m)
    while m < needed:
        m = _next_instance_tier(m)
    if m > MAX_INSTANCE_TIER:
        raise MemoryError(
            f"instance tier {m} exceeds the 2^27 sanity bound — the scene "
            f"configuration is pathological")
    return m


@torch.no_grad()
def render_whole(state, camera, bg, low_pass, scale_modifier=1.0, *,
                 width: int, height: int, sh_degree: int, max_instances: int,
                 steps: compiled.CompiledStep | None):
    """eval_render of a view through ``steps``, a CompiledStep (None: the
    eager ``step.eval_render``), never truncated: rendered at
    ``max_instances`` and, if that overflows, again at the first ladder
    tier that holds the view's instances (rain_tpu
    shows, scores and saves the truncated image:
    rain_tpu/train/trainer.py:606-616,648-653,
    rain_tpu/scripts/render.py:110). The overflow flag is read after the
    first render. Returns (output, the tier of the second render or
    None)."""
    eval_render = step_mod.eval_render if steps is None else \
        steps.eval_render

    def render(tier):
        return eval_render(
            state, camera, bg, low_pass, scale_modifier, width=width,
            height=height, sh_degree=sh_degree, max_instances=tier)

    out = render(max_instances)
    if not bool(out.overflow):
        return out, None
    again = _fitting_tier(max_instances, int(out.num_instances))
    return render(again), again     # the same view: no overflow


class _Verified(NamedTuple):
    """Host-side scalar results of a verified train step."""
    loss: float
    l1: float
    num_instances: int
    instance_overflow: bool
    n_alive: int


class _Flags:
    """A step's [loss, overflow, num_instances, l1] on its way to the host.

    On a card the four values are stacked into one f64 tensor (exact for
    the counts) and copied into pinned host memory without a wait; a CUDA
    event marks the copy's end, so reading waits for that step only. On
    the CPU the values are already there.
    """

    def __init__(self, aux: step_mod.StepAux):
        vals = torch.stack([aux.loss.double(),
                            aux.instance_overflow.double(),
                            aux.num_instances.double(), aux.l1.double()])
        self.event = None
        if vals.is_cuda:
            host = torch.empty(4, dtype=torch.float64, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            vals = host
        self.host = vals

    def read(self):
        """(loss, overflow, num_instances, l1) as Python numbers."""
        if self.event is not None:
            self.event.synchronize()
        loss, ovf, ninst, l1 = self.host.tolist()
        return loss, ovf, int(ninst), l1


class Trainer:
    def __init__(self, scene: SceneData, cfgs: dict, model_path: str,
                 *, device=None, log_fn=print, tensorboard: bool = True,
                 viewer=None):
        self.device = device_mod.resolve(device)
        self.scene = scene
        self.model = cfgs["model"]
        self.opt_cfg = cfgs["opt"]
        self.rain = cfgs["rain"]
        self.system = cfgs["system"]
        # devices: 1 = one device; N > 1 = sharded over the N ranks of the
        # default group; 0 = the group's world size
        self.n_devices = self.system.devices or distributed.world_size()
        if self.n_devices > 1 and distributed.world_size() != \
                self.n_devices:
            raise ValueError(
                f"system.devices = {self.n_devices} needs an initialised "
                f"torch.distributed group of world size {self.n_devices} "
                f"(parallel.distributed.initialize; the train CLI's "
                f"--dist_init), found world size "
                f"{distributed.world_size()}")
        if self.n_devices > 1 and viewer is not None:
            raise ValueError("the viewer serves a run on one device")
        self.rank = distributed.rank()
        # only rank 0 writes files, logs to TensorBoard and renders reports
        self.is_rank0 = self.rank == 0
        self.model_path = Path(model_path)
        self.model_path.mkdir(parents=True, exist_ok=True)
        self.log = log_fn
        self.viewer = viewer    # a viewer.network_gui.NetworkGUI, or None
        self.tb = None
        if tensorboard and self.is_rank0:
            try:  # same optional dependency handling as train.py:17-21
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(str(self.model_path))
            except Exception:
                self.log("Tensorboard not available: not logging progress")
        # TensorBoard encodes images with PIL, which a machine may lack
        self._tb_images = False
        if self.tb is not None:
            try:
                import PIL  # noqa: F401
                self._tb_images = True
            except ImportError:
                self.log("PIL does not import: the reports' images are not "
                         "written to TensorBoard")

        self.divide_ratio = 0.7 if (self.rain.ours or self.rain.ours_new) \
            else 0.8                                  # train.py:28-32
        self.spatial_lr_scale = scene.nerf_radius

        n0 = scene.points.shape[0]
        cap = self._capacity(
            self.system.capacity or max(_round_up(n0 * 2, 4096), 16384))
        state = gmod.create_from_pcd(
            scene.points, scene.colors, sh_degree=self.model.sh_degree,
            capacity=cap, device=self.device)
        self._keep(state, adam_mod.init(state.params))
        base_instances = self.system.max_instances or max(
            _round_up(n0 * 8, 65536), 262144)
        if self._sharded:
            # each band bins ~1/N of the instances (2x slack for uneven
            # bands), as rain_tpu/train/trainer.py:140-150
            self.max_instances = max(
                _round_up(2 * base_instances // self.n_devices, 65536),
                65536)
        else:
            self.max_instances = base_instances

        bg = [1.0, 1.0, 1.0] if self.model.white_background else [0, 0, 0]
        self.background = torch.tensor(bg, dtype=torch.float32,
                                       device=self.device)

        # --profile_steps A-B: a torch.profiler trace over those iterations
        self._profile_range = None
        self._profiler = None
        self.profile = None          # the finished profiler, for its tables
        self.profile_wall_ms = None  # and the host-clock time it covered
        self._profile_t0 = None
        spec = self.system.profile_steps
        if spec and self.is_rank0:
            a, _, b = spec.partition("-")
            self._profile_range = (int(a), int(b or a))

        # Resolution bucketing (rain_tpu/train/trainer.py:163-173): with
        # mixed camera sizes, cameras are padded to tile-aligned buckets
        # and the step masks the loss to the true size
        # The sharded step keeps exact sizes, as rain_tpu's
        sizes = {(c.width, c.height) for c in scene.train_cameras}
        self._bucketed = len(sizes) > 1 and not self._sharded
        # the step, the report renders, the densify rounds and the opacity
        # resets go through one CompiledStep (one graph per key on the
        # card, the eager functions on the CPU; the sharded step is
        # captured on an NCCL group and eager on gloo); its keys are
        # rain_tpu's jit keys (``_step_keys``)
        self._steps = compiled.CompiledStep()
        self._opt_leaves = None     # the lrs as 0-d device tensors

        self.iteration = 0
        self.low_pass = 0.3
        self.ema_loss = 0.0
        # one-step-late verification (see _enqueue_step)
        self._pending = None
        self._last_verified = None
        self._viewpoint_stack = []
        self._rng = random.Random(0)
        # the split noise and the random background
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.system.seed)
        self._cam_arrays = collections.OrderedDict()
        self._cam_depths = collections.OrderedDict()
        self.densify_until = (self.opt_cfg.densify_until_iter +
                              self.rain.warmup_iter)  # train.py:38-39
        self.history = []
        # (iteration, view, tier, re-render tier) of each report view that
        # overflowed the training tier and was rendered again
        self.report_rerenders = []
        for name in COUNTERS:
            setattr(self, name, 0)
        self._profiling = False     # whether this iteration is traced

    def counters(self) -> dict:
        """{counter: count} of the loop's counters (see the module
        docstring)."""
        return {name: getattr(self, name) for name in COUNTERS}

    def _span(self, name: str):
        """The host range rain.trainer.<name> in a traced iteration."""
        return record_function(SPAN + name) if self._profiling else _NO_SPAN

    # -- the state of a sharded run ---------------------------------------
    @property
    def _sharded(self) -> bool:
        return self.n_devices > 1

    @property
    def _step_keys(self) -> set:
        """The keys of the steps run, one compilation each, on the CPU and
        on the card alike: ``compiled.train_key``'s (rain_tpu's
        ``_bucket_keys``), or in a sharded run ``compiled.sharded_key``'s
        (rain_tpu's ``_sharded_steps``' keys with the shard's capacity)."""
        return self._steps.sharded_train_keys if self._sharded else \
            self._steps.train_keys

    def _capacity(self, cap: int) -> int:
        """``cap`` rounded up to a multiple of the ranks (the sharded step
        splits the capacity axis over them)."""
        return _round_up(cap, self.n_devices) if self._sharded else cap

    def _whole(self):
        """(state, opt) of the whole capacity: in a sharded run gathered
        from every rank's shard, a collective every rank must join."""
        if not self._sharded:
            return self.state, self.opt_state
        return (sharding.gather_state(self.state),
                sharding.gather_opt(self.opt_state))

    def _keep(self, state, opt):
        """Hold (state, opt) of the whole capacity: this rank's shard of
        it in a sharded run."""
        if self._sharded:
            state = sharding.shard_state(state, self.rank, self.n_devices)
            opt = sharding.shard_opt(opt, self.rank, self.n_devices)
        self.state, self.opt_state = state, opt

    # -- camera handling --------------------------------------------------
    def _camera_bundle(self, cam):
        """Device tensors for a camera, LRU-bounded so GT images don't pin
        unbounded device memory (system.camera_cache; 0 keeps everything
        resident, like the reference's cameraList_from_camInfos,
        utils/camera_utils.py:43-49)."""
        if cam.uid in self._cam_arrays:
            self._cam_arrays.move_to_end(cam.uid)
        else:
            limit = self.system.camera_cache
            if limit and len(self._cam_arrays) >= limit:
                self._cam_arrays.popitem(last=False)
            img = cam.image
            if img is not None and self._bucketed:
                # zero-pad the GT to the camera's tile bucket (the step's
                # masked loss requires zeros beyond the true size)
                bw, bh = _round_up(cam.width, 16), _round_up(cam.height, 16)
                if (bw, bh) != (cam.width, cam.height):
                    padded = np.zeros((3, bh, bw), np.float32)
                    padded[:, :cam.height, :cam.width] = img
                    img = padded
            gt = None if img is None else torch.from_numpy(
                np.array(img, np.float32)).to(self.device)
            self._cam_arrays[cam.uid] = (cam.render_inputs(self.device), gt)
        return self._cam_arrays[cam.uid]

    def _depth_maps(self, cam):
        """(inverse depth, mask) of a camera as device tensors, zero-padded
        to its bucket when bucketed; LRU-bounded as ``_camera_bundle``."""
        if cam.uid in self._cam_depths:
            self._cam_depths.move_to_end(cam.uid)
        else:
            limit = self.system.camera_cache
            if limit and len(self._cam_depths) >= limit:
                self._cam_depths.popitem(last=False)
            maps = []
            for arr in (cam.invdepthmap, cam.depth_mask):
                if self._bucketed:
                    bw = _round_up(cam.width, 16)
                    bh = _round_up(cam.height, 16)
                    padded = np.zeros((bh, bw), np.float32)
                    padded[:cam.height, :cam.width] = arr
                    arr = padded
                maps.append(torch.from_numpy(
                    np.array(arr, np.float32)).to(self.device))
            self._cam_depths[cam.uid] = tuple(maps)
        return self._cam_depths[cam.uid]

    def _depth_target(self, cam, iteration: int):
        """The step's DepthTarget at ``iteration``, or None: no depths
        folder, no map, a map that is not reliable, or a weight of 0."""
        if not self.model.depths or cam.invdepthmap is None or \
                not cam.depth_reliable:
            return None
        weight = schedules.depth_l1_weight(iteration, self.opt_cfg)
        if weight <= 0.0:
            return None
        return step_mod.DepthTarget(*self._depth_maps(cam), weight)

    def _next_camera(self):
        if not self._viewpoint_stack:
            self._viewpoint_stack = list(self.scene.train_cameras)
        return self._viewpoint_stack.pop(
            self._rng.randint(0, len(self._viewpoint_stack) - 1))

    def _split_noise(self, capacity: int) -> torch.Tensor:
        """The standard normal draws of one densify round, [2, C, 3]."""
        return torch.randn((2, capacity, 3), generator=self._gen,
                           device=self.device)

    # -- capacity management ----------------------------------------------
    def _maybe_grow(self, state, opt, force: bool = False):
        """(state, opt) of the whole capacity, grown when the live count
        nears it — or unconditionally when a densify round overflowed (its
        appends were dropped; the next round must have room, like the
        reference's dynamic tensor growth)."""
        n = state.n_alive
        cap = state.capacity
        if force or n > 0.6 * cap:
            new_cap = self._capacity(_round_up(cap * 2, 4096))
            limit = self.system.max_capacity
            if limit and new_cap > limit:
                if cap >= limit:
                    self.log(f"[cap] at max_capacity {limit} — not "
                             f"growing (alive {n}); densify appends "
                             f"beyond capacity will be dropped")
                    return state, opt
                new_cap = _round_up(limit, 4096)
            self.log(f"[cap] growing capacity {cap} -> {new_cap} "
                     f"(alive {n})")
            self.capacity_grows += 1
            state = gmod.grow_capacity(state, new_cap)
            opt = adam_mod.AdamState(
                mu=self._pad_params(opt.mu, new_cap),
                nu=self._pad_params(opt.nu, new_cap), step=opt.step)
        return state, opt

    @staticmethod
    def _pad_params(params: gmod.GaussianParams, new_cap: int):
        def pad(x):
            return torch.cat([x, x.new_zeros((new_cap - x.shape[0],) +
                                             tuple(x.shape[1:]))])
        return gmod.GaussianParams(*[pad(x) for x in params])

    def _grow_instances(self, min_needed: int = 0):
        """Grow the instance tier; with the overflow step's reported
        instance count, jump straight to the first ladder tier that fits
        (each intermediate tier would cost a discarded step)."""
        self.max_instances = _fitting_tier(self.max_instances, min_needed)
        self.tier_grows += 1
        self.log(f"[cap] growing instance buffer -> {self.max_instances}")

    # -- one optimization step ---------------------------------------------
    def _dispatch(self, args):
        """Queue one train step without waiting for it. Returns (state,
        opt, flags) with flags a _Flags on its way to the host."""
        (cam, cam_arrays, gt, bg, low_pass, xyz_lr, sh_deg, opt_leaves,
         update_stats, depth) = args
        # every per-call value a 0-d device tensor, as rain_tpu traces it
        # (rain_tpu/train/trainer.py:292-306): fills, which do not wait
        # for the device
        f32, i32 = torch.float32, torch.int32
        if self._opt_leaves is None:
            self._opt_leaves = {k: device_mod.scalar(v, f32, self.device)
                                for k, v in opt_leaves.items()}
        n_alive = self.state.n_alive
        state = self.state._replace(
            n_alive=device_mod.scalar(n_alive, i32, self.device))
        lp = device_mod.scalar(low_pass, f32, self.device)
        lr = device_mod.scalar(xyz_lr, f32, self.device)
        # the graphs of outgrown capacities and tiers go (a rank's state is
        # its shard of the capacity)
        self._steps.retire(state.capacity * self.n_devices,
                           self.max_instances)
        if self._sharded:
            state, opt, aux = self._steps.sharded_train_step(
                state, self.opt_state, cam_arrays, gt, bg, lp, lr,
                self._opt_leaves, width=cam.width, height=cam.height,
                sh_degree=sh_deg, max_instances_per_shard=self.max_instances,
                lambda_dssim=self.opt_cfg.lambda_dssim,
                update_densify_stats=update_stats, depth=depth)
            return state._replace(n_alive=n_alive), opt, _Flags(aux)
        if self._bucketed:
            width = _round_up(cam.width, 16)
            height = _round_up(cam.height, 16)
            real_wh = (device_mod.scalar(cam.width, i32, self.device),
                       device_mod.scalar(cam.height, i32, self.device))
        else:
            width, height = cam.width, cam.height
            real_wh = None
        state, opt, aux = self._steps.train_step(
            state, self.opt_state, cam_arrays, gt, bg, lp, lr, width=width,
            height=height, sh_degree=sh_deg,
            max_instances=self.max_instances,
            opt_cfg_leaves=self._opt_leaves,
            lambda_dssim=self.opt_cfg.lambda_dssim,
            update_densify_stats=update_stats, real_wh=real_wh, depth=depth)
        return state._replace(n_alive=n_alive), opt, _Flags(aux)

    def _enqueue_step(self, args):
        """Pipelined step: queue this iteration's step, then verify the
        PREVIOUS step while this one runs on the device. Exactly one step
        is ever unverified, and its pre-state is kept (train_step leaves
        its inputs untouched, so keeping it copies nothing); an overflow
        or a non-finite loss found one step late rolls back and replays
        both steps, so training never goes on from truncated or
        non-finite data (the reference's exact-resize contract,
        rasterize_points.cu:16-22)."""
        prev = (self.state, self.opt_state)
        with self._span("dispatch"):
            state, opt, flags = self._dispatch(args)
        self.state, self.opt_state = state, opt
        new_p = (self.iteration, flags, prev, args)
        old_p = self._pending
        self._pending = new_p
        if old_p is not None:
            with self._span("verify"):
                self._verify(old_p, refire=True)
        if not self.system.pipeline:
            return self.flush_pending()
        return None

    def _abort_non_finite(self, iteration, prev_state, prev_opt):
        """Dump the pre-step state and raise (reference
        dgr/__init__.py:73-80)."""
        dump = self.model_path / f"snapshot_iter{iteration}.npz"
        if self._sharded:   # every rank sees the same loss and gets here
            prev_state = sharding.gather_state(prev_state)
            prev_opt = sharding.gather_opt(prev_opt)
        if self.is_rank0:
            ckpt.save_checkpoint(dump, prev_state, prev_opt, iteration,
                                 self.spatial_lr_scale)
        raise FloatingPointError(
            f"non-finite loss at iteration {iteration}; "
            f"pre-step state dumped to {dump}")

    def _verify(self, pending, refire=False):
        """Blocking verification of a queued step (one copy's wait). On
        overflow: roll back to its pre-state, grow the tier, run it again
        synchronously, and (refire) queue again the newer step whose
        input was the discarded state. On a non-finite loss: dump the
        pre-step state and raise. Returns the verified scalar values."""
        iteration, flags, (prev_state, prev_opt), args = pending
        self.syncs += 1
        loss, ovf, ninst, l1 = flags.read()
        if ovf > 0.0:
            self.refires += 1
            with self._span("refire"):
                later = self._pending if refire and \
                    self._pending is not pending else None
                self.log(f"[cap] instance overflow at iter {iteration} "
                         f"({ninst} > {self.max_instances}) — discarding "
                         f"step(s) and retrying at a larger tier")
                self.state, self.opt_state = prev_state, prev_opt
                self._pending = None
                self._grow_instances(min_needed=ninst)
                verified = self._run_step_sync(args, iteration)
                if later is not None:
                    l_iter, _, _, l_args = later
                    prev = (self.state, self.opt_state)
                    state, opt, lflags = self._dispatch(l_args)
                    self.state, self.opt_state = state, opt
                    self._pending = (l_iter, lflags, prev, l_args)
                return verified
        if not np.isfinite(loss):
            self._abort_non_finite(iteration, prev_state, prev_opt)
        return _Verified(loss=loss, l1=l1, num_instances=ninst,
                         instance_overflow=False,
                         n_alive=prev_state.n_alive)

    def _run_step_sync(self, args, iteration):
        """Synchronous verified step with the overflow-retry loop (never
        train on truncated data)."""
        while True:
            prev_state, prev_opt = self.state, self.opt_state
            state, opt, flags = self._dispatch(args)
            self.syncs += 1
            loss, ovf, ninst, l1 = flags.read()
            if ovf > 0.0:
                self.log(f"[cap] instance overflow at iter {iteration} "
                         f"({ninst} > {self.max_instances}) — "
                         f"discarding step and retrying at a larger tier")
                self._grow_instances(min_needed=ninst)
                continue
            if not np.isfinite(loss):
                self._abort_non_finite(iteration, prev_state, prev_opt)
            self.state, self.opt_state = state, opt
            return _Verified(loss=loss, l1=l1, num_instances=ninst,
                             instance_overflow=False, n_alive=state.n_alive)

    def flush_pending(self):
        """Verify the queued step now (used before any state mutation,
        logging, eval, or checkpointing)."""
        if self._pending is None:
            return self._last_verified
        p, self._pending = self._pending, None
        with self._span("verify"):
            v = self._verify(p, refire=False)
        self._last_verified = v
        return v

    # -- the loop ----------------------------------------------------------
    def train(self, iterations=None, *, test_iterations=(7000, 30000),
              save_iterations=(30000,), checkpoint_iterations=(),
              start_checkpoint=None, start=None):
        """Train to ``iterations`` from iteration 0, from the checkpoint
        file ``start_checkpoint`` or from ``start`` = (state, opt,
        iteration, low_pass) in memory (``_restart``); returns the whole
        final state."""
        opt_cfg = self.opt_cfg
        iterations = iterations or opt_cfg.iterations
        first_iter = 0
        if start is not None and start_checkpoint:
            raise ValueError("start and start_checkpoint are two starts")
        if start is not None:
            self._restart(*start)
            first_iter = self.iteration
        if start_checkpoint:
            # a checkpoint from a long run can hold more Gaussians than
            # the fresh scene-derived capacity — size to fit with growth
            # headroom (reference restore keeps the saved tensor sizes)
            with np.load(start_checkpoint) as z:
                n_ck = int(z["n_alive"])
            cap = self._capacity(max(
                self.state.capacity * self.n_devices,
                _round_up(max(n_ck * 5 // 3, 4096), 4096)))
            state, opt, first_iter, self.spatial_lr_scale = \
                ckpt.load_checkpoint(start_checkpoint, capacity=cap,
                                     device=self.device)
            self._keep(state, opt)
            self.log(f"[ckpt] resumed from {start_checkpoint} at iteration "
                     f"{first_iter}")

        opt_leaves = {
            "feature_lr": opt_cfg.feature_lr,
            "opacity_lr": opt_cfg.opacity_lr,
            "scaling_lr": opt_cfg.scaling_lr,
            "rotation_lr": opt_cfg.rotation_lr,
        }
        t_start = time.time()

        for iteration in range(first_iter + 1, iterations + 1):
            t_iter0 = time.time()
            self.iteration = iteration
            self._profile_tick(iteration)
            self._profiling = torch._C._autograd._profiler_enabled()
            if self.viewer is not None:
                self.flush_pending()   # the viewer renders committed state
                self._poll_viewer(iteration >= iterations)
            with self._span("camera"):
                cam = self._next_camera()
                cam_arrays, gt = self._camera_bundle(cam)
                depth = self._depth_target(cam, iteration)

            with self._span("schedule"):
                xyz_lr = schedules.xyz_lr_at(
                    iteration, opt_cfg, self.spatial_lr_scale,
                    ours_new=self.rain.ours_new,
                    warmup_iter=self.rain.warmup_iter)
                sh_deg = schedules.sh_degree_at(
                    iteration, self.model.sh_degree,
                    ours=self.rain.ours or self.rain.ours_new)
                # the host's own count: no wait for the device
                n_gauss = self.state.n_alive if iteration == 1 or \
                    iteration % int(self.rain.c2f_every_step) == 0 else 0
                self.low_pass = schedules.c2f_low_pass(
                    iteration, c2f=self.rain.c2f,
                    c2f_every_step=self.rain.c2f_every_step,
                    c2f_max_lowpass=self.rain.c2f_max_lowpass,
                    densify_until_iter=self.densify_until,
                    height=cam.height, width=cam.width,
                    num_gaussians=n_gauss or 1, prev=self.low_pass)

                bg = self.background
                if opt_cfg.random_background:          # train.py:94
                    bg = torch.rand(3, generator=self._gen,
                                    device=self.device)

            in_densify = iteration < self.densify_until
            self._enqueue_step((cam, cam_arrays, gt, bg, self.low_pass,
                                xyz_lr, sh_deg, opt_leaves, in_densify,
                                depth))
            if self.tb is not None:   # train.py:183 (per-iteration timing)
                self.tb.add_scalar("iter_time",
                                   (time.time() - t_iter0) * 1000.0,
                                   iteration)

            # eval + PLY snapshot BEFORE densify/reset, like the reference
            # (training_report and scene.save at train.py:127-130 precede
            # densify_and_prune/reset_opacity at :136-143 — an eval landing
            # on an opacity-reset iteration must see the pre-reset model)
            if iteration in test_iterations:
                self.flush_pending()
                self.report(iteration)
            if iteration in save_iterations:
                self.flush_pending()
                state, _ = self._whole()
                if self.is_rank0:
                    path = (self.model_path / "point_cloud" /
                            f"iteration_{iteration}" / "point_cloud.ply")
                    ckpt.save_ply_snapshot(path, state)
                    self.log(f"[{iteration}] saved {path}")

            # densification cadence (train.py:132-143)
            if in_densify and iteration > opt_cfg.densify_from_iter and \
                    iteration % opt_cfg.densification_interval == 0:
                with self._span("round"):
                    self._round(iteration)
            if in_densify and (
                    iteration % opt_cfg.opacity_reset_interval == 0 or
                    (self.model.white_background and
                     iteration == opt_cfg.densify_from_iter)):
                with self._span("reset"):
                    self.flush_pending()
                    self.state, self.opt_state = self._steps.reset_opacity(
                        self.state, self.opt_state, world=self.n_devices)
                self.resets += 1

            if iteration % self.system.log_every == 0 or \
                    iteration == iterations:
                aux = self.flush_pending()
                loss = aux.loss
                self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
                if self.tb is not None:
                    self.tb.add_scalar("train_loss_patches/l1_loss",
                                       aux.l1, iteration)
                    self.tb.add_scalar("train_loss_patches/total_loss",
                                       loss, iteration)
                    self.tb.add_scalar("total_points",
                                       aux.n_alive, iteration)
                if iteration % (self.system.log_every * 10) == 0 or \
                        iteration == iterations:
                    dt = time.time() - t_start
                    self.log(f"[{iteration}] loss {self.ema_loss:.5f} "
                             f"gaussians {aux.n_alive} "
                             f"it/s {iteration / max(dt, 1e-9):.2f}")

            if iteration in checkpoint_iterations:
                self.flush_pending()
                state, opt = self._whole()
                if self.is_rank0:
                    path = self.model_path / f"chkpnt{iteration}.npz"
                    ckpt.save_checkpoint(path, state, opt, iteration,
                                         self.spatial_lr_scale)
                    self.log(f"[{iteration}] checkpoint {path}")
        self.flush_pending()
        self._profile_tick(iterations + 1)   # close a still-open trace
        return self._whole()[0]

    def _restart(self, state, opt, iteration: int, low_pass: float):
        """Make (state, opt) of the whole capacity, with a Python n_alive,
        the state after ``iteration`` with the c2f filter at ``low_pass``:
        the camera order, the split-noise generator and the one-step-late
        verification start as a new Trainer's. The tensors are held, not
        copied (no step changes its inputs)."""
        self._keep(state, opt)
        self.iteration = iteration
        self.low_pass = low_pass
        self._pending = None
        self._last_verified = None
        self._viewpoint_stack = []
        self._rng = random.Random(0)
        self._gen.manual_seed(self.system.seed)
        self.ema_loss = 0.0

    def _round(self, iteration: int):
        """The densify round of ``iteration`` (train.py:132-139)."""
        opt_cfg = self.opt_cfg
        self.flush_pending()   # densify mutates verified state
        state, opt = self._maybe_grow(*self._whole())
        use_size = iteration > opt_cfg.opacity_reset_interval
        abe = iteration <= self.rain.warmup_iter
        noise = self._split_noise(state.capacity)
        # the round's one wait for the device: the read of its info
        # (rain_tpu/train/trainer.py:540)
        n0 = state.n_alive
        state, opt, info = self._steps.densify_and_prune(
            state, opt, noise, max_grad=opt_cfg.densify_grad_threshold,
            min_opacity=0.005, extent=self.scene.nerf_radius,
            percent_dense=opt_cfg.percent_dense,
            divide_ratio=self.divide_ratio, size_threshold=20.0,
            use_size_threshold=use_size, abe_split=abe)
        self.syncs += 1
        self.rounds += 1
        self.pruned += info.n_pruned
        self.appended += info.n_alive + info.n_pruned - n0
        if info.overflow:
            self.log("[cap] densify overflow — growing next round")
            state, opt = self._maybe_grow(state, opt, force=True)
        self._keep(state, opt)

    def _profile_tick(self, iteration: int):
        """Start/stop the torch.profiler trace of --profile_steps A-B (the
        reference only logs per-iteration wall time, train.py:47-48,183).
        The trace goes to <model_path>/profile/ as a Chrome trace, the
        finished profiler stays in ``self.profile`` for its tables, and
        ``self.profile_wall_ms`` holds the host-clock time from the
        trace's start to the end of its last step's device work."""
        if self._profile_range is None:
            return
        a, b = self._profile_range
        if self._profiler is None and a <= iteration <= b:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self._profile_t0 = time.perf_counter()
            self.log(f"[profile] tracing iterations {iteration}..{b}")
        elif self._profiler is not None and iteration > b:
            self.flush_pending()    # the last traced step's work included
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.profile_wall_ms = (time.perf_counter() -
                                    self._profile_t0) * 1e3
            self._profiler.stop()
            path = self.model_path / "profile"
            path.mkdir(parents=True, exist_ok=True)
            trace = path / f"trace_{a}-{b}.json"
            self._profiler.export_chrome_trace(str(trace))
            self.profile, self._profiler = self._profiler, None
            self._profile_range = None
            self.log(f"[profile] trace complete -> {trace}")

    def _poll_viewer(self, training_done: bool):
        """Serve the SIBR viewer (reference train.py:56-69) a frame of the
        current state, rendered whole (``_render_whole``)."""
        def render_fn(cam, scaling_modifier):
            camera = {k: torch.as_tensor(v, device=self.device)
                      for k, v in cam.items() if k not in ("width", "height")}
            out, _ = self._render_whole(
                camera, cam["width"], cam["height"],
                f"[ITER {self.iteration}] viewer frame",
                scaling_modifier or 1.0)
            img = torch.clamp(out.render, 0.0, 1.0).cpu().numpy()
            return memoryview(
                (img * 255).astype(np.uint8).transpose(1, 2, 0).copy())

        self.viewer.handle(render_fn, str(self.model.source_path),
                           training_done)

    # -- evaluation (training_report, train.py:179-224) --------------------
    def _render_whole(self, cam_arrays, width, height, what,
                      scale_modifier=1.0, state=None):
        """``render_whole`` of ``state`` (by default the current one)
        from the training tier, each re-render logged. The training tier
        stays as it is, so the training schedule is rain_tpu's."""
        out, again = render_whole(
            self.state if state is None else state, cam_arrays,
            self.background, self.low_pass,
            scale_modifier, width=width, height=height,
            sh_degree=self.model.sh_degree, max_instances=self.max_instances,
            steps=self._steps)
        if again is not None:
            self.log(f"{what}: {int(out.num_instances)} instances overflow "
                     f"the tier {self.max_instances}; rendered again at "
                     f"{again}")
        return out, again

    def _report_render(self, iteration, cam, cam_arrays, state=None):
        """A report view of ``state`` (by default the current one)
        rendered whole; each re-render is recorded in
        ``report_rerenders``."""
        out, again = self._render_whole(
            cam_arrays, cam.width, cam.height,
            f"[ITER {iteration}] report view {cam.image_name}",
            state=state)
        if again is not None:
            self.report_rerenders.append(
                (iteration, cam.image_name, self.max_instances, again))
        return out

    def _report_stages(self, iteration):
        """The last replayed training step's device ms per stage
        (``CompiledStep.stage_ms``) on one line of the log and, with the
        TensorBoard writer open, as ``stage_ms/<stage>``; nothing where no
        step was replayed (the CPU path, a key's first call)."""
        split = self._steps.stage_ms(self._steps.last_step_key)
        if not split:
            return
        self.log(f"[ITER {iteration}] stage ms of the last step: " +
                 " ".join(f"{k} {v:.3f}" for k, v in split.items()))
        if self.tb is not None:
            for k, v in split.items():
                self.tb.add_scalar(f"stage_ms/{k}", v, iteration)

    @torch.no_grad()
    def report(self, iteration):
        """PSNR, L1, SSIM and, with local VGG weights, LPIPS of the test
        cameras and of 5 training cameras, each rendered whole
        (``_report_render``). In a sharded run every rank gathers the
        state and rank 0 alone renders, logs and writes; the other ranks
        return {}."""
        state, _ = self._whole()
        if not self.is_rank0:
            return {}
        self._report_stages(iteration)
        lpips_fn = lpips_fn_or_none(log_fn=self.log, device=self.device)
        configs = [("test", self.scene.test_cameras),
                   ("train", [self.scene.train_cameras[
                       i % len(self.scene.train_cameras)]
                       for i in range(5, 30, 5)])]
        results = {}
        first_report = not self.history
        for name, cams in configs:
            if not cams:
                continue
            psnrs, l1s, ssims, lpipss = [], [], [], []
            for idx, cam in enumerate(cams):
                cam_arrays, gt = self._camera_bundle(cam)
                if gt is None:
                    continue
                # bucketed training pads the cached GT; eval renders at
                # the exact camera size
                gt = gt[:, :cam.height, :cam.width]
                out = self._report_render(iteration, cam, cam_arrays,
                                          state)
                img = torch.clamp(out.render, 0.0, 1.0)
                gtc = torch.clamp(gt, 0.0, 1.0)
                if self._tb_images and idx < 5:   # train.py:200-203
                    self.tb.add_images(f"{name}_view_{cam.image_name}/render",
                                       img[None].cpu().numpy(), iteration)
                    if first_report:
                        self.tb.add_images(
                            f"{name}_view_{cam.image_name}/ground_truth",
                            gtc[None].cpu().numpy(), iteration)
                psnrs.append(float(loss_ops.psnr(img, gtc)[0]))
                l1s.append(float(loss_ops.l1_loss(img, gtc)))
                ssims.append(float(loss_ops.ssim(img, gtc)))
                if lpips_fn is not None:
                    lpipss.append(float(lpips_fn(img, gtc)))
            if psnrs:
                results[name] = {"psnr": float(np.mean(psnrs)),
                                 "l1": float(np.mean(l1s)),
                                 "ssim": float(np.mean(ssims))}
                if lpipss:
                    results[name]["lpips"] = float(np.mean(lpipss))
                self.log(f"[ITER {iteration}] Evaluating {name}: "
                         f"L1 {results[name]['l1']:.5f} "
                         f"PSNR {results[name]['psnr']:.2f} "
                         f"SSIM {results[name]['ssim']:.4f}" +
                         (f" LPIPS(vgg) {results[name]['lpips']:.4f}"
                          if lpipss else ""))
                if self.tb is not None:
                    for k, v in results[name].items():
                        self.tb.add_scalar(
                            f"{name}/loss_viewpoint - {k}", v, iteration)
        if self.tb is not None:                       # train.py:218-221
            alive = gmod.alive_mask(state)
            opac = torch.sigmoid(state.params.opacity[:, 0])
            self.tb.add_histogram("scene/opacity_histogram",
                                  opac[alive].cpu().numpy(), iteration)
            self.tb.add_scalar("total_points", state.n_alive, iteration)
        self.history.append({"iteration": iteration, **results})
        with (self.model_path / "log_file.txt").open("a") as f:
            f.write(json.dumps({"iteration": iteration, **results}) + "\n")
        return results
