"""Depth-regularized training traffic: ``train``'s closed loop with a depth
term in every step.

The loop of ``loops/train.py`` (the pan's five poses in an order drawn
from the seed, episodes of ``episode_steps`` from the configuration's
state and fresh moments, the same hyper-parameters), each step given a
``DepthTarget`` (rain_tpu_torch.train.step): the pose's target inverse
depth, a mask of ones (every pose reliable) and the weight w(t) of
upstream's schedule (graphdeco-inria/gaussian-splatting's 2024 train.py:
``depth_l1_weight_init`` to ``_final`` over ``weight_steps`` iterations)
at the episode's iteration, 1 to ``episode_steps``: the start of a run,
where the depth term weighs most. Every step is one graph of the
program's depth key.

The targets stand in for aligned monocular maps (Depth Anything V2's,
which the repository does not hold): per pose a smooth field in
[1/far, 1/near] of the box's depth range, the sum of ``components``
seeded plane waves of at most ``max_cycles`` cycles across the image,
rescaled to that range, made on the device from a generator of its own.

The check adds to ``check.train_numbers``' five the number ``invdepth``:
the largest gap of the first step's rendered inverse depth against the
reference's (``reference/depth.py``), over the reference image's largest
value. The traced steps report, beside the base loop's work, the depth
variant of B4's counted work (``work/depth.py``) and its launches per
step (the program's counter ``composite_backward.launches_depth``).

A program without depth regularization cannot run the cell: the loop
raises at once, before any state is made.
"""

from __future__ import annotations

import math

import torch

from gsbench import camera, check, scene
from gsbench.loops import train
from gsbench.reference import depth as ref_depth
from gsbench.reference import step as ref
from gsbench.work import counts
from gsbench.work import depth as depth_work

LAUNCHES = "depth.bwd_launches_per_step"


def _program_depth():
    """(train.step's DepthTarget, the wrapper that holds the counter of B4's
    depth launches) of the program, or a RuntimeError that says what is
    missing."""
    from rain_tpu_torch.train import compiled, step
    counted = [f for f, attr in getattr(compiled, "COUNTED", ())
               if attr == "launches_depth"]
    if not hasattr(step, "DepthTarget") or not counted:
        raise RuntimeError(
            "this program has no depth regularization (train.step."
            "DepthTarget, B4's depth variant): the cell cannot run")
    return step.DepthTarget, counted[0]


def targets(n_views: int, height: int, width: int, seed: int, device, *,
            near: float, far: float, components: int,
            max_cycles: float) -> torch.Tensor:
    """Smooth target inverse depths [n_views, H, W] in [1/far, 1/near]:
    per view the sum of ``components`` plane waves, each of a seeded
    direction, frequency (up to ``max_cycles`` cycles across the image),
    phase and amplitude, rescaled to the range."""
    gen = scene.generator(seed + 2, device)
    f32 = dict(dtype=torch.float32, device=device)
    shape = (n_views, components)
    theta = torch.rand(shape, generator=gen, **f32) * (2.0 * math.pi)
    cycles = torch.rand(shape, generator=gen, **f32) * max_cycles
    phase = torch.rand(shape, generator=gen, **f32) * (2.0 * math.pi)
    amp = torch.rand(shape, generator=gen, **f32) + 0.5
    y = torch.linspace(0.0, 1.0, height, **f32)[:, None]
    x = torch.linspace(0.0, 1.0, width, **f32)[None, :]
    out = torch.empty((n_views, height, width), **f32)
    for v in range(n_views):
        field = torch.zeros((height, width), **f32)
        for c in range(components):
            u = x * torch.cos(theta[v, c]) + y * torch.sin(theta[v, c])
            field += amp[v, c] * torch.cos(
                2.0 * math.pi * cycles[v, c] * u + phase[v, c])
        lo, hi = field.min(), field.max()
        unit = (field - lo) / torch.clamp(hi - lo, min=1e-6)
        out[v] = 1.0 / far + (1.0 / near - 1.0 / far) * unit
    return out


class Loop(train.Loop):
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, prog):
        self.DepthTarget, self.b4 = _program_depth()
        super().__init__(cfg, traffic, seed, device, prog)
        d = traffic["depth"]
        self.depth_cfg = d
        # w(t) at the episode's iterations 1 .. episode_steps
        self.weights = [ref_depth.depth_weight(
            t, d["weight_init"], d["weight_final"], d["weight_steps"])
            for t in range(1, traffic["episode_steps"] + 1)]
        self.first_inv = None

    def inputs(self) -> None:
        super().inputs()
        cfg, d = self.cfg, self.depth_cfg
        self.depth_targets = targets(
            camera.N_POSES, cfg["height"], cfg["width"], self.seed, self.dev,
            near=d["near"], far=d["far"], components=d["components"],
            max_cycles=d["max_cycles"])
        self.mask = torch.ones((cfg["height"], cfg["width"]),
                               dtype=torch.float32, device=self.dev)

    def _step(self, st, op, i: int):
        if i % self.traffic["episode_steps"] == 0:
            st, op = self.s0, self.prog.adam_init(self.s0)
        k = self.order[i % camera.N_POSES]
        target = self.DepthTarget(
            self.depth_targets[k], self.mask,
            self.weights[i % self.traffic["episode_steps"]])
        out = self.steps.train_step(
            st, op, camera.pick(self.cams, k), self.targets[k], self.bg,
            self.hp["low_pass"], self.hp["xyz_lr"], depth=target, **self.kw)
        if i == 0:
            self.first_inv = out[2].inv_depth
        return out if self.fault is None else self.fault((st, op), out)

    def traced(self, n: int) -> None:
        before = self.b4.launches_depth
        super().traced(n)
        self.launches = (self.b4.launches_depth - before) / n

    # --- after the window ---------------------------------------------
    def check(self) -> tuple[dict, int]:
        rec = self.reference(self.p0)
        numbers = check.train_numbers(
            {**self.checked, "first_grad": self.first_grad}, rec)
        numbers["invdepth"] = inv_gap(self.first_inv, rec["inv_depth"])
        return numbers, self.checked["overflow"]

    def reference(self, p0: dict, loss_fn=ref.training_loss) -> dict:
        """The reference's record of the first steps from ``p0`` (in its
        dtype), with the first step's inverse depth."""
        ref.no_tf32()
        cfg = self.cfg
        p = dict(p0)
        dt = p["xyz"].dtype
        stats = ref.stats_init(cfg["capacity"], dt, self.dev)
        opt = ref.adam_init(p)
        rec = {"loss": [], "instances": []}
        for i in range(self.checked_steps):
            k = self.order[i % camera.N_POSES]
            cam = camera.pick(self.cams, k)
            out = ref_depth.train_step(
                p, stats, opt, cam, self.targets[k], self.bg, self.hp,
                width=cfg["width"], height=cfg["height"],
                sh_degree=cfg["sh_degree"], target=self.depth_targets[k],
                mask=self.mask, weight=self.weights[i], loss_fn=loss_fn)
            rec["loss"].append(out.loss)
            rec["instances"].append(out.instances)
            if i == 0:
                rec["first_grad"] = {
                    k: check.norm(v) / (1.0 - ref.BETA1)
                    for k, v in out.opt["mu"].items()}
                rec["inv_depth"] = out.inv_depth.float()
            p, stats, opt = out.params, out.stats, out.opt
        rec["change"] = {k: check.diff_norm(p[k], p0[k]) for k in ref.LEAVES}
        rec["stats"] = {k: check.norm(v) for k, v in stats.items()}
        return rec

    def work(self) -> list:
        """Per traced step: the whole step's work (``work/depth.py``), B3's
        and the depth variant of B4's, from the reference's counts of the
        step's input state and pose, and B4's depth launches per step."""
        out = []
        cfg = self.cfg
        for params, k in self.inputs:
            fr = ref.render(params, camera.pick(self.cams, k), self.bg,
                            width=cfg["width"], height=cfg["height"],
                            sh_degree=cfg["sh_degree"],
                            low_pass=self.hp["low_pass"])
            s = train.shape(cfg, fr)
            out.append((depth_work.train_step(s),
                        {"composite_fwd": counts.composite_fwd(s, False),
                         "composite_bwd_depth": depth_work.composite_bwd(s),
                         LAUNCHES: self.launches}))
        self.inputs = []
        return out


def inv_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """max |prog - want| over max |want|, in float64."""
    d = torch.max(torch.abs(prog.double() - want.double()))
    return float(d / torch.clamp(torch.max(torch.abs(want.double())),
                                 min=1e-30))
