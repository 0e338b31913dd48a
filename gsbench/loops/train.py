"""Training traffic: a closed loop of ``CompiledStep.train_step``.

One call per iteration, each on the next pose of the pan in an order
drawn from the seed, with that pose's seeded target image. The loop runs
in episodes of ``episode_steps`` iterations from the configuration's
state and fresh Adam moments, so every seed trains the same sizes over
the run (the state does not drift with the window's length). Nothing
waits for the device inside the window: the host queues steps until the
window's time is up, and one synchronise ends it.

Set-up makes the state, runs the first ``CHECKED`` steps through the
window's own call (the first captures the key's graph) and keeps what
``check`` compares of them, then warms up to ``warm_steps``. ``check``,
after the window, runs the plain reference over the same first steps.
"""

from __future__ import annotations

import random
import time

import torch

from gsbench import camera, check, scene
from gsbench.reference import step as ref
from gsbench.work import counts

SPAN = "gsbench.train_step"
CHECKED = 3


class Loop:
    kind = "train"
    metrics = {"train_ms_per_iter": "ms"}
    checked_steps = CHECKED   # the first steps that the check compares

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, prog):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.prog = device, prog
        self.order = random.Random(seed).sample(range(camera.N_POSES),
                                                camera.N_POSES)
        hp = traffic["hyper"]
        self.hp = {"low_pass": hp["low_pass"], "xyz_lr": hp["xyz_lr"],
                   "opt_leaves": hp["opt_leaves"],
                   "lambda_dssim": hp["lambda_dssim"]}
        self.kw = dict(width=cfg["width"], height=cfg["height"],
                       sh_degree=cfg["sh_degree"],
                       max_instances=cfg["max_instances"],
                       opt_cfg_leaves=hp["opt_leaves"],
                       lambda_dssim=hp["lambda_dssim"],
                       update_densify_stats=hp["update_densify_stats"])
        # tests plant a fault here: (inputs (state, opt), the step's
        # (state, opt, aux)) -> what the step returns instead
        self.fault = None

    # --- set-up -------------------------------------------------------
    def inputs(self) -> None:
        """The seed's scene (``p0``), targets, poses and background: what
        the program and the reference are both given."""
        cfg, dev = self.cfg, self.dev
        self.p0 = scene.make_params(cfg, self.seed, dev)
        self.targets = scene.make_targets(camera.N_POSES, cfg["height"],
                                          cfg["width"], self.seed, dev)
        self.cams = camera.stack([camera.pan_pose(k)
                                  for k in range(camera.N_POSES)], dev)
        self.bg = torch.tensor(self.traffic["background"],
                               dtype=torch.float32, device=dev)

    def start_state(self):
        """The program's state at the start of every episode."""
        return self.prog.state(self.p0)

    def setup(self, mark) -> None:
        dev = self.dev
        self.inputs()
        self.s0 = self.start_state()
        self.steps = self.prog.compiled_step()
        _sync(dev)
        mark("state")
        st, op = self.s0, self.prog.adam_init(self.s0)
        seen = []
        for i in range(self.checked_steps):
            st, op, aux = self._step(st, op, i)
            seen.append((float(aux.loss), int(aux.num_instances),
                         bool(aux.instance_overflow)))
            if i == 0:
                self.first_grad = {
                    k: check.norm(v) / (1.0 - self.prog.BETA1)
                    for k, v in self.prog.first_moments(op).items()}
        params = self.prog.params_of(st)
        self.checked = {
            "loss": [s[0] for s in seen], "instances": [s[1] for s in seen],
            "overflow": sum(s[2] for s in seen),
            "change": {k: check.diff_norm(params[k], self.p0[k])
                       for k in params},
            "stats": {k: check.norm(v)
                      for k, v in self.prog.stats_of(st).items()}}
        del params
        mark("first_steps")
        self.i = self.checked_steps
        self.cur = (st, op)
        for _ in range(self.traffic["warm_steps"] - self.checked_steps):
            self._advance()
        _sync(dev)
        mark("warm")

    def _step(self, st, op, i: int):
        if i % self.traffic["episode_steps"] == 0:
            st, op = self.s0, self.prog.adam_init(self.s0)
        k = self.order[i % camera.N_POSES]
        out = self.steps.train_step(
            st, op, camera.pick(self.cams, k), self.targets[k], self.bg,
            self.hp["low_pass"], self.hp["xyz_lr"], **self.kw)
        return out if self.fault is None else self.fault((st, op), out)

    def _advance(self):
        """One step of the loop from the current state; its aux."""
        st, op, aux = self._step(*self.cur, self.i)
        self.cur = (st, op)
        self.i += 1
        return aux

    # --- the window ---------------------------------------------------
    def window(self, seconds: float) -> tuple[dict, int, int]:
        kept = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            aux = self._advance()
            kept.append((aux.loss, aux.instance_overflow,
                         aux.num_instances))
        _sync(self.dev)
        dt = time.perf_counter() - t0
        n = len(kept)
        return ({"train_ms_per_iter": dt / n * 1e3}, n,
                self._failed(kept))

    def traced(self, n: int) -> None:
        """``n`` steps, each inside a span; keeps each step's input
        parameters and pose for ``work``. Nothing is read back here:
        ``outcome`` reads the steps after the traced window."""
        self.kept, self.inputs = [], []
        for _ in range(n):
            self.inputs.append((self.prog.params_of(self.cur[0]),
                                self.order[self.i % camera.N_POSES]))
            with torch.profiler.record_function(SPAN):
                aux = self._advance()
            self.kept.append((aux.loss, aux.instance_overflow,
                              aux.num_instances))

    def outcome(self) -> tuple[int, int]:
        """(attempted, failed) of the traced steps."""
        return len(self.kept), self._failed(self.kept)

    def _failed(self, kept) -> int:
        """The steps that overflowed the tier or gave a non-finite loss;
        notes the range of the steps' instance counts."""
        loss = torch.stack([k[0] for k in kept])
        bad = torch.stack([k[1] for k in kept]) | ~torch.isfinite(loss)
        inst = torch.stack([k[2] for k in kept])
        self.instances = [int(inst.min()), int(inst.max())]
        return int(bad.sum())

    def release(self) -> None:
        """Drop the program's state and graphs."""
        self.steps = self.cur = self.s0 = None

    # --- after the window ---------------------------------------------
    def check(self) -> tuple[dict, int]:
        """(the gaps of the first steps against the reference, the
        program's overflowed steps among them)."""
        numbers = check.train_numbers(
            {**self.checked, "first_grad": self.first_grad},
            self.reference(self.p0))
        return numbers, self.checked["overflow"]

    def reference(self, p0: dict, loss_fn=ref.training_loss) -> dict:
        """The reference's record of the first steps from ``p0`` (its
        dtype is the reference's: float32, or bfloat16 for the control)."""
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
            out = ref.train_step(p, stats, opt, cam, self.targets[k],
                                 self.bg, self.hp, width=cfg["width"],
                                 height=cfg["height"],
                                 sh_degree=cfg["sh_degree"], loss_fn=loss_fn)
            rec["loss"].append(out.loss)
            rec["instances"].append(self.ref_instances(p, cam, out))
            if i == 0:
                rec["first_grad"] = {
                    k: check.norm(v) / (1.0 - ref.BETA1)
                    for k, v in out.opt["mu"].items()}
            p, stats, opt = out.params, out.stats, out.opt
        rec["change"] = {k: check.diff_norm(p[k], p0[k]) for k in ref.LEAVES}
        rec["stats"] = {k: check.norm(v) for k, v in stats.items()}
        return rec

    def ref_instances(self, params: dict, cam: dict, out) -> int:
        """The reference's count of the step from ``params`` at ``cam``
        that the program's ``num_instances`` is compared with."""
        return out.instances

    def work(self) -> list[tuple[counts.Work, dict]]:
        """Per traced step: the whole step's work and each kernel's, from
        the reference's counts of the step's input state and pose."""
        out = []
        cfg = self.cfg
        for params, k in self.inputs:
            fr = ref.render(params, camera.pick(self.cams, k), self.bg,
                            width=cfg["width"], height=cfg["height"],
                            sh_degree=cfg["sh_degree"],
                            low_pass=self.hp["low_pass"])
            s = shape(cfg, fr)
            out.append((counts.train_step(s),
                        {"composite_fwd": counts.composite_fwd(s, False),
                         "composite_bwd": counts.composite_bwd(s)}))
        self.inputs = []
        return out


def shape(cfg: dict, fr: ref.Frame) -> counts.Shape:
    gx = (cfg["width"] + 15) // 16
    gy = (cfg["height"] + 15) // 16
    k = (cfg["sh_degree"] + 1) ** 2
    return counts.Shape(
        gaussians=cfg["capacity"], params=3 + 3 * k + 3 + 4 + 1,
        instances=min(fr.instances, cfg["max_instances"]), tiles=gx * gy,
        pixels=cfg["width"] * cfg["height"],
        composited=fr.counts.composited)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
