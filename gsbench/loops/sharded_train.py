"""Training traffic over several cards: the closed loop of ``loops.train``
with every step ``CompiledStep.sharded_train_step`` on every rank.

One instance runs in each rank's process (``gsbench.ranks``), on that
rank's card. Each rank makes the whole scene, the targets and the poses
from the seed on its card, as the one-card loop does, and keeps its shard
of the state (rows rank·C/D to (rank+1)·C/D) with fresh Adam moments;
the step renders band ``rank`` of the image's tile rows from every rank's
Gaussians. The mix is ``train_pan``'s: the pan's poses in the seed's
order, episodes of ``episode_steps`` from the configuration's state, the
first ``checked_steps`` steps through the window's own call, warm-up to
``warm_steps``. The check compares two steps, not three: the reference
over the whole scene takes some 7 s a step on one card, and every run
pays for it.

The ranks agree on one step count, as a rank that stopped alone would
hang the others in a collective: after the warm-up (in the set-up) each
rank times ``PROBE_STEPS`` steps ended by a synchronise, the ranks take
the largest time ``t``, and the window runs ``ceil(seconds / t)`` steps
on every rank with no synchronise inside, then one synchronise and an
all-reduce of each rank's window time (a barrier): ``train_ms_per_iter``
is the largest rank's time over the steps.

The check: each rank reports its shard's norms of the first gradient, of
the change after the checked steps and of the statistics, and the
step's loss and instance count (all-reduced by the step: the whole
image's loss, the fullest band's count). The norms of the whole state
are the root of the sum of the shards' squares. The reference runs
after the ranks have ended, on one card, over the whole scene, and
counts the fullest band's instances with ``reference.bands``.
"""

from __future__ import annotations

import math
import time

import torch

from gsbench import camera, check
from gsbench.loops import train
from gsbench.reference import bands
from gsbench.reference.preprocess import screen

PROBE_STEPS = 5


class Loop(train.Loop):
    """``loops.train.Loop`` on this rank's shard of ``world``; ``prog``
    None in the process that runs the reference."""
    checked_steps = 2

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, prog, *, world: int):
        super().__init__(cfg, traffic, seed, device, prog)
        self.world = world
        self.kw = dict(width=cfg["width"], height=cfg["height"],
                       sh_degree=cfg["sh_degree"],
                       max_instances_per_shard=cfg["max_instances"],
                       lambda_dssim=self.hp["lambda_dssim"],
                       update_densify_stats=traffic["hyper"][
                           "update_densify_stats"])

    # --- set-up, on each rank -----------------------------------------
    def start_state(self):
        """This rank's shard of the scene; the whole scene is dropped and
        ``p0`` becomes the shard's parameters (the change is the shard's)."""
        st = self.prog.shard(self.prog.state(self.p0))
        self.p0 = self.prog.params_of(st)
        return st

    def setup(self, mark) -> None:
        super().setup(mark)
        t0 = time.perf_counter()
        for _ in range(PROBE_STEPS):
            self._advance()
        train._sync(self.dev)
        self.step_s = self.prog.max_over_ranks(
            (time.perf_counter() - t0) / PROBE_STEPS, self.dev)
        mark("probe")

    def _step(self, st, op, i: int):
        if i % self.traffic["episode_steps"] == 0:
            st, op = self.s0, self.prog.adam_init(self.s0)
        k = self.order[i % camera.N_POSES]
        out = self.steps.sharded_train_step(
            st, op, camera.pick(self.cams, k), self.targets[k], self.bg,
            self.hp["low_pass"], self.hp["xyz_lr"], self.hp["opt_leaves"],
            **self.kw)
        return out if self.fault is None else self.fault((st, op), out)

    # --- the window ---------------------------------------------------
    def window(self, seconds: float) -> tuple[dict, int, int]:
        n = max(1, math.ceil(seconds / self.step_s))
        kept = []
        t0 = time.perf_counter()
        for _ in range(n):
            aux = self._advance()
            kept.append((aux.loss, aux.instance_overflow,
                         aux.num_instances))
        train._sync(self.dev)
        dt = self.prog.max_over_ranks(time.perf_counter() - t0, self.dev)
        return {"train_ms_per_iter": dt / n * 1e3}, n, self._failed(kept)

    def traced(self, n: int) -> None:
        """``n`` steps, each inside the loop's span."""
        self.kept = []
        for _ in range(n):
            with torch.profiler.record_function(train.SPAN):
                aux = self._advance()
            self.kept.append((aux.loss, aux.instance_overflow,
                              aux.num_instances))

    def work(self) -> list:
        """None counted: the counts of ``work/`` are of a whole image."""
        return []

    def stage_ms(self) -> dict:
        """{stage: device ms} of the last replay (one read, after the
        window)."""
        return self.steps.stage_ms(self.steps.last_step_key)

    def release(self) -> None:
        """Drop the graphs before the group goes (CompiledStep.clear)."""
        if self.steps is not None:
            self.steps.clear()
        super().release()

    def shard_check(self) -> dict:
        """This rank's part of the check: plain numbers."""
        return {**self.checked, "first_grad": self.first_grad}

    # --- after the ranks, on one card ---------------------------------
    def check_shards(self, parts: list[dict]) -> tuple[dict, int]:
        """(the gaps of the ranks' first steps against the reference over
        the whole scene, the overflowed steps among them)."""
        self.inputs()
        return (check.train_numbers(whole(parts), self.reference(self.p0)),
                max(p["overflow"] for p in parts))

    def ref_instances(self, params: dict, cam: dict, out) -> int:
        """The fullest band's count, from the reference's screen."""
        cfg = self.cfg
        with torch.no_grad():
            s = screen(params, cam, width=cfg["width"],
                       height=cfg["height"], sh_degree=cfg["sh_degree"],
                       low_pass=self.hp["low_pass"])
        return bands.fullest(s, cfg["height"], self.world)


def whole(parts: list[dict]) -> dict:
    """The program's record of the whole scene from the ranks' parts: the
    loss and the instance count as every rank has them (rank 0's), each
    norm the root of the sum of the shards' squares."""
    rec = {"loss": parts[0]["loss"], "instances": parts[0]["instances"]}
    for key in ("first_grad", "change", "stats"):
        rec[key] = {k: math.sqrt(sum(p[key][k] ** 2 for p in parts))
                    for k in parts[0][key]}
    return rec
