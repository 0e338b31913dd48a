"""Viewing traffic: a closed loop of ``CompiledStep.eval_render``.

One viewer, one frame at a time: each frame is launched, waited for and
timed from its launch to its synchronise; the next follows at once. The
camera follows a closed, smooth path of ``path_frames`` frames inside the
pan's range, started at a phase drawn from the seed. The state is the
configuration's, unchanged by the traffic.

``check`` compares a sample of the window's frames, drawn from the seed
(reservoir sampling over all frames of the window), with the plain
reference's render of the same view: the image and the instance count.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from gsbench import camera, check, scene
from gsbench.loops.train import shape
from gsbench.reference import step as ref
from gsbench.work import counts

SPAN = "gsbench.eval_render"


class Loop:
    kind = "render"
    metrics = {"render_fps": "frames/s", "render_ms_p95": "ms"}

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, prog):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.prog = device, prog
        self.rng = random.Random(seed)
        self.phases = (self.rng.uniform(0.0, 2.0 * math.pi),
                       self.rng.uniform(0.0, 2.0 * math.pi))
        self.start = self.rng.randrange(traffic["path_frames"])
        self.low_pass = traffic["low_pass"]
        self.kw = dict(width=cfg["width"], height=cfg["height"],
                       sh_degree=cfg["sh_degree"],
                       max_instances=cfg["max_instances"])
        # tests plant a fault here: (frame index, the frame's output) ->
        # what the call returns instead
        self.fault = None

    def setup(self, mark) -> None:
        cfg, dev = self.cfg, self.dev
        self.p0 = scene.make_params(cfg, self.seed, dev)
        n = self.traffic["path_frames"]
        self.cams = camera.stack(
            [camera.path_pose(i, n, self.phases) for i in range(n)], dev)
        self.bg = torch.tensor(self.traffic["background"],
                               dtype=torch.float32, device=dev)
        self.s0 = self.prog.state(self.p0)
        self.steps = self.prog.compiled_step()
        _sync(dev)
        mark("state")
        self.i = 0
        for _ in range(self.traffic["warm_frames"]):
            self._frame()
        _sync(dev)
        mark("warm")
        self.sample = []      # (frame index, image, instances)
        self.seen = 0

    def _view(self, i: int) -> int:
        return (self.start + i) % self.traffic["path_frames"]

    def _frame(self):
        out = self.steps.eval_render(
            self.s0, camera.pick(self.cams, self._view(self.i)), self.bg,
            self.low_pass, 1.0, **self.kw)
        if self.fault is not None:
            out = self.fault(self.i, out)
        self.i += 1
        return out

    def _keep(self, out) -> None:
        """Reservoir sampling of ``sample_frames`` frames over the
        window, drawn from the seed."""
        self.seen += 1
        k = self.traffic["sample_frames"]
        entry = (self.i - 1, out.render, out.num_instances)
        if len(self.sample) < k:
            self.sample.append(entry)
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.sample[j] = entry

    def window(self, seconds: float) -> tuple[dict, int, int]:
        lat = []
        bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            t = time.perf_counter()
            out = self._frame()
            _sync(self.dev)
            lat.append(time.perf_counter() - t)
            bad += ~torch.isfinite(out.render).all() | out.overflow
            self._keep(out)
        _sync(self.dev)
        dt = time.perf_counter() - t0
        return ({"render_fps": len(lat) / dt,
                 "render_ms_p95": float(np.percentile(lat, 95)) * 1e3},
                len(lat), int(bad))

    def traced(self, n: int) -> None:
        """``n`` frames, each inside a span; ``outcome`` reads them after
        the traced window."""
        self.views, self.outs = [], []
        for _ in range(n):
            self.views.append(self._view(self.i))
            with torch.profiler.record_function(SPAN):
                out = self._frame()
                _sync(self.dev)
            self.outs.append(out)
            self._keep(out)

    def outcome(self) -> tuple[int, int]:
        """(attempted, failed) of the traced frames."""
        bad = sum(int(~torch.isfinite(o.render).all() | o.overflow)
                  for o in self.outs)
        n, self.outs = len(self.outs), []
        return n, bad

    def release(self) -> None:
        self.steps = self.s0 = None

    def check(self) -> tuple[dict, int]:
        frames = self.reference(self.p0, [i for i, _, _ in self.sample])
        image = max(float(torch.max(torch.abs(img - fr.image)))
                    for (_, img, _), fr in zip(self.sample, frames))
        numbers = {"image": image,
                   "instances": check.rel_gap(
                       [int(m) for _, _, m in self.sample],
                       [fr.instances for fr in frames])}
        return numbers, 0

    def reference(self, p0: dict, frames: list[int]) -> list[ref.Frame]:
        ref.no_tf32()
        cfg = self.cfg
        return [ref.render(p0, camera.pick(self.cams, self._view(i)),
                           self.bg, width=cfg["width"], height=cfg["height"],
                           sh_degree=cfg["sh_degree"],
                           low_pass=self.low_pass) for i in frames]

    def work(self) -> list[tuple[counts.Work, dict]]:
        out = []
        for v in self.views:
            fr = ref.render(self.p0, camera.pick(self.cams, v), self.bg,
                            width=self.cfg["width"],
                            height=self.cfg["height"],
                            sh_degree=self.cfg["sh_degree"],
                            low_pass=self.low_pass)
            s = shape(self.cfg, fr)
            out.append((counts.frame(s),
                        {"composite_fwd": counts.composite_fwd(s, True)}))
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
