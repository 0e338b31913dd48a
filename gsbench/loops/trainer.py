"""Trainer traffic: episodes of ``Trainer.train`` over a slice of a
densifying run.

Each episode is ``Trainer.train`` from iteration ``first_iteration`` to
``last_iteration`` of the configuration's run, started in memory from one
state (``start=(state, fresh moments, first_iteration, low_pass)``), so
the Trainer reseeds its camera order and its split noise and every
episode does the same work: the steps on the pan's poses in the
Trainer's own order, each with its seeded target, the densify rounds,
the opacity reset, the one-step-late verification and the log's flush
every ``log_every`` iterations, all as the train CLI runs them.

Set-up draws the configuration's points and colours from the seed (as
``scene.make_params`` draws them) and a dead-leaves target per pose
(``dead_leaves``), makes the pan's cameras with their targets and the
Trainer on that scene (its ``create_from_pcd`` makes the start state:
KNN scales, opacity 0.1; the scene's extent is ``nerfpp_norm`` over the
ring of cameras of ``ring``), then runs one whole episode, which
captures every key (the step, each round's key, the reset), with the
CompiledStep's calls recorded for the check, and a second to warm. The
window runs whole episodes until ``seconds`` have passed and ends with
one synchronise; ``failed`` counts the rollbacks of overflowed steps, the
captures and the capacity growths inside it. ``--trace 1`` traces one
episode.

The check, after the window, holds the start state to ``scene``'s plain
construction from the same points, then runs the plain reference
(``reference/``) over what the set-up episode recorded: the first
``CHECKED`` steps from the start state at the reference schedule's
values, each round from the program's own state before it with the
program's noise, and the reset from the program's opacity before it.
"""

from __future__ import annotations

import math
import statistics
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from gsbench import camera, check, scene
from gsbench.scene import SH_C0
from gsbench.reference import densify as ref_densify
from gsbench.reference import schedules as ref_sched
from gsbench.reference import step as ref
from gsbench.work import rounds

SPAN = "gsbench.trainer_episode"
CHECKED = 3
COUNTS = ("n_alive", "abe", "clones", "splits", "pruned")
LEAVES_BLOCK = 32       # discs per block of the dead-leaves painting


def points(cfg: dict, seed: int, dev) -> tuple:
    """The configuration's points and colours: ``scene.make_params``'s
    first two draws from the seed's generator."""
    n = cfg["n_gaussians"]
    gen = scene.generator(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lo, hi = cfg["box"]["xy"]
    z0, z1 = cfg["box"]["z"]
    xyz = torch.rand((n, 3), generator=gen, **f32)
    xyz[:, :2] = xyz[:, :2] * (hi - lo) + lo
    xyz[:, 2] = xyz[:, 2] * (z1 - z0) + z0
    rgb = torch.rand((n, 3), generator=gen, **f32)
    return xyz, rgb


def dead_leaves(n_views: int, height: int, width: int, seed: int, device,
                *, coverage: float, r_min: float, r_max: float
                ) -> torch.Tensor:
    """Dead-leaves target images [n_views, 3, H, W] (Lee, Mumford & Huang,
    "Occlusion models for natural images", 2001), from a generator of
    their own: opaque discs of one uniform colour each, dropped one on
    another, their radii of density ∝ r^-3 on [``r_min``, ``r_max``]
    pixels (scale-invariant, as natural images' edges are), their centres
    uniform over the image, as many as cover it ``coverage`` times on
    average, over a uniform background colour."""
    gen = scene.generator(seed + 1, device)
    f32 = dict(dtype=torch.float32, device=device)
    a2, b2 = r_min ** -2.0, r_max ** -2.0
    mean_r2 = 2.0 * math.log(r_max / r_min) / (a2 - b2)
    n = max(1, round(coverage * height * width / (math.pi * mean_r2)))
    ys = torch.arange(height, **f32)[:, None] + 0.5
    xs = torch.arange(width, **f32)[None, :] + 0.5
    size = torch.tensor([width, height], **f32)
    images = []
    for _ in range(n_views):
        centre = torch.rand((n, 2), generator=gen, **f32) * size
        # the inverse of the radii's distribution function
        u = torch.rand(n, generator=gen, **f32)
        r2 = 1.0 / (a2 - u * (a2 - b2))
        colour = torch.rand((n + 1, 3), generator=gen, **f32)
        top = torch.full((height, width), n, dtype=torch.long,
                         device=device)           # n: the background
        for i in range(0, n, LEAVES_BLOCK):
            c, rr = centre[i:i + LEAVES_BLOCK], r2[i:i + LEAVES_BLOCK]
            d2 = (xs - c[:, 0, None, None]) ** 2 + \
                (ys - c[:, 1, None, None]) ** 2
            idx = torch.arange(i, i + rr.shape[0], device=device)
            hit = torch.where(d2 <= rr[:, None, None], idx[:, None, None],
                              -1).amax(0)
            # a later disc lies on the ones before it
            top = torch.where(hit >= 0, hit, top)
        images.append(colour[top].permute(2, 0, 1))
    return torch.stack(images).contiguous()


def ring(cfg: dict) -> list[tuple[float, np.ndarray]]:
    """The scene's ring of ``cfg["extent_ring"]`` cameras, as Mip-NeRF
    360's captures circle their scene: (yaw, centre) of cameras evenly
    spaced on the circle about the box's centre through the world origin
    (the pan's middle camera), each facing the box's centre."""
    z = 0.5 * (cfg["box"]["z"][0] + cfg["box"]["z"][1])
    out = []
    for k in range(cfg["extent_ring"]):
        yaw = 2.0 * math.pi * k / cfg["extent_ring"]
        out.append((yaw, np.array([-z * math.sin(yaw), 0.0,
                                   z - z * math.cos(yaw)])))
    return out


def _no_abe(name, call):
    if name != "densify_and_prune":
        return call
    return lambda *a, **kw: call(*a, **{**kw, "abe_split": False})


def _other_noise(name, call):
    if name != "densify_and_prune":
        return call

    def run(state, opt, noise, **kw):
        gen = torch.Generator(device=noise.device).manual_seed(7)
        return call(state, opt, torch.randn(noise.shape, generator=gen,
                                            device=noise.device), **kw)
    return run


def _size_off(name, call):
    if name != "densify_and_prune":
        return call
    return lambda *a, **kw: call(*a, **{**kw, "use_size_threshold": False})


def _no_reset(name, call):
    if name != "reset_opacity":
        return call
    return lambda state, opt, **kw: (state, opt)


def _colours_not_sh(name, state):
    if name != "start":
        return state
    n = state.n_alive
    dc = state.params.features_dc.clone()
    dc[:n] = dc[:n] * SH_C0 + 0.5
    return state._replace(params=state.params._replace(features_dc=dc))


# the faults a Trainer cell can have, planted in the program (``Loop.
# fault``): fault(name, x) -> x', with ``name`` a CompiledStep method the
# Trainer calls and ``x`` that bound method, or "start" and the start
# state; each leaves what it does not name as it was. The abe_split
# pre-pass left out, another seed's split noise, the size threshold left
# out, the opacity reset skipped, the start's colours left as RGB
FAULTS = {"no abe pre-pass": _no_abe, "another seed's noise": _other_noise,
          "size threshold off": _size_off, "reset skipped": _no_reset,
          "colours not in SH": _colours_not_sh}


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


class Record:
    """What the set-up episode's calls into the CompiledStep produced: the
    first steps' numbers, each round's state before and after it (on the
    host), the reset's opacity before it and norms after it."""

    def __init__(self, loop):
        self.loop = loop
        self.steps, self.rounds, self.resets = [], [], []

    def wrap(self, name: str, call):
        return getattr(self, name)(call)

    def train_step(self, call):
        def run(state, opt, cam, gt, bg, low_pass, xyz_lr, **kw):
            out = call(state, opt, cam, gt, bg, low_pass, xyz_lr, **kw)
            i = len(self.steps)
            if i < CHECKED:
                self.steps.append(self.loop.step_numbers(i, cam, gt, bg,
                                                         out))
            return out
        return run

    def densify_and_prune(self, call):
        def run(state, opt, noise, **kw):
            n0 = state.n_alive
            before = {
                "iteration": self.loop.tr.iteration,
                "params": {k: _host(v[:n0]) for k, v in
                           self.loop.prog.params_of(state).items()},
                "stats": {k: _host(v[:n0]) for k, v in
                          self.loop.prog.stats_of(state).items()},
                "moments": {k: _host(v[:n0]) for k, v in
                            self.loop.tp.moments_of(opt).items()},
                "noise": _host(noise[:, :n0])}
            new, new_opt, info = call(state, opt, noise, **kw)
            n = info.n_alive
            after = {**{k: _host(v[:n]) for k, v in
                        self.loop.prog.params_of(new).items()},
                     **{k: _host(v[:n]) for k, v in
                        self.loop.tp.moments_of(new_opt).items()}}
            counts = {"n_alive": n, "clones": info.n_cloned,
                      "splits": info.n_split, "pruned": info.n_pruned,
                      "abe": n + info.n_pruned - n0 - info.n_cloned -
                      kw.get("n_split", 2) * info.n_split}
            self.rounds.append({**before, "after": after, "counts": counts,
                                "overflow": info.overflow})
            return new, new_opt, info
        return run

    def reset_opacity(self, call):
        def run(state, opt, **kw):
            n = state.n_alive

            def norms(st, op):
                return {"opacity": check.norm(st.params.opacity[:n]),
                        "mu.opacity": check.norm(op.mu.opacity[:n]),
                        "nu.opacity": check.norm(op.nu.opacity[:n])}
            before = _host(state.params.opacity[:n])
            new, new_opt = call(state, opt, **kw)
            self.resets.append({"iteration": self.loop.tr.iteration,
                                "opacity": before,
                                "after": norms(new, new_opt)})
            return new, new_opt
        return run


class Loop:
    kind = "trainer"
    metrics = {"train_ms_per_iter": "ms"}

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, prog=None):
        from gsbench import program, trainer_program
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = device
        self.prog = prog or program
        self.tp = trainer_program
        self.first = traffic["first_iteration"]
        self.last = traffic["last_iteration"]
        self.per_episode = self.last - self.first
        # tests and calibration plant one of FAULTS here
        self.fault = None
        self.steps = self.tr = None

    # --- set-up -------------------------------------------------------
    def inputs(self) -> None:
        """The seed's points, colours, targets and cameras, and the
        Trainer's scene of them."""
        cfg, dev = self.cfg, self.dev
        xyz, rgb = points(cfg, self.seed, dev)
        t = self.traffic["targets"]
        self.targets = dead_leaves(
            camera.N_POSES, cfg["height"], cfg["width"], self.seed, dev,
            coverage=t["coverage"], r_min=t["r_min_px"],
            r_max=t["r_max_of_width"] * cfg["width"])
        half = camera.N_POSES // 2
        cams = [self.tp.pan_camera(
            k, 0.04 * (k - half), 0.15 * (k - half),
            self.targets[k].cpu().numpy(), camera.FOVX, camera.FOVY)
            for k in range(camera.N_POSES)]
        ring_cams = [self.tp.ring_camera(k, yaw, centre, camera.FOVX,
                                         camera.FOVY)
                     for k, (yaw, centre) in enumerate(ring(cfg))]
        self.scene = self.tp.scene(xyz.cpu().numpy(), rgb.cpu().numpy(),
                                   cams, ring_cams)

    def configs(self) -> dict:
        cfg = dict(self.cfg)
        cfg["system"] = {**cfg["system"], "capacity": cfg["capacity"],
                         "max_instances": cfg["max_instances"]}
        return self.tp.configs(cfg)

    def setup(self, mark) -> None:
        self.inputs()
        mark("scene")
        self.dir = tempfile.TemporaryDirectory(prefix="gsbench_trainer_")
        self.tr = self.tp.trainer(self.scene, self.configs(), self.dir.name,
                                  self.dev)
        self.steps = self.tr._steps
        self.s0 = self.tr.state
        if self.fault is not None:
            self.s0 = self.fault("start", self.s0)
        n = self.s0.n_alive
        self.p0 = {k: v[:n] for k, v in self.prog.params_of(self.s0).items()}
        self.low_pass0 = self.tp.low_pass_at(
            self.tr, self.first, n, self.cfg["width"], self.cfg["height"])
        _sync(self.dev)
        mark("trainer")
        self.record = Record(self)
        self._install(self.record)
        self.episode()
        self._install(None)
        _sync(self.dev)
        mark("first_episode")
        for _ in range(self.traffic["warm_episodes"]):
            self.episode()
        _sync(self.dev)
        mark("warm")

    def _install(self, record) -> None:
        """The Trainer's CompiledStep calls, with the planted fault and,
        given a ``record``, recorded."""
        for name in self.tp.METHODS:
            self.steps.__dict__.pop(name, None)
            call = getattr(self.steps, name)
            if self.fault is not None:
                call = self.fault(name, call)
            if record is not None:
                call = record.wrap(name, call)
            if self.fault is not None or record is not None:
                setattr(self.steps, name, call)

    def episode(self) -> None:
        self.tr.train(self.last, start=(
            self.s0, self.prog.adam_init(self.s0), self.first,
            self.low_pass0))

    def step_numbers(self, i: int, cam: dict, gt, bg, out) -> dict:
        """What the check keeps of step ``i`` of the set-up episode."""
        st, op, aux = out
        n = self.s0.n_alive
        rec = {"camera": cam, "gt": gt, "bg": bg, "loss": float(aux.loss),
               "instances": int(aux.num_instances),
               "overflow": bool(aux.instance_overflow)}
        if i == 0:
            rec["first_grad"] = {
                k: check.norm(v[:n]) / (1.0 - ref.BETA1)
                for k, v in op.mu._asdict().items()}
        if i == CHECKED - 1:
            params = self.prog.params_of(st)
            rec["change"] = {k: check.diff_norm(params[k][:n], self.p0[k])
                             for k in params}
            rec["stats"] = {k: check.norm(v[:n])
                            for k, v in self.prog.stats_of(st).items()}
        return rec

    # --- the window ---------------------------------------------------
    def _counts(self) -> tuple:
        return len(self.steps.captures), self.tr.counters()

    def _failed(self, before) -> int:
        captures, k = before
        now = self.tr.counters()
        return (len(self.steps.captures) - captures +
                now["refires"] - k["refires"] +
                now["capacity_grows"] - k["capacity_grows"])

    def window(self, seconds: float) -> tuple[dict, int, int]:
        before = self._counts()
        t0 = time.perf_counter()
        end = t0 + seconds
        n = 0
        while time.perf_counter() < end:
            self.episode()
            n += self.per_episode
        _sync(self.dev)
        dt = time.perf_counter() - t0
        return {"train_ms_per_iter": dt / n * 1e3}, n, self._failed(before)

    def traced(self, n: int) -> None:
        """``n`` episodes, each inside a span; keeps the Trainer's counters
        over them for ``work``."""
        before = self._counts()
        for _ in range(n):
            with record_function(SPAN):
                self.episode()
        self.traced_iterations = n * self.per_episode
        self.traced_failed = self._failed(before)
        now = self.tr.counters()
        self.traced_counters = {k: now[k] - before[1][k] for k in now}
        self.capacity = self.tr.state.capacity

    def outcome(self) -> tuple[int, int]:
        return self.traced_iterations, self.traced_failed

    def release(self) -> None:
        """Drop the Trainer, its state and its graphs."""
        self.steps = self.tr = self.s0 = None
        self.dir.cleanup()

    # --- after the window ---------------------------------------------
    def extent(self) -> float:
        return ref_sched.scene_extent([c for _, c in ring(self.cfg)])

    def rain(self) -> dict:
        return ref_sched.preset(self.cfg["rain"])

    def hyper(self, iteration: int, n: int) -> dict:
        """The reference schedule's step values at ``iteration`` of a run
        whose filter was last recomputed with ``n`` Gaussians."""
        opt, rain = self.cfg["opt"], self.rain()
        return {"low_pass": ref_sched.low_pass(
                    self.cfg["height"], self.cfg["width"], n,
                    rain["c2f_max_lowpass"]) if rain["c2f"] else 0.3,
                "xyz_lr": ref_sched.xyz_lr(
                    iteration, opt, self.extent(),
                    ours_new=rain["ours_new"],
                    warmup_iter=rain["warmup_iter"]),
                "opt_leaves": {k: opt[k] for k in (
                    "feature_lr", "opacity_lr", "scaling_lr",
                    "rotation_lr")},
                "lambda_dssim": opt["lambda_dssim"],
                "sh_degree": ref_sched.sh_degree(
                    iteration, self.cfg["model"]["sh_degree"],
                    ours=rain["ours"])}

    def check(self) -> tuple[dict, int]:
        """(the gaps of the set-up episode's first steps, rounds and reset
        against the reference, the steps and rounds among them that
        overflowed)."""
        rec = self.record
        numbers = {"start": self.start_gap(self.p0)}
        numbers.update(check.train_numbers(self.program_record(),
                                           self.reference(self.p0)))
        numbers.update(self.round_numbers(self.program_rounds(),
                                          self.reference_rounds()))
        overflowed = sum(s["overflow"] for s in rec.steps) + \
            sum(r["overflow"] for r in rec.rounds)
        return numbers, overflowed

    def plain_start(self, dtype=torch.float32) -> dict:
        """``scene.make_params``'s plain construction of the start from
        the same seed: the points and colours ``points`` draws, their
        3-NN scales, opacity 0.1 (in ``dtype``)."""
        cfg = {**self.cfg, "capacity": self.cfg["n_gaussians"]}
        return {k: v.to(dtype) for k, v in
                scene.make_params(cfg, self.seed, self.dev).items()}

    def start_gap(self, p0: dict, plain: dict | None = None) -> float:
        """``diff_gap`` of ``p0`` to the plain construction."""
        return diff_gap(p0, plain or self.plain_start())

    def program_record(self) -> dict:
        s = self.record.steps
        return {"loss": [x["loss"] for x in s],
                "instances": [x["instances"] for x in s],
                "first_grad": s[0]["first_grad"], "change": s[-1]["change"],
                "stats": s[-1]["stats"]}

    def reference(self, p0: dict, loss_fn=ref.training_loss) -> dict:
        """The reference's record of the first steps from ``p0`` on the
        set-up episode's cameras (float32, or bfloat16 for the control)."""
        ref.no_tf32()
        cfg = self.cfg
        p = {k: v.detach().clone() for k, v in p0.items()}
        dt = p["xyz"].dtype
        n = p["xyz"].shape[0]
        stats = ref.stats_init(n, dt, self.dev)
        opt = ref.adam_init(p)
        out_rec = {"loss": [], "instances": []}
        for i, s in enumerate(self.record.steps):
            hp = self.hyper(self.first + 1 + i, n)
            out = ref.train_step(p, stats, opt, s["camera"], s["gt"],
                                 s["bg"], hp, width=cfg["width"],
                                 height=cfg["height"],
                                 sh_degree=hp["sh_degree"], loss_fn=loss_fn)
            out_rec["loss"].append(out.loss)
            out_rec["instances"].append(out.instances)
            if i == 0:
                out_rec["first_grad"] = {
                    k: check.norm(v) / (1.0 - ref.BETA1)
                    for k, v in out.opt["mu"].items()}
            p, stats, opt = out.params, out.stats, out.opt
        out_rec["change"] = {k: check.diff_norm(p[k], p0[k])
                             for k in ref.LEAVES}
        out_rec["stats"] = {k: check.norm(v) for k, v in stats.items()}
        return out_rec

    def reference_rounds(self, dtype=torch.float32) -> dict:
        """The reference's rounds and resets from the program's recorded
        states before them: {"rounds": [(counts, {leaf or moment: rows on
        the host})], "resets": [norms]}, as ``program_rounds`` gives the
        program's."""
        opt, rain = self.cfg["opt"], self.rain()
        extent = self.extent()

        def dev(d):
            return {k: v.to(self.dev).to(dtype) for k, v in d.items()}

        its = range(self.first + 1, self.last + 1)
        out = {"rounds": [], "resets": [],
               "round_at": [i for i in its if ref_sched.is_round(
                   i, opt, rain["warmup_iter"])],
               "reset_at": [i for i in its if ref_sched.is_reset(
                   i, opt, rain["warmup_iter"])]}
        for r in self.record.rounds:
            flags = ref_sched.round_flags(r["iteration"], opt,
                                          rain["warmup_iter"])
            kw = dict(max_grad=opt["densify_grad_threshold"],
                      min_opacity=ref_sched.MIN_OPACITY, extent=extent,
                      percent_dense=opt["percent_dense"],
                      divide_ratio=rain["divide_ratio"],
                      max_screen_size=ref_sched.SCREEN_SIZE
                      if flags["size_threshold"] else None,
                      abe_split=flags["abe_split"],
                      noise=r["noise"].to(self.dev).to(dtype))
            m = dev(r["moments"])
            params, mu, nu, _, counts = ref_densify.densify_and_prune(
                dev(r["params"]), dev(r["stats"]),
                {k: m[f"mu.{k}"] for k in ref_densify.LEAVES},
                {k: m[f"nu.{k}"] for k in ref_densify.LEAVES}, **kw)
            rows = {**params, **{f"mu.{k}": v for k, v in mu.items()},
                    **{f"nu.{k}": v for k, v in nu.items()}}
            out["rounds"].append((counts, {k: _host(v)
                                           for k, v in rows.items()}))
        for r in self.record.resets:
            op = r["opacity"].to(self.dev).to(dtype)
            out["resets"].append(
                {"opacity": check.norm(ref_densify.reset_opacity(op)),
                 "mu.opacity": 0.0, "nu.opacity": 0.0})
        return out

    def program_rounds(self) -> dict:
        rec = self.record
        return {"rounds": [(r["counts"], r["after"]) for r in rec.rounds],
                "resets": [r["after"] for r in rec.resets],
                "round_at": [r["iteration"] for r in rec.rounds],
                "reset_at": [r["iteration"] for r in rec.resets]}

    @staticmethod
    def round_numbers(prog: dict, ref_rec: dict) -> dict:
        """The rounds' and the resets' gaps: the largest difference of a
        count; the leaves' and the moments' ``diff_gap`` after a round,
        row by row (infinite where the rows differ in number); the worst
        norm gap of the opacity and its moments after a reset. Rounds or
        resets at other iterations than the reference schedule's, or none,
        are an infinite gap."""
        if prog["round_at"] != ref_rec["round_at"] or \
                prog["reset_at"] != ref_rec["reset_at"] or \
                not ref_rec["round_at"] or not ref_rec["reset_at"]:
            return dict.fromkeys(("round.counts", "round.leaves",
                                  "round.moments", "reset"), math.inf)
        counts = leaves = moments = reset = 0.0
        for (pc, pt), (rc, rt) in zip(prog["rounds"], ref_rec["rounds"]):
            counts = max(counts, max(abs(pc[k] - rc[k]) for k in COUNTS))
            if pc["n_alive"] != rc["n_alive"]:
                leaves = moments = math.inf
                continue
            leaves = max(leaves, diff_gap(
                pt, {k: rt[k] for k in ref_densify.LEAVES}))
            moments = max(moments, diff_gap(
                pt, {k: v for k, v in rt.items()
                     if k.startswith(("mu.", "nu."))}))
        for pn, rn in zip(prog["resets"], ref_rec["resets"]):
            reset = max(reset, check.norm_gap(pn, rn))
        return {"round.counts": float(counts), "round.leaves": leaves,
                "round.moments": moments, "reset": reset}

    def work(self) -> list:
        """One record of the traced episodes: their iterations, the
        Trainer's counters over them and each round's counted bytes."""
        return [{"iterations": self.traced_iterations,
                 "counters": self.traced_counters,
                 "round_bytes": rounds.round_bytes(self.capacity),
                 "capacity": self.capacity}]


def diff_gap(got: dict, want: dict) -> float:
    """The worst tensor's ‖got − want‖ over max(‖want‖, the median
    tensor's ‖want‖), over the keys of ``want``."""
    norms = {k: check.norm(v) for k, v in want.items()}
    floor = max(statistics.median(norms.values()), 1e-30)
    return max(check.diff_norm(got[k], want[k]) / max(norms[k], floor)
               for k in want)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
