"""Rank functions of the port's sharded tests, run by
rain_tpu_torch.parallel.launch.spawn in one process per rank.

Each is called as ``fn(rank, device, *args)`` with the default group
initialised, and returns plain data (numpy arrays, numbers) on rank 0 and
None on the other ranks unless it says otherwise. The module imports numpy,
torch and the port only: the ranks never import jax.

The train CLI's sharded runs start one process per rank themselves
(``train_cli_ranks``), and ``ply_agreement`` holds the PLY of one run to
another's at the sharded Trainer's bar (``PLY_BAR``, ``PLY_OUTLIERS``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.parallel import distributed, sharding
from rain_tpu_torch.train.trainer import Trainer

# tests/test_sharding.py's step: 48x64 pixels, lrs and background
W, H = 48, 64
OPT_LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05,
              "scaling_lr": 0.005, "rotation_lr": 0.001}
BG = (0.1, 0.2, 0.3)
LOW_PASS, XYZ_LR = 0.3, 1e-3


def camera(device, width=W, height=H):
    """tests/conftest.py's make_camera, on ``device``."""
    return Camera(uid=0, image_name="test", R=np.eye(3), T=np.zeros(3),
                  fovx=0.8, fovy=0.6, image=None, width=width,
                  height=height).render_inputs(device)


def gt_image(seed=1):
    """tests/test_sharding.py's ground truth, [3, H, W] f32."""
    return np.random.default_rng(seed).uniform(0, 1, (3, H, W)).astype(
        np.float32)


def step_inputs(arrays, n_alive, device, gt=None):
    """(state, opt, camera, gt, bg) of the step on ``device``, the state
    carried from ``arrays`` (GaussianParams fields as numpy)."""
    state = gmod.from_numpy(arrays, n_alive, device=device)
    gt = gt_image() if gt is None else gt
    return (state, adam_mod.init(state.params), camera(device),
            torch.from_numpy(gt).to(device),
            torch.tensor(BG, dtype=torch.float32, device=device))


def _numpy(state, opt, aux):
    return {"loss": float(aux.loss), "l1": float(aux.l1),
            "num_instances": int(aux.num_instances),
            "overflow": bool(aux.instance_overflow),
            "params": {k: v.cpu().numpy()
                       for k, v in state.params._asdict().items()},
            "stats": {k: getattr(state, k).cpu().numpy()
                      for k in gmod.STAT_FIELDS},
            "mu": {k: v.cpu().numpy() for k, v in opt.mu._asdict().items()},
            "nu": {k: v.cpu().numpy() for k, v in opt.nu._asdict().items()}}


def digest(result) -> str:
    """sha256 of every array and number of a ``_numpy`` result."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                walk(x[k])
        elif isinstance(x, np.ndarray):
            h.update(x.tobytes())
        else:
            h.update(repr(x).encode())
    walk(result)
    return h.hexdigest()


def sharded_step(rank, device, arrays, n_alive, tier):
    """One sharded step from the state of ``arrays``; rank 0 returns the
    whole state, Adam's moments and the aux as numpy (``_numpy``)."""
    state, opt, cam, gt, bg = step_inputs(arrays, n_alive, device)
    world = distributed.world_size()
    step = sharding.make_sharded_train_step(
        width=W, height=H, sh_degree=3, max_instances_per_shard=tier,
        update_densify_stats=True)
    s, o, aux = step(sharding.shard_state(state, rank, world),
                     sharding.shard_opt(opt, rank, world), cam, gt, bg,
                     LOW_PASS, torch.tensor(XYZ_LR), OPT_LEAVES)
    s, o = sharding.gather_state(s), sharding.gather_opt(o)
    return _numpy(s, o, aux) if rank == 0 else None


def _device_values(state, device):
    """(state with n_alive a 0-d int32, low_pass, xyz_lr, the four lrs as
    0-d f32) on ``device``: every per-call value as rain_tpu traces it."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return (state._replace(n_alive=torch.tensor(
        state.n_alive, dtype=torch.int32, device=device)), f32(LOW_PASS),
        f32(XYZ_LR), {k: f32(v) for k, v in OPT_LEAVES.items()})


def sharded_step_values(rank, device, arrays, n_alive, tier):
    """One sharded step from the state of ``arrays``, three ways: every
    per-call value a number; each a 0-d tensor on ``device``
    (``_device_values``); and through train.compiled.CompiledStep's
    sharded_train_step with those tensors. Returns on every rank the digest
    of each run's shard results, the CompiledStep's graph and capture
    counts and its keys; on rank 0 also the whole results (``_numpy``) of
    the number and the tensor runs."""
    from rain_tpu_torch.train import compiled
    state, opt, cam, gt, bg = step_inputs(arrays, n_alive, device)
    world = distributed.world_size()
    s = sharding.shard_state(state, rank, world)
    o = sharding.shard_opt(opt, rank, world)
    kw = dict(width=W, height=H, sh_degree=3, max_instances_per_shard=tier,
              update_densify_stats=True)
    step = sharding.make_sharded_train_step(**kw)
    st, low_pass, xyz_lr, leaves = _device_values(s, device)
    steps = compiled.CompiledStep()
    runs = {"numbers": step(s, o, cam, gt, bg, LOW_PASS, XYZ_LR, OPT_LEAVES),
            "tensors": step(st, o, cam, gt, bg, low_pass, xyz_lr, leaves),
            "compiled": steps.sharded_train_step(
                st, o, cam, gt, bg, low_pass, xyz_lr, leaves, **kw)}
    whole = {k: _numpy(sharding.gather_state(runs[k][0]),
                       sharding.gather_opt(runs[k][1]), runs[k][2])
             for k in ("numbers", "tensors")}
    return {"digests": {k: digest(_numpy(*r)) for k, r in runs.items()},
            "graphs": len(steps.graphs), "captures": len(steps.captures),
            "keys": [tuple(k) for k in steps.sharded_train_keys],
            "whole": whole if rank == 0 else None}


def captured_sharded_step(rank, device, arrays, n_alive, tier, replays):
    """The sharded step of ``arrays``' state on an NCCL group, eager and
    through a CompiledStep: its first call (the warm-up, then the capture),
    then ``replays`` replays of the same inputs, each held to the eager
    step bit for bit on this rank's shard. Returns on every rank (the
    replays equal to the eager step, graphs, captures, B1-B4's launches
    per compiled call, the eager step's digest)."""
    from rain_tpu_torch.train import compiled
    state, opt, cam, gt, bg = step_inputs(arrays, n_alive, device)
    world = distributed.world_size()
    st, low_pass, xyz_lr, leaves = _device_values(
        sharding.shard_state(state, rank, world), device)
    args = (st, sharding.shard_opt(opt, rank, world), cam, gt, bg, low_pass,
            xyz_lr, leaves)
    kw = dict(width=W, height=H, sh_degree=3, max_instances_per_shard=tier,
              update_densify_stats=True)
    want = sharding.make_sharded_train_step(**kw)(*args)
    flat = _step_tensors(want)
    steps = compiled.CompiledStep()
    steps.sharded_train_step(*args, **kw)
    equal, launches = [], []
    for _ in range(replays):
        before = compiled.launch_counts()
        got = _step_tensors(steps.sharded_train_step(*args, **kw))
        launches.append([k - n for k, n in zip(compiled.launch_counts(),
                                               before)])
        equal.append(all(_same_bits(a, b) for a, b in zip(got, flat)))
    return {"equal": equal, "graphs": len(steps.graphs),
            "captures": len(steps.captures), "launches": launches,
            "digest": digest(_numpy(*want))}


def _step_tensors(result) -> list:
    """Every tensor of a sharded step's (state, opt, aux)."""
    s, o, aux = result
    return (list(s.params) + [getattr(s, k) for k in gmod.STAT_FIELDS] +
            list(o.mu) + list(o.nu) + [o.step, aux.loss, aux.l1,
                                       aux.num_instances,
                                       aux.instance_overflow])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: floats through their bits."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


# -- gradcheck of distributed.gather_shards ------------------------------
N_ROWS = 3           # rows of each rank's shard
_FORWARD, _BACKWARD, _STOP = 1, 2, 0


def _command(cmd: int, src: int) -> int:
    t = torch.tensor([cmd], dtype=torch.int64)
    torch.distributed.broadcast(t, src=src)
    return int(t[0])


class _Announce(torch.autograd.Function):
    """Identity whose backward first tells the serving ranks to run theirs
    (the gather's backward is a collective they must join)."""

    @staticmethod
    def forward(ctx, x, src):
        ctx.src = src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _command(_BACKWARD, ctx.src)
        return g, None


def _mix(g: torch.Tensor) -> torch.Tensor:
    """A nonlinear map of the gathered [world·N_ROWS, 2] rows that mixes
    rows of different shards."""
    w = torch.linspace(0.5, 1.5, g.numel(), dtype=g.dtype).view_as(g)
    return torch.tanh(g) * w + g * g.roll(1, 0)


def gather_gradcheck(rank, device, checker):
    """torch.autograd.gradcheck, in f64 on rank ``checker``, of
    ``_mix(gather_shards(x))`` in its own shard x: the other ranks serve
    every forward and backward it runs, with their own shards and a zero
    cotangent, so rank ``checker``'s gradient is the sum the gather's
    backward makes of every rank's cotangent of its rows. Each rank's
    shard differs. Returns gradcheck's verdict on every rank."""
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((N_ROWS, 2), generator=gen,
                    dtype=torch.float64).requires_grad_(True)
    if rank == checker:
        def f(xc):
            _command(_FORWARD, checker)
            return _mix(_Announce.apply(
                distributed.gather_shards(xc), checker))

        ok = torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8,
                                      rtol=1e-6, check_undefined_grad=False)
        _command(_STOP, checker)
        return ok
    out = None
    while True:
        cmd = _command(0, checker)
        if cmd == _STOP:
            return True
        if cmd == _FORWARD:
            with torch.enable_grad():
                out = _mix(distributed.gather_shards(x))
        else:
            torch.autograd.grad(out, x, torch.zeros_like(out),
                                retain_graph=True)


def reduce_scatter_order(rank, device, rows_per_rank):
    """distributed.reduce_scatter of each rank's seeded cotangent
    [world·rows_per_rank, 3] f32, against this rank's rows of the sum in
    rank order, ((x_0 + x_1) + x_2) + ..., and of the sum in reverse
    order; the values span many magnitudes, so that the two orders round
    apart. Returns (equal to rank order bit for bit, rows where the two
    orders part) on every rank."""
    world = distributed.world_size()
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        (world * rows_per_rank, 3)).astype(np.float32) * np.float32(
            10.0 ** np.random.default_rng(100 + r).integers(
                -4, 5, (world * rows_per_rank, 1)))).to(device)
          for r in range(world)]
    got = distributed.reduce_scatter(xs[rank].clone())
    rows = slice(rank * rows_per_rank, (rank + 1) * rows_per_rank)
    forward, backward = xs[0][rows].clone(), xs[-1][rows].clone()
    for x in xs[1:]:
        forward += x[rows]
    for x in xs[-2::-1]:
        backward += x[rows]
    return (bool(torch.equal(got.view(torch.int32),
                             forward.view(torch.int32))),
            int((forward != backward).any(dim=1).sum()))


# -- the Trainer --------------------------------------------------------------
def toy_scene(n_cams=6, n_pts=120, size=48, seed=0) -> SceneData:
    """tests/test_training.py's toy scene, rendered by the port on the
    CPU: a ring of cameras around 120 seeded Gaussians, their renders as
    the ground truth, noisy init points near the truth."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (n_pts, 2)),
                          rng.uniform(3.0, 4.5, (n_pts, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n_pts, 3)).astype(np.float32)
    gt_state = gmod.create_from_pcd(pts, cols, sh_degree=3, capacity=n_pts,
                                    knn_window=16, device="cpu")
    scales, quats, opac, shs = gmod.activate(gt_state.params)
    cams = []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * 0.06
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cam = Camera(uid=i, image_name=f"c{i}", R=R, T=np.zeros(3),
                     fovx=0.9, fovy=0.9, image=None, width=size,
                     height=size)
        with torch.no_grad():
            out = render_ops.render(
                gt_state.params.xyz, scales, quats, opac, shs,
                gmod.alive_mask(gt_state), camera=cam.render_inputs("cpu"),
                width=size, height=size, sh_degree=3, bg=torch.zeros(3),
                max_instances=4096)
        cam.image = torch.clamp(out.render, 0, 1).numpy()
        cams.append(cam)
    init_pts = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    init_cols = np.clip(cols + rng.normal(0, 0.2, cols.shape),
                        0, 1).astype(np.float32)
    return SceneData(train_cameras=cams[:-1], test_cameras=cams[-1:],
                     points=init_pts, colors=init_cols,
                     nerf_radius=2.0, nerf_translate=np.zeros(3))


def trainer_configs(devices, **opt):
    """tests/test_sharding.py:114-125's configuration: capacity 512,
    tier 8192, the given optimisation overrides."""
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    cfgs["opt"] = dataclasses.replace(cfgs["opt"], **opt)
    cfgs["system"] = dataclasses.replace(
        cfgs["system"], capacity=512, max_instances=8192, devices=devices)
    return cfgs


DENSIFY_ROUND = dict(iterations=10, densify_from_iter=5,
                     densification_interval=10, densify_until_iter=40,
                     opacity_reset_interval=10_000)


def train_toy(rank, device, devices, model_path, iterations):
    """A Trainer of ``devices`` ranks on the toy scene through a densify
    round at 10 (``DENSIFY_ROUND``); rank 0 returns (n_alive, the whole
    params as numpy, its max_instances)."""
    tr = Trainer(toy_scene(), trainer_configs(devices, **DENSIFY_ROUND),
                 model_path, device=device, log_fn=lambda *a: None,
                 tensorboard=False)
    state = tr.train(iterations=iterations, test_iterations=(),
                     save_iterations=())
    if rank:
        return None
    return (state.n_alive, {k: v.cpu().numpy()
                            for k, v in state.params._asdict().items()},
            tr.max_instances)


KEYS_RUN = dict(iterations=12, densify_from_iter=3,
                densification_interval=5, densify_until_iter=8,
                opacity_reset_interval=10_000)


def sharded_trainer_keys(rank, device, model_path):
    """A Trainer of 2 ranks on a small toy scene through ``KEYS_RUN`` (a
    densify round at 5; the statistics stop at 8) and a report at 12, its
    CompiledStep's sharded_train_step recorded. Returns on every rank the
    (width, height, sh_degree, max_instances_per_shard,
    update_densify_stats) of its calls, ``_step_keys``, the eval keys,
    graph and capture counts, the shard's capacity and lambda_dssim."""
    from rain_tpu_torch.train import compiled
    calls = set()
    method = compiled.CompiledStep.sharded_train_step

    def recorded(self, *a, **kw):
        calls.add((kw["width"], kw["height"], kw["sh_degree"],
                   kw["max_instances_per_shard"],
                   kw["update_densify_stats"]))
        return method(self, *a, **kw)

    compiled.CompiledStep.sharded_train_step = recorded   # this rank's own
    tr = Trainer(toy_scene(n_cams=3, n_pts=60), trainer_configs(
        2, **KEYS_RUN), model_path, device=device, log_fn=lambda *a: None,
        tensorboard=False)
    tr.train(iterations=KEYS_RUN["iterations"],
             test_iterations=(KEYS_RUN["iterations"],), save_iterations=())
    return {"calls": sorted(calls),
            "keys": sorted(tuple(k) for k in tr._step_keys),
            "eval_keys": sorted(tuple(k) for k in tr._steps.eval_keys),
            "graphs": len(tr._steps.graphs),
            "captures": len(tr._steps.captures),
            "shard_capacity": tr.state.capacity,
            "lambda_dssim": tr.opt_cfg.lambda_dssim}


def write_gate(rank, device, root):
    """A 2-rank Trainer, each rank with a model path of its own under
    ``root``, asked for TensorBoard, a report, a PLY and a checkpoint at
    iteration 2. Returns (files written under its path, whether it made
    a TensorBoard writer) on every rank."""
    out = Path(root) / f"rank{rank}"
    cfgs = trainer_configs(2, iterations=2, densify_from_iter=10_000)
    tr = Trainer(toy_scene(n_cams=3, n_pts=60), cfgs, str(out),
                 device=device, log_fn=lambda *a: None,
                 tensorboard=rank != 0)
    tr.train(iterations=2, test_iterations=(2,), save_iterations=(2,),
             checkpoint_iterations=(2,))
    return (sorted(str(p.relative_to(out)) for p in out.rglob("*")
                   if p.is_file()), tr.tb is not None)


# -- the train CLI, one process per rank -------------------------------------
# a sharded run's params against another run's: within PLY_BAR in all but
# PLY_OUTLIERS of each leaf's rows (a gradient at its rounding's level takes
# either sign in the two runs, and Adam turns each such sign into a step of
# lr; tests/test_sharding.py:98-106)
PLY_BAR = 2e-3
PLY_OUTLIERS = 1e-4


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_cli_ranks(argv, world, work_dir, *, counts=False, timeout_s=600,
                    env=None):
    """``python -m rain_tpu_torch.scripts.train`` with ``argv`` (which
    names the group: --devices, --dist_init, --world_size) as ``world``
    processes, rank r with ``--rank r``, all started together, each
    writing its output to ``work_dir``/rank<r>.log. With ``counts`` each
    rank runs through tests/torch_cli_rank.py, which writes its kernels'
    launches to ``work_dir``/rank<r>.json. Returns (each rank's exit
    code, each rank's output, the wall seconds until the last one ended).
    The ranks still running after ``timeout_s`` are killed (exit code
    -9); no process outlives the call."""
    root = Path(__file__).resolve().parent.parent
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), env.get("PYTHONPATH")) if p)

    def command(r):
        head = ([str(root / "tests" / "torch_cli_rank.py"),
                 str(work_dir / f"rank{r}.json")] if counts
                else ["-m", "rain_tpu_torch.scripts.train"])
        return [sys.executable, *head, *argv, "--rank", str(r)]

    # a file per rank, not a pipe: a rank blocked on a full pipe would
    # stall every other rank at the next collective
    t = time.perf_counter()
    procs = []
    try:
        for r in range(world):
            with open(work_dir / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    command(r), env=env, cwd=root, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                break       # the ranks still running are killed: -9
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall_s = time.perf_counter() - t
    logs = [(work_dir / f"rank{r}.log").read_text(errors="replace")
            for r in range(world)]
    return [p.returncode for p in procs], logs, wall_s


def ply_agreement(path, ref_path):
    """The PLY at ``path`` against the one at ``ref_path``: their rows
    (n_alive), and per leaf the largest row error past the
    PLY_OUTLIERS share of the farthest rows and the rows off by PLY_BAR
    or more. Rows compare in order: a sharded run's gathered state keeps
    the single-device row order."""
    from rain_tpu_torch.data import ply as ply_io
    got, want = ply_io.read_gaussians(path), ply_io.read_gaussians(ref_path)
    n, n_ref = got["xyz"].shape[0], want["xyz"].shape[0]
    rec = {"n_alive": n, "n_alive_ref": n_ref, "max_abs_err_but_outliers":
           {}, "rows_over_bar": {}, "outliers_allowed": int(
               PLY_OUTLIERS * n_ref)}
    if n != n_ref:
        return rec
    for name in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"):
        d = np.abs(got[name] - want[name]).reshape(n, -1).max(axis=1)
        rec["max_abs_err_but_outliers"][name] = float(
            np.sort(d)[-1 - rec["outliers_allowed"]]) if n else 0.0
        rec["rows_over_bar"][name] = int((d >= PLY_BAR).sum())
    return rec


def ply_agrees(rec) -> bool:
    """``ply_agreement``'s record meets the bar."""
    return rec["n_alive"] == rec["n_alive_ref"] and all(
        v < PLY_BAR for v in rec["max_abs_err_but_outliers"].values())


# -- a band whose first tile row lies above the image ----------------------
def band_case(grid_x=6, n_rows=4, n=300, seed=0, shift_rows=0):
    """The rows of a band whose first tile row, row -1, lies above the
    image (the sharded step's band 0, tile offset -grid_x): n Gaussians,
    many of whose rects start in row -1, with means on a 1/64-pixel grid
    so that moving them down by ``shift_rows`` tile rows is exact. Returns
    (table10 [10, n] f32, tiles [n] int32, rect_min [n, 2] int32, rect_wh
    [n, 2] int32) on the CPU, the rects within global rows
    [shift_rows - 1, shift_rows + n_rows - 1)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, grid_x * 16 * 64, n) / 64.0
    y = rng.integers(-16 * 64, (n_rows - 1) * 16 * 64, n) / 64.0
    s = rng.uniform(1.5, 6.0, n)
    rot = rng.uniform(-0.3, 0.3, n)
    a, c, b = 1.0 / s ** 2, 1.0 / (s * (1.0 + rot)) ** 2, 0.1 * rot / s ** 2
    r = np.ceil(3.0 * s * (1.0 + np.abs(rot)))
    lo, hi = -1, n_rows - 1
    x0 = np.clip(np.floor((x - r) / 16), 0, grid_x)
    x1 = np.clip(np.floor((x + r + 15) / 16), 0, grid_x)
    y0 = np.clip(np.floor((y - r) / 16), lo, hi)
    y1 = np.clip(np.floor((y + r + 15) / 16), lo, hi)
    w, h = x1 - x0, y1 - y0
    table = np.stack([a, b, c, x, y + 16 * shift_rows,
                      rng.uniform(0.2, 0.9, n), *rng.uniform(0, 1, (3, n)),
                      rng.uniform(1.0, 5.0, n)]).astype(np.float32)
    return (torch.from_numpy(table),
            torch.from_numpy((w * h).astype(np.int32)),
            torch.from_numpy(np.stack([x0, y0 + shift_rows], 1).astype(
                np.int32)),
            torch.from_numpy(np.stack([w, h], 1).astype(np.int32)))


def run_band(case, toff, grid_x=6, n_rows=4, m=4096, plain=False,
             device="cpu"):
    """B1, the tile sort, tile_ranges, B3 and B4 (with a seeded cotangent)
    on a band of ``band_case``'s, through the wrappers, or with
    ``plain`` through the plain versions, on ``device``. Returns {name:
    tensor} of every stage's output."""
    from rain_tpu_torch.ops import binning as binning_ops
    from rain_tpu_torch.ops import expand as expand_ops
    from rain_tpu_torch.ops import tile_render
    table10, tiles, rect_min, rect_wh = (t.to(device) for t in case)
    n_tiles = n_rows * grid_x
    d = binning_ops.depth_order(table10, tiles, rect_min, rect_wh, grid_x)
    expand = (expand_ops.expand_instances_torch if plain
              else expand_ops.expand_instances)
    cols, keys = expand(d.table, d.tiles, d.offs, d.rect_w, d.rect_base,
                        grid_x=grid_x, tile_offset=toff, n_tiles=n_tiles,
                        max_instances=m)
    pack, _ = binning_ops.tile_sort(cols, keys)
    start, end = binning_ops.tile_ranges(rect_min, rect_wh, tiles > 0,
                                         grid_x, n_tiles, toff, m)
    fwd = (tile_render.composite_forward_torch if plain
           else tile_render.composite_forward)
    bwd = (tile_render.composite_backward_torch if plain
           else tile_render.composite_backward)
    out = fwd(pack, start, end, toff, grid_x)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n_tiles, 256, 8)).astype(np.float32)).to(device)
    return {"cols": cols, "keys": keys, "pack": pack, "start": start,
            "end": end, "tiles": out,
            "d_pack": bwd(pack, start, end, toff, grid_x, out, g)}


def sharded_refuses_depth(rank, device, arrays, n_alive, tier):
    """The messages of the ValueErrors that the sharded step and the
    compiled step's sharded_train_step raise on a depth target."""
    from rain_tpu_torch.train import compiled
    from rain_tpu_torch.train import step as step_mod
    state, opt, cam, gt, bg = step_inputs(arrays, n_alive, device)
    world = distributed.world_size()
    s = sharding.shard_state(state, rank, world)
    o = sharding.shard_opt(opt, rank, world)
    depth = step_mod.DepthTarget(torch.ones((H, W)), torch.ones((H, W)),
                                 1.0)
    kw = dict(width=W, height=H, sh_degree=3, max_instances_per_shard=tier)
    msgs = []
    for call in (
            lambda: sharding.make_sharded_train_step(**kw)(
                s, o, cam, gt, bg, LOW_PASS, XYZ_LR, OPT_LEAVES,
                depth=depth),
            lambda: compiled.CompiledStep().sharded_train_step(
                s, o, cam, gt, bg, LOW_PASS, XYZ_LR, OPT_LEAVES,
                depth=depth, **kw)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    return msgs
