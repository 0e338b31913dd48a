"""Depth regularization in the port, on the CPU (no JAX).

- The depth-path step (``train.step.train_step`` with a ``DepthTarget``:
  the inverse depth composited by B3, B4's depth variant and B2 at ten
  rows in their plain versions, the -1/z² chain into the means) against
  the plain reference ``gsbench/reference/depth.py`` at 48×32 on seeded
  random Gaussians: the loss, the inverse-depth image and every leaf's
  gradient.
- An f64 evaluation of the same render (the plain kernels in f64) holds
  the f32 gradients of a loss on the inverse-depth channel, and central
  differences in f64 hold the chain through 1/z into the means' z.
- A weight of 0, or a mask of zeros (an unreliable map), gives the step
  without a depth term, bit for bit; with the depth path off, the keys,
  the pack's depth row, B4's rows and B2's rows are what they were.
- The sharded step refuses depth inputs with ValueError, on gloo; the
  captured sharded step's outputs (a ShardedAux, no inverse depth) pack
  as a one-card step's without a depth term.
- The loader: 16-bit maps and ``depth_params.json`` (scale, offset, the
  clamp, a bilinear resize as cv2's, the reliability rule); ``-d`` on the
  command line; ``Trainer.train`` with a depth term on the reliable
  views alone; the train CLI with ``-d``.
- The benchmark's depth cell (``init262k.depth``) through
  ``gsbench.run.run_cell`` cut to 48×32 (a process of its own): a sound
  run is correct, each fault that ``gsbench/calibrate_depth.py`` plants
  is not, and a traced run reads the cell's program counter; the
  readers of its three metrics on synthetic traces; its targets.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_gt_images as gt_images
import torch_sharding_cases as cases
from gsbench import readers
from gsbench import trace as trace_mod
from gsbench.loops import depth_train
from gsbench.reference import depth as ref_depth
from gsbench.reference import step as ref
from gsbench.work import bound_s, counts
from gsbench.work import depth as depth_work
from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data import dataset
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.parallel import launch, sharding
from rain_tpu_torch.train import compiled, schedules, step
from torch_colmap_scene import toy_depths, toy_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W, H, N, M = 48, 32, 300, 1 << 14
LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
          "rotation_lr": 0.001}
HP = {"low_pass": 0.3, "xyz_lr": 1.6e-4, "opt_leaves": LEAVES,
      "lambda_dssim": 0.2}
KW = dict(width=W, height=H, sh_degree=3, max_instances=M,
          opt_cfg_leaves=LEAVES, lambda_dssim=0.2)


def _state(seed, n=N):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                          rng.uniform(2.0, 6.0, (n, 1))], 1)
    return gmod.from_arrays(
        xyz, rng.normal(0, 0.5, (n, 1, 3)), rng.normal(0, 0.1, (n, 15, 3)),
        rng.uniform(-3.2, -2.4, (n, 3)), rng.normal(size=(n, 4)),
        rng.normal(0, 1.0, (n, 1)), device="cpu")


def _camera():
    return Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                  fovx=1.0, fovy=0.7, image=None, width=W,
                  height=H).render_inputs("cpu")


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand((3, H, W), generator=g)
    target = 1 / 6 + (0.5 - 1 / 6) * torch.rand((H, W), generator=g)
    return gt, target, torch.ones((H, W))


def _step(state, gt, depth=None, on_stage=step.binning_ops.no_stage_hook):
    return step.train_step(state, adam.init(state.params), _camera(), gt,
                           torch.zeros(3), 0.3, 1.6e-4, depth=depth,
                           on_stage=on_stage, **KW)


def _outputs(out):
    st, op, aux = out
    return (list(st.params) + [getattr(st, k) for k in gmod.STAT_FIELDS] +
            list(op.mu) + list(op.nu) +
            [op.step, aux.loss, aux.l1, aux.num_instances,
             aux.instance_overflow])


# --- the step against the plain reference ---------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_step_matches_the_plain_reference(seed):
    state = _state(seed)
    gt, target, mask = _inputs(seed)
    weight = ref_depth.depth_weight(1 + seed)
    _, opt, aux = _step(state, gt, step.DepthTarget(target, mask, weight))
    p = state.params._asdict()
    want = ref_depth.train_step(
        p, ref.stats_init(N, torch.float32, "cpu"), ref.adam_init(p),
        _camera(), gt, torch.zeros(3), HP, width=W, height=H, sh_degree=3,
        target=target, mask=mask, weight=weight)
    assert abs(float(aux.loss) - want.loss) <= 1e-6 * want.loss
    assert int(aux.num_instances) == want.instances > 0
    scale = float(want.inv_depth.abs().max())
    assert scale > 0.1
    assert float((aux.inv_depth - want.inv_depth).abs().max()) <= \
        1e-5 * scale
    for k in ref.LEAVES:
        got = getattr(opt.mu, k) / (1.0 - adam.BETA1)
        w = want.grads[k]
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
    # the depth term moved the means: the step without it differs
    _, opt0, aux0 = _step(state, gt)
    assert float(aux.loss) > float(aux0.loss)
    assert not torch.equal(opt.mu.xyz, opt0.mu.xyz)


def test_bucketed_depth_step_equals_the_exact_size_step():
    """A 45x30 view in its 48x32 bucket (targets zero past the true size,
    the loss masked to it) against the same view at its exact size."""
    state = _state(7)
    gt, target, mask = _inputs(7)
    w, h = 45, 30
    cam = Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=1.0, fovy=0.7, image=None, width=w,
                 height=h).render_inputs("cpu")
    pad = [x.clone() for x in (gt, target, mask)]
    for x in pad:
        x[..., h:, :] = 0.0
        x[..., :, w:] = 0.0
    outs = []
    for args in ((pad[0], step.DepthTarget(pad[1], pad[2], 0.9),
                  dict(width=W, height=H, real_wh=(w, h))),
                 (gt[:, :h, :w].contiguous(),
                  step.DepthTarget(target[:h, :w].contiguous(),
                                   mask[:h, :w].contiguous(), 0.9),
                  dict(width=w, height=h))):
        kw = dict(KW, **args[2])
        outs.append(step.train_step(
            state, adam.init(state.params), cam, args[0], torch.zeros(3),
            0.3, 1.6e-4, depth=args[1], **kw))
    (_, ob, ab), (_, oe, ae) = outs
    assert abs(float(ab.loss) - float(ae.loss)) <= 1e-6 * float(ae.loss)
    assert torch.allclose(ab.inv_depth[:h, :w], ae.inv_depth, rtol=0,
                          atol=1e-6)
    for b, e in zip(ob.mu, oe.mu):
        assert float((b - e).abs().max()) <= 1e-4 * float(e.abs().max())


# --- f64: the inverse-depth channel's gradient and the chain into z -------

def _inv_depth_loss(xyz, rest, wts, dtype):
    """sum(D·wts) of the render of the means ``xyz`` (the other raw leaves
    ``rest``), through render_params' inverse-depth path, in ``dtype``
    (call it under ``plain_kernels``)."""
    params = gmod.GaussianParams(xyz, *rest)
    cam = {k: v.to(dtype) for k, v in _camera().items()}
    out = render_ops.render_params(
        params, torch.ones(N, dtype=torch.bool), camera=cam, width=W,
        height=H, sh_degree=3, bg=torch.zeros(3, dtype=dtype), low_pass=0.3,
        max_instances=M, depth_row="inverse")
    return (out.depth[0] * wts.to(dtype)).sum()


def test_inverse_depth_gradient_against_f64_and_differences():
    state = _state(5)
    wts = torch.from_numpy(np.cos(np.arange(H * W)).reshape(H, W).astype(
        np.float32))
    grads = {}
    for dt in (torch.float32, torch.float64):
        xs = [p.detach().to(dt).requires_grad_(True)
              for p in state.params]
        with gt_images.plain_kernels():
            loss = _inv_depth_loss(xs[0], xs[1:], wts, dt)
            grads[dt] = torch.autograd.grad(loss, xs)
    for name, g32, g64 in zip(gmod.GaussianParams._fields, grads[
            torch.float32], grads[torch.float64]):
        scale = float(g64.abs().max())
        if name.startswith("features"):     # D reads no colour
            assert scale == 0.0 and float(g32.abs().max()) == 0.0, name
            continue
        assert scale > 0.0, name
        assert float((g32.double() - g64).abs().max()) <= 5e-5 * scale, name
    # central differences along z of the means that weigh most (the plain
    # compositor's forward accumulates in f32, so the step is not tiny)
    g_z = grads[torch.float64][0][:, 2]
    rest = [p.detach().double() for p in state.params[1:]]
    xyz = state.params.xyz.detach().double()
    eps = 1e-4
    for i in torch.argsort(g_z.abs(), descending=True)[:5].tolist():
        up, down = xyz.clone(), xyz.clone()
        up[i, 2] += eps
        down[i, 2] -= eps
        with gt_images.plain_kernels(), torch.no_grad():
            fd = (_inv_depth_loss(up, rest, wts, torch.float64) -
                  _inv_depth_loss(down, rest, wts, torch.float64)) / \
                (2 * eps)
        assert abs(float(fd) - float(g_z[i])) <= 1e-3 * abs(float(g_z[i]))


# --- no depth term, and the path off --------------------------------------

@pytest.mark.parametrize("off", ["zero_weight", "unreliable_mask"])
def test_no_depth_term_gives_the_step_without_one(off):
    state = _state(3)
    gt, target, mask = _inputs(3)
    if off == "zero_weight":
        depth = step.DepthTarget(target, mask, torch.zeros(()))
    else:
        depth = step.DepthTarget(target, torch.zeros((H, W)), 1.0)
    got = _step(state, gt, depth)
    want = _step(state, gt)
    for a, b in zip(_outputs(got), _outputs(want)):
        assert torch.equal(a, b)
    assert got[2].inv_depth is not None and want[2].inv_depth is None


def test_the_depth_path_off_is_as_before():
    """Keys, rows and counts of the step without a depth term: a TrainKey
    of its eight fields, the pack's depth row zero, B4's nine rows and
    B2's nine, no depth launch counted; the depth key is of its own."""
    state = _state(4)
    gt, target, mask = _inputs(4)
    kw = dict(width=W, height=H, sh_degree=3, max_instances=M)
    key = compiled.train_key(state, **kw)
    assert type(key) is compiled.TrainKey
    assert tuple(key) == (W, H, 3, M, 0.2, True, N, False)
    dkey = compiled.train_key(state, depth=True, **kw)
    assert type(dkey) is compiled.DepthTrainKey
    assert dkey != key and key != dkey and not dkey == key
    assert len({key, dkey}) == 2 and {dkey: 1}.get(key) is None
    assert tuple(dkey) == tuple(key)
    for depth in (None, step.DepthTarget(target, mask, 1.0)):
        seen = {}
        _step(state, gt, depth, on_stage=seen.__setitem__)
        pack = seen["tile_sort_gather"]
        d_rank = seen["reduce_B2"][0]
        _, d_pack = seen["composite_bwd_B4"]
        if depth is None:
            assert torch.all(pack[tile_render.ROW_DEPTH] == 0.0)
            assert d_rank.shape[0] == tile_render.GRAD_ROWS == 9
            assert torch.all(d_pack[tile_render.GRAD_ROWS:] == 0.0)
        else:
            live = pack[tile_render.ROW_DEPTH][:int(seen["tile_ranges"][1]
                                                   [-1])].detach()
            assert float(live.min()) > 1 / 6.5 and float(live.max()) < 0.5
            assert d_rank.shape[0] == tile_render.DEPTH_GRAD_ROWS
            assert float(d_pack[tile_render.ROW_DEPTH].abs().max()) > 0.0
    assert compiled.COUNTED[-2] == (tile_render.composite_backward,
                                    "launches_depth")


def test_the_sharded_step_refuses_depth_inputs_on_gloo():
    state = _state(6, n=64)
    arrays = {k: v.numpy() for k, v in state.params._asdict().items()}
    msgs = launch.spawn(cases.sharded_refuses_depth, 2, device="cpu",
                        timeout_s=300.0, args=(arrays, 64, M))
    for pair in msgs:
        assert len(pair) == 2
        assert all("no depth term" in m for m in pair)


def test_a_sharded_aux_packs_as_a_step_without_depth():
    """The graph of CompiledStep.sharded_train_step (NCCL only) returns
    ``_step_outputs`` of a ShardedAux, which has no inverse depth: the
    list of a one-card step without a depth term, and back."""
    state = _state(7, n=64)
    opt = adam.init(state.params)
    vals = (torch.tensor(0.5), torch.tensor(0.25), torch.tensor(7),
            torch.tensor(False))
    outs = compiled._step_outputs(state, opt,
                                  sharding.ShardedAux(*vals, n_alive=64))
    plain = compiled._step_outputs(state, opt, step.StepAux(*vals, 64))
    assert len(outs) == len(plain)
    assert all(a is b for a, b in zip(outs, plain))
    st, op, aux = compiled._step_results(outs, 64)
    assert [float(v) for v in aux] == [0.5, 0.25, 7.0, 0.0]
    assert all(a is b for a, b in zip(st.params, state.params))


# --- the loader, the flags, the Trainer, the CLI --------------------------

@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_scene")
    toy_scene(root)
    raws = toy_depths(root)
    return root, raws


def test_loader_reads_scale_offset_clamp_and_reliability(depth_scene):
    import cv2
    root, raws = depth_scene
    scene = dataset.load_colmap_scene(root, eval_split=False, resolution=1,
                                      depths="depths")
    params = json.loads((root / "sparse" / "0" /
                         "depth_params.json").read_text())
    for cam in scene.train_cameras:
        raw = raws[cam.image_name].astype(np.float32) / np.float32(65536)
        up = cv2.resize(raw, (cam.width, cam.height))
        p = params[cam.image_name]
        want = np.maximum(up * np.float32(p["scale"]) +
                          np.float32(p["offset"]), 0)
        assert cam.invdepthmap.shape == (cam.height, cam.width)
        np.testing.assert_allclose(cam.invdepthmap, want, rtol=0,
                                   atol=2e-6)
        assert cam.invdepthmap.min() >= 0.0
        reliable = cam.image_name != "img_002"      # scale 0.1 < 0.2 · 1.0
        assert cam.depth_reliable == reliable
        assert np.all(cam.depth_mask == float(reliable))
    # img_004's offset -0.3 takes part of the map below 0: clamped
    m4 = next(c for c in scene.train_cameras if c.image_name == "img_004")
    assert (m4.invdepthmap == 0.0).any()
    assert dataset.depth_params(root / "sparse" / "0")["img_000"][
        "med_scale"] == 1.0
    # without depths nothing is loaded
    plain = dataset.load_colmap_scene(root, eval_split=False, resolution=1)
    assert all(c.invdepthmap is None and not c.depth_reliable
               for c in plain.train_cameras)


def test_depth_flags_parse_and_save():
    args = cfg_mod.build_parser("t").parse_args(
        ["-s", "/x", "-d", "depths", "--depth_l1_weight_final", "0.02"])
    cfgs = cfg_mod.extract_all(args)
    assert cfgs["model"].depths == "depths"
    assert cfgs["opt"].depth_l1_weight_init == 1.0
    assert cfgs["opt"].depth_l1_weight_final == 0.02
    w = schedules.depth_l1_weight(15_000, cfgs["opt"])
    assert abs(w - ref_depth.depth_weight(15_000, 1.0, 0.02)) < 1e-12
    assert schedules.depth_l1_weight(1, cfg_mod.OptimizationParams()) == \
        ref_depth.depth_weight(1)


def test_trainer_adds_the_depth_term_on_reliable_views(depth_scene,
                                                       tmp_path,
                                                       monkeypatch):
    from rain_tpu_torch.train.trainer import Trainer
    root, _ = depth_scene
    scene = dataset.load_colmap_scene(root, eval_split=False, resolution=1,
                                      depths="depths")
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args(
        ["-s", str(root), "-d", "depths", "--iterations", "12",
         "--capacity", "4096", "--max_instances", "16384"]))
    seen = []
    real = compiled.CompiledStep.train_step

    def record(self, state, opt, camera, gt, *a, depth=None, **kw):
        out = real(self, state, opt, camera, gt, *a, depth=depth, **kw)
        seen.append((depth, out[2], tr.iteration))
        return out

    monkeypatch.setattr(compiled.CompiledStep, "train_step", record)
    tr = Trainer(scene, cfgs, tmp_path / "out", device="cpu",
                 tensorboard=False, log_fn=lambda *_: None)
    tr.train(12, test_iterations=(), save_iterations=())
    names = [c.image_name for c in scene.train_cameras]
    assert len(seen) == 12
    with_term = [d for d, _, _ in seen if d is not None]
    assert 0 < len(with_term) < 12      # img_002's steps have none
    for depth, aux, it in seen:
        if depth is None:
            assert aux.inv_depth is None
            continue
        # the schedule runs over the run's 12 iterations, as upstream's
        assert depth.weight == ref_depth.depth_weight(it, 1.0, 0.01, 12)
        term = ref_depth.depth_l1(aux.inv_depth, depth.inv_depth,
                                  depth.mask)
        assert float(term) > 0.0
        match = [c for c in scene.train_cameras if c.depth_reliable and
                 np.array_equal(c.invdepthmap, depth.inv_depth.numpy())]
        assert match, names


def test_train_cli_takes_depths(depth_scene, tmp_path):
    from rain_tpu_torch.scripts import train as train_cli
    root, _ = depth_scene
    out = tmp_path / "out"
    train_cli.main(["-s", str(root), "-m", str(out), "-d", "depths",
                    "--device", "cpu", "--iterations", "4",
                    "--test_iterations", "4", "--save_iterations", "4",
                    "--capacity", "4096", "--max_instances", "16384",
                    "--resolution", "1", "--quiet"])
    saved = json.loads((out / "cfg_args.json").read_text())
    assert saved["model"]["depths"] == "depths"
    assert "depth_l1_weight_init" not in saved["opt"]   # at its default
    assert (out / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()


# --- the benchmark's depth cell --------------------------------------------

CELL = "init262k.depth"
SEED = 2**31 + 28
TINY = {"width": 48, "height": 32, "n_gaussians": 300, "capacity": 300,
        "max_instances": 16384}
RUNS = f"""
import contextlib, json, sys, torch
from pathlib import Path
from gsbench import calibrate_depth, run
torch.set_num_threads(1)
root = Path(sys.argv[1])
for name in [None, *calibrate_depth.FAULTS, "trace"]:
    with calibrate_depth.FAULTS.get(name, contextlib.nullcontext)():
        r, _ = run.run_cell({CELL!r}, {SEED}, 0.01, name == "trace",
                            torch.device("cpu"), root=root)
    print(json.dumps({{"name": name, **r}}), flush=True)
"""


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_cell") / "tiny"
    for d in ("traffic", "metrics", "workloads", "configs"):
        shutil.copytree(ROOT / "gsbench" / d, root / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "configs" / "garden_init_262k.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    path.write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", RUNS, str(root)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["name"]: r for r in map(json.loads,
                                      out.stdout.strip().splitlines())}


def test_a_sound_run_of_the_depth_cell_is_correct(cell_runs):
    r = cell_runs[None]
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"loss", "grad", "change", "stats",
                                "instances", "invdepth"}
    assert r["checks"]["invdepth"]["value"] < 1e-5


@pytest.mark.parametrize("fault", [
    "B4 drops the inverse-depth cotangent",
    "the pack carries z instead of 1/z", "the depth weight is 0"])
def test_a_planted_depth_fault_is_not_correct(cell_runs, fault):
    r = cell_runs[fault]
    assert not r["correct"], r["checks"]


def test_a_traced_run_of_the_depth_cell_reads_its_counter(cell_runs):
    r = cell_runs["trace"]
    assert r["correct"] and r["attempted"] == 5
    metrics = r["metrics"]
    # the CPU runs the plain versions: no kernel launch is counted, no
    # device kernel or mark is traced
    assert metrics["depth.bwd_launches_per_step"]["value"] == 0.0
    assert "kernel.composite_bwd_depth.roofline_pct" not in metrics
    assert "stage.composite_bwd_ms.depth" not in metrics
    assert "kernel.composite_bwd.roofline_pct" not in metrics


def _metric(name):
    return readers.load_all(ROOT / "gsbench" / "metrics")[name]


def _shape():
    return counts.Shape(gaussians=262144, params=59, instances=6_600_000,
                        tiles=82 * 53, pixels=1297 * 840,
                        composited=270_000_000)


def _trace(ops, work, kind="train"):
    return trace_mod.Trace(kind, ops, {"gsbench.train_step": 2}, 1.0, 0.5,
                           [], work)


def test_the_depth_readers_read_the_depth_cell_alone():
    s = _shape()
    work = [(depth_work.train_step(s),
             {"composite_fwd": counts.composite_fwd(s, False),
              "composite_bwd_depth": depth_work.composite_bwd(s),
              depth_train.LAUNCHES: 1.0})] * 2
    span = "gsbench.train_step"

    def op(name, start, dur, graph=True):
        return trace_mod.Op(name, start, dur, graph, span)
    call = [op("rain_mark_loss_bwd", 0.0, 1.0),
            op("composite_depth_bwd_kernel", 2.0, 3000.0),
            op("rain_mark_composite_bwd_B4", 3010.0, 1.0),
            op("index", 3020.0, 900.0), op("reduce_kernel", 3930.0, 100.0),
            op("rain_mark_reduce_B2", 4040.0, 1.0)]
    ops = [o._replace(start=o.start + t) for t in (0.0, 10_000.0)
           for o in call]
    ops.insert(6, op("copy", 5000.0, 5.0, graph=False))
    tr = _trace(ops, work)
    roof = _metric("kernel.composite_bwd_depth.roofline_pct").read(tr)
    want = 100.0 * bound_s(*depth_work.composite_bwd(s)) * 1e3 / 3.0
    assert roof == pytest.approx(want)
    assert 0.0 < roof < 100.0
    stage = _metric("stage.composite_bwd_ms.depth").read(tr)
    assert stage == pytest.approx((3010.0 - 1.0 + 4040.0 - 3011.0) / 1e3)
    assert _metric("depth.bwd_launches_per_step").read(tr) == 1.0
    # the train cell's work holds no depth entry: none of the three reads
    plain = [(counts.train_step(s),
              {"composite_fwd": counts.composite_fwd(s, False),
               "composite_bwd": counts.composite_bwd(s)})] * 2
    for name in ("kernel.composite_bwd_depth.roofline_pct",
                 "stage.composite_bwd_ms.depth",
                 "depth.bwd_launches_per_step"):
        assert _metric(name).read(_trace(ops, plain)) is None, name
        assert _metric(name).read(_trace(ops, [], kind="render")) is None
    # and B4's accepted reader does not take the depth variant for B4
    assert readers.roofline_pct(_trace(ops, plain), "train",
                                "composite_bwd") is None


def test_the_depth_work_adds_to_the_step():
    s = _shape()
    base, more = counts.composite_bwd(s), depth_work.composite_bwd(s)
    assert more.nbytes > base.nbytes and more.ops > base.ops
    assert depth_work.train_step(s).nbytes > counts.train_step(s).nbytes


def test_the_cell_targets_are_smooth_seeded_and_in_range():
    kw = dict(near=2.0, far=12.0, components=4, max_cycles=2.0)
    a = depth_train.targets(5, 40, 64, 7, "cpu", **kw)
    b = depth_train.targets(5, 40, 64, 7, "cpu", **kw)
    c = depth_train.targets(5, 40, 64, 8, "cpu", **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 1 / 12 - 1e-7 and float(a.max()) <= 0.5 + 1e-7
    assert float(a.amax(dim=(1, 2)).min()) > 0.49
    # smooth: neighbouring pixels differ by a small share of the range
    assert float((a[:, :, 1:] - a[:, :, :-1]).abs().max()) < 0.05


def test_the_depth_cell_and_configuration_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["init262k.depth"]["traffic"] == "train_pan_depth"
    assert cells["garden1m.train"]["config"] == "garden_1m"
    assert all(c["chips"] == 1 for n, c in cells.items()
               if n in ("init262k.depth", "garden1m.train"))
    cfg = json.loads((ROOT / "gsbench" / "configs" /
                      "garden_1m.json").read_text())
    assert (cfg["n_gaussians"], cfg["capacity"], cfg["log_scale"],
            cfg["sh_degree"], cfg["f_rest_sigma"]) == \
        (1 << 20, 1 << 20, -5.2, 3, 0.1)
    traffic = json.loads((ROOT / "gsbench" / "traffic" /
                          "train_pan_depth.json").read_text())
    plain = json.loads((ROOT / "gsbench" / "traffic" /
                        "train_pan.json").read_text())
    assert {k: v for k, v in traffic.items() if k not in ("loop", "depth")} \
        == {k: v for k, v in plain.items() if k != "loop"}


def test_a_program_without_the_depth_path_is_refused_at_once(monkeypatch):
    monkeypatch.delattr(step, "DepthTarget")
    with pytest.raises(RuntimeError, match="no depth regularization"):
        depth_train.Loop({}, {}, 0, torch.device("cpu"), object())
