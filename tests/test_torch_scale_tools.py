"""Port parity: the repo's scale and profiling tools in rain_tpu_torch.scripts.

- probe_scale: ``build_tier_state`` equals the arrays that
  tools/probe_scale.py:run_tier builds, bit for bit (state, camera,
  target, background and step arguments, captured by replacing
  rain_tpu's ``train_step`` and the tool's TIERS with a small tier), and
  at 4,096 Gaussians the port's step-0 instance count at bench.py's
  camera and full width equals rain_tpu's (its ``preprocess``, run op by
  op, whose tiles touched ``sorted_pack`` sums), exactly.
- sustained_growth: the scene and the configuration equal the tool's,
  captured by replacing the Trainer it imports and its backend check;
  every scale forced to -4.5.
- knn_deviation: the cloud (captured from rain_tpu's searches) and the
  printed statistics equal the tool's at 3,000 points, exactly: the
  port's searches are rain_tpu's bit for bit on the CPU
  (tests/test_torch_knn.py). Two JAX compilations in the file, both
  here.
- At bench.py's full 1m tier (1,048,576 Gaussians), op by op on the
  CPU, every Gaussian touches the same tiles in the port and in
  rain_tpu, exactly (the compiled comparison, where XLA's fusions round
  a Gaussian apart, is tests/test_torch_projection.py's).
- Each script's ``main`` at toy size (the modules' size constants cut)
  with --device cpu, and summarize_run's text equal to the tool's on a
  run directory of the port's Trainer.
"""

import dataclasses
import importlib.util
import sys
import types
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rain_tpu.cache
import rain_tpu.ops.knn as jknn
import rain_tpu.train.step as jstep
import rain_tpu.train.trainer as jtrainer
from rain_tpu.model import gaussians as jgmod
from rain_tpu.ops import projection as jproj
from rain_tpu_torch import config as tcfg
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.scripts import (composite_micro, knn_deviation,
                                    probe_scale, summarize_run,
                                    sustained_growth, trainer_sustained)
from rain_tpu_torch.train import step as step_mod
from rain_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _shared(cfg, group):
    """A port config group as a dict without the port's own fields
    (rain_tpu has no depth regularization), which hold their defaults."""
    d = dataclasses.asdict(cfg)
    for f in tcfg.PORT_ONLY.get(group, ()):
        assert d.pop(f) == getattr(type(cfg)(), f), (group, f)
    return d


def _toy(monkeypatch, n=2000, width=96, height=64, m=4096):
    """The scripts' scenes cut to ``n`` Gaussians at width x height and
    the instance tier ``m``, through their module constants."""
    monkeypatch.setattr(probe_scale, "TIERS", {
        k: (n, m, log_scale) for k, (_, _, log_scale) in
        probe_scale.TIERS.items()})
    for mod in (probe_scale, sustained_growth):
        monkeypatch.setattr(mod, "WIDTH", width)
        monkeypatch.setattr(mod, "HEIGHT", height)
    for mod in (sustained_growth, composite_micro):
        monkeypatch.setattr(mod, "N", n)
        monkeypatch.setattr(mod, "MAX_INSTANCES", m)


def _tool(monkeypatch, rel):
    """A tool of tools/ as a module (its compile cache left alone)."""
    monkeypatch.setattr(rain_tpu.cache, "enable_compile_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        Path(rel).stem, ROOT / "tools" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiers_are_the_tools(monkeypatch):
    tool = _tool(monkeypatch, "probe_scale.py")
    assert probe_scale.TIERS == tool.TIERS
    assert list(probe_scale.TIERS) == list(tool.TIERS)


def test_build_tier_state_equals_the_tools(monkeypatch):
    """The tool's run_tier at 3,000 Gaussians, its train_step replaced by
    a recorder; the port's build_tier_state equals what it was given."""
    tool = _tool(monkeypatch, "probe_scale.py")
    monkeypatch.delenv("PROBE_TRACE", raising=False)
    monkeypatch.setattr(tool, "TIERS", {"1m": (3000, 8192, -5.2)})
    seen = []
    aux = namedtuple("Aux", "num_instances instance_overflow")(
        np.int32(0), np.bool_(False))

    def train_step(state, opt, camera, gt, bg, low_pass, xyz_lr, **kw):
        seen.append((state, camera, gt, bg, float(low_pass), float(xyz_lr),
                     kw))
        return state, opt, aux

    monkeypatch.setattr(jstep, "train_step", train_step)
    monkeypatch.setattr(sys, "argv", ["probe_scale.py", "1m"])
    tool.main()
    assert len(seen) == 11              # step 0 and the tool's 10
    state, camera, gt, bg, low_pass, xyz_lr, kw = seen[0]

    ts = probe_scale.build_tier_state(3000, -5.2, device="cpu")
    for name, a, b in zip(gmod.GaussianParams._fields, ts.state.params,
                          state.params):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert ts.state.n_alive == int(state.n_alive) == 3000
    assert ts.state.capacity == state.capacity
    for k, v in camera.items():
        np.testing.assert_array_equal(ts.camera[k].numpy(), np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(ts.gt.numpy(), np.asarray(gt))
    np.testing.assert_array_equal(ts.bg.numpy(), np.asarray(bg))
    assert (low_pass, xyz_lr) == (float(np.float32(probe_scale.LOW_PASS)),
                                  float(np.float32(probe_scale.XYZ_LR)))
    assert kw == dict(width=probe_scale.WIDTH, height=probe_scale.HEIGHT,
                      sh_degree=probe_scale.SH_DEGREE, max_instances=8192,
                      opt_cfg_leaves=probe_scale.OPT_LEAVES,
                      update_densify_stats=True)


def _rain_tpu_tiles(ts, sh_degree):
    """rain_tpu's tiles touched per Gaussian of a tier's state at
    bench.py's camera, op by op (no compilation)."""
    js = jgmod.from_arrays(
        *[p.numpy() for p in ts.state.params], capacity=ts.state.capacity)
    scales, quats, opac, shs = jgmod.activate(js.params)
    cam = {k: jnp.asarray(v.numpy()) for k, v in ts.camera.items()}
    w, h = probe_scale.WIDTH, probe_scale.HEIGHT
    with jax.disable_jit():
        prep = jproj.preprocess(
            js.params.xyz, scales, quats, opac, shs[:, :sh_degree + 1],
            jgmod.alive_mask(js), sh_degree=sh_degree,
            world_view=cam["world_view"], full_proj=cam["full_proj"],
            camera_center=cam["camera_center"], tan_fovx=cam["tanfovx"],
            tan_fovy=cam["tanfovy"], width=w, height=h,
            tile_bounds=(0, 0, (w + 15) // 16, (h + 15) // 16),
            low_pass=probe_scale.LOW_PASS)
    return np.asarray(prep.tiles_touched)


def test_step0_instances_match_rain_tpu(monkeypatch):
    """4,096 Gaussians of the 1m tier's scene at bench.py's camera and
    1297x840: the port's step-0 count (probe_scale.run_tier) equals
    rain_tpu's, exactly. Rects do not depend on SH."""
    n, m, log_scale = 4096, 1 << 16, probe_scale.TIERS["1m"][2]
    monkeypatch.setitem(probe_scale.TIERS, "1m", (n, m, log_scale))
    rec = probe_scale.run_tier("1m", device="cpu", iters=0,
                               log_fn=lambda *a: None)
    ts = probe_scale.build_tier_state(n, log_scale, device="cpu")
    want = int(_rain_tpu_tiles(ts, 3).sum())
    assert want > n                     # many Gaussians touch several tiles
    assert rec["instances"] == want and not rec["overflow"]
    assert probe_scale.preprocess_instances(ts) == want
    assert rec["launches"] == dict.fromkeys(rec["launches"], 0)   # CPU


def test_run_tier_compiled_equals_eager_on_the_cpu(monkeypatch):
    """run_tier through the compiled step (its default) and with
    compiled=False, at 3,000 Gaussians: the same instances and the same
    state and Adam state after the same steps, bit for bit; on the CPU the
    compiled step runs the eager one and captures nothing."""
    _toy(monkeypatch, n=3000, m=8192)
    ends = {}
    recs = {}
    for compiled in (True, False):
        recs[compiled] = probe_scale.run_tier(
            "1m", device="cpu", iters=1, log_fn=lambda *a: None,
            compiled=compiled,
            finish=lambda s, o, c=compiled: ends.update({c: (s, o)}))
    got, want = recs[True], recs[False]
    assert (got["path"], want["path"]) == ("compiled", "eager")
    assert got["instances"] == want["instances"] > 0
    assert got["captures"] == [] and len(got["step_ms"]) == 1
    assert got["launches"] == want["launches"]
    (s1, o1), (s2, o2) = ends[True], ends[False]
    assert s1.n_alive == s2.n_alive == 3000 and int(o1.step) == 3
    for a, b in zip(list(s1.params) + list(o1.mu) + list(o1.nu) +
                    [getattr(s1, k) for k in gmod.STAT_FIELDS],
                    list(s2.params) + list(o2.mu) + list(o2.nu) +
                    [getattr(s2, k) for k in gmod.STAT_FIELDS]):
        assert torch.equal(a, b)


def test_1m_tier_instances_on_the_cpu():
    """bench.py's 1m tier at full size: each of the 1,048,576 Gaussians
    touches as many tiles in the port as in rain_tpu run op by op,
    exactly, and preprocess_instances is their sum (1,644,591;
    BENCH_r05.json's TPU run counted 1,644,592)."""
    n, _, log_scale = probe_scale.TIERS["1m"]
    ts = probe_scale.build_tier_state(n, log_scale, device="cpu")
    want = _rain_tpu_tiles(ts, 0)
    scales, quats, opac, shs = gmod.activate(ts.state.params)
    got = probe_scale.projection.preprocess(
        ts.state.params.xyz, scales, quats, opac, shs[:, :1],
        gmod.alive_mask(ts.state), sh_degree=0,
        world_view=ts.camera["world_view"], full_proj=ts.camera["full_proj"],
        camera_center=ts.camera["camera_center"],
        tan_fovx=ts.camera["tanfovx"], tan_fovy=ts.camera["tanfovy"],
        width=probe_scale.WIDTH, height=probe_scale.HEIGHT,
        grid=((probe_scale.WIDTH + 15) // 16,
              (probe_scale.HEIGHT + 15) // 16),
        low_pass=probe_scale.LOW_PASS).tiles_touched.numpy()
    np.testing.assert_array_equal(got, want)
    assert probe_scale.preprocess_instances(ts) == int(want.sum())


def test_sustained_growth_scene_and_configs_equal_the_tools(monkeypatch,
                                                            tmp_path):
    tool = _tool(monkeypatch, "sustained_growth.py")
    got = {}

    class Recorder:
        def __init__(self, scene, cfgs, out, tensorboard=True):
            got.update(scene=scene, cfgs=cfgs, out=out,
                       tensorboard=tensorboard)
            params = namedtuple("P", "scaling")(None)
            self.state = namedtuple("S", "params n_alive capacity")(
                params, 1, 1)
            self.max_instances = 1

        def train(self, **kw):
            got.update(train=kw, scaling=np.asarray(
                self.state.params.scaling))

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jtrainer, "Trainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["sustained_growth.py", "7",
                                      str(tmp_path)])
    tool.main()

    scene = sustained_growth.build_scene()
    assert scene.points.shape == (sustained_growth.N, 3)
    theirs = got["scene"]
    for f in ("points", "colors", "nerf_translate"):
        a, b = getattr(scene, f), getattr(theirs, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert scene.nerf_radius == theirs.nerf_radius
    assert scene.test_cameras == [] == theirs.test_cameras
    assert len(scene.train_cameras) == len(theirs.train_cameras) == 4
    for a, b in zip(scene.train_cameras, theirs.train_cameras):
        assert (a.uid, a.image_name, a.fovx, a.fovy, a.width, a.height) == (
            b.uid, b.image_name, b.fovx, b.fovy, b.width, b.height)
        for f in ("R", "T", "image"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    cfgs = sustained_growth.configs(7)
    for group, theirs in got["cfgs"].items():
        assert _shared(cfgs[group], group) == \
            dataclasses.asdict(theirs), group
    assert got["train"] == dict(iterations=7, test_iterations=(),
                                save_iterations=())
    assert got["scaling"].shape == (sustained_growth.N, 3)
    assert (got["scaling"] == np.float32(sustained_growth.LOG_SCALE)).all()

    rng = np.random.default_rng(0)
    tr = types.SimpleNamespace(state=gmod.from_arrays(
        rng.normal(size=(5, 3)), np.zeros((5, 1, 3)), np.zeros((5, 15, 3)),
        np.full((5, 3), -2.0), np.tile([1.0, 0, 0, 0], (5, 1)),
        np.zeros((5, 1)), capacity=8, device="cpu"))
    sustained_growth.force_scaling(tr)
    assert (tr.state.params.scaling == sustained_growth.LOG_SCALE).all()


def test_trainer_sustained_configs_equal_the_tools(monkeypatch, tmp_path):
    tool = _tool(monkeypatch, "profiling/trainer_sustained.py")
    got = []

    class Recorder:
        def __init__(self, scene, cfgs, out, tensorboard=True):
            got.append(cfgs)
            params = namedtuple("P", "scaling")(None)
            self.state = namedtuple("S", "params")(params)

        def train(self, **kw):
            pass

    monkeypatch.setattr(jtrainer, "Trainer", Recorder)
    for pipeline, densify in ((0, False), (1, True)):
        monkeypatch.setenv("SUSTAINED_PIPELINE", str(pipeline))
        monkeypatch.setenv("SUSTAINED_DENSIFY", "1" if densify else "0")
        monkeypatch.setattr(sys, "argv", ["trainer_sustained.py", "9"])
        tool.main()
        cfgs = trainer_sustained.configs(9, pipeline, densify)
        for group, theirs in got[-1].items():
            assert _shared(cfgs[group], group) == \
                dataclasses.asdict(theirs), (group, pipeline, densify)


def test_knn_deviation_equals_the_tools(monkeypatch, capsys):
    """The tool's run at 3,000 points (rain_tpu's two searches, its
    cloud captured) against the port's: the same cloud bit for bit, and
    the same printed statistics."""
    tool = _tool(monkeypatch, "knn_deviation.py")
    clouds = []
    for name in ("mean_dist3", "mean_dist3_matmul"):
        fn = getattr(jknn, name)

        def wrapped(p, _fn=fn):
            clouds.append(np.asarray(p))
            return _fn(p)

        monkeypatch.setattr(jknn, name, wrapped)
    tool.run(3000)
    theirs = capsys.readouterr().out.strip()
    lines = []
    rec = knn_deviation.run(3000, device="cpu", log_fn=lines.append)
    for c in clouds:
        np.testing.assert_array_equal(knn_deviation.cloud(3000), c)
    # the times differ; every statistic agrees to its printed digits
    mine, theirs = lines[0].split(" | "), theirs.split(" | ")
    assert mine[1:3] == theirs[1:3]
    assert mine[3].startswith(theirs[3].removesuffix(")"))
    assert rec["rows_below_bound"] == 0 and rec["rel_max"] > 0


CPU = ["--device", "cpu"]


@pytest.mark.parametrize("script,argv", [
    (probe_scale, ["1m", "--iters", "1"] + CPU),
    (sustained_growth, ["--iterations", "12"] + CPU),
    (trainer_sustained, ["--iterations", "3", "--pipeline", "0"] + CPU),
    (composite_micro, ["--reps", "1"] + CPU),
    (knn_deviation, ["3000"] + CPU),
], ids=["probe_scale", "sustained_growth", "trainer_sustained",
        "composite_micro", "knn_deviation"])
def test_main_at_toy_size_on_the_cpu(script, argv, monkeypatch, tmp_path):
    _toy(monkeypatch)
    if script in (sustained_growth, trainer_sustained):
        argv = argv + ["--out", str(tmp_path / "out")]
    if script is probe_scale:
        argv = argv + ["--trace", str(tmp_path / "trace"),
                       "--out", str(tmp_path / "probe.json")]
    steps = []
    real_step = step_mod.train_step
    monkeypatch.setattr(step_mod, "train_step", lambda *a, **k: (
        steps.append(1), real_step(*a, **k))[1])
    out = script.main(argv)
    if script is probe_scale:
        (rec,) = out
        assert rec["instances"] > 0 and not rec["overflow"]
        assert (rec["n"], rec["width"], rec["height"]) == (2000, 96, 64)
        assert len(rec["step_ms"]) == 1
        assert (tmp_path / "trace" / "1m.json").exists()
        assert (tmp_path / "probe.json").exists()
    elif script is sustained_growth:
        assert out.iteration == 12 and out.state.n_alive == 2000
        assert out.state.params.xyz.device.type == "cpu"
    elif script is knn_deviation:
        assert out[0]["n"] == 3000 and out[0]["rows_below_bound"] == 0
    else:
        assert out["device"] == "cpu"
    if script is trainer_sustained:
        # the warm-up iteration, then the timed loop's 3 from iteration 1
        assert len(steps) == 1 + 3 and out["iterations"] == 3


def test_summarize_run_equals_the_tool(monkeypatch, capsys, tmp_path):
    """A port Trainer's run directory (two reports) and its log,
    summarised by the port's copy and by the tool."""
    _toy(monkeypatch, n=500, width=64, height=48)
    scene = sustained_growth.build_scene(0)
    scene = dataclasses.replace(scene, test_cameras=[Camera(
        uid=9, image_name="t", R=np.eye(3), T=np.zeros(3), fovx=1.0,
        fovy=0.7, image=scene.train_cameras[0].image, width=64, height=48)])
    log = []
    tr = Trainer(scene, sustained_growth.configs(4),
                 str(tmp_path / "run"), device="cpu", log_fn=log.append,
                 tensorboard=False)
    tr.train(iterations=4, test_iterations=(2, 4), save_iterations=())
    (tmp_path / "run.log").write_text("\n".join(f"[+1.00s] {m}"
                                                for m in log))
    args = [str(tmp_path / "run"), str(tmp_path / "run.log")]
    text = summarize_run.main(args)
    capsys.readouterr()
    tool = _tool(monkeypatch, "summarize_run.py")
    monkeypatch.setattr(sys, "argv", ["summarize_run.py"] + args)
    tool.main()
    assert capsys.readouterr().out.strip() == text.strip()
    rows = [r for r in text.splitlines() if r[:3] in ("| 2", "| 4")]
    assert len(rows) == 2                           # the two reports
    assert "final cumulative rate:" in text and "at iter 4" in text
