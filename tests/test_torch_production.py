"""Port parity: the 30k production run (rain_tpu_torch.scripts.production_30k).

- The seeded scene at full size (600k target, 60+6 views of 1297x840,
  150k init) equals tools/run_production_30k.py's, imported by path, bit
  for bit: its build_target and build_cameras on default_rng(11), then
  its init subsample and noise (:222-226). Ground truth view 0's
  instances name the knobs of round 5's logs: the tool's defaults (ring
  8, no scale shift) are its third attempt's, ring 14 and shift 0.56 its
  final run's.
- render_targets at a small size (3,000 Gaussians, 160x112,
  max_instances 16,384) against rain_tpu.train.step.eval_render on the
  same state at rtol 1e-4 / atol 3e-5 (one JAX compilation); an overflow
  raises.
- The CLI on the CPU at a small size: 20 iterations with checkpoints at
  2 and 10, then a second call that resumes from chkpnt10 (not chkpnt2)
  and reaches 12.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rain_tpu.model import gaussians as jgmod
from rain_tpu.ops.sh import rgb_to_sh_dc as j_rgb_to_sh_dc
from rain_tpu.train import step as jstep
from rain_tpu_torch.ops import projection as tproj
from rain_tpu_torch.scripts import production_30k as prod

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(target_n=3000, width=160, height=112, n_train=6, n_test=2,
             init_n=1000)


def _tool(monkeypatch):
    """tools/run_production_30k.py as a module, with its environment knobs
    unset (their defaults are the port's flags' defaults)."""
    monkeypatch.delenv("RUN_RING_RADIUS", raising=False)
    monkeypatch.delenv("RUN_TARGET_SCALE_SHIFT", raising=False)
    spec = importlib.util.spec_from_file_location(
        "run_production_30k", ROOT / "tools" / "run_production_30k.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_equals_the_tools_bit_for_bit(monkeypatch):
    tool = _tool(monkeypatch)
    assert (tool.TARGET_N, tool.WIDTH, tool.HEIGHT, tool.N_TRAIN,
            tool.N_TEST, tool.INIT_N, tool.RING_R, tool.SCALE_SHIFT) == (
        prod.TARGET_N, prod.WIDTH, prod.HEIGHT, prod.N_TRAIN, prod.N_TEST,
        prod.INIT_N, prod.RING_RADIUS, prod.TARGET_SCALE_SHIFT)
    rng = np.random.default_rng(11)
    pts, cols, log_scales = tool.build_target(rng)
    train, test = tool.build_cameras(rng)
    sel = rng.choice(pts.shape[0], tool.INIT_N, replace=False)
    init_pts = pts[sel] + rng.normal(0, 0.01, (tool.INIT_N, 3)
                                     ).astype(np.float32)
    init_cols = np.clip(cols[sel] + rng.normal(0, 0.05, (tool.INIT_N, 3)),
                        0, 1).astype(np.float32)

    sc = prod.build_scene()
    for name, a, b in (("pts", sc.pts, pts), ("cols", sc.cols, cols),
                       ("log_scales", sc.log_scales, log_scales),
                       ("init_pts", sc.init_pts, init_pts),
                       ("init_cols", sc.init_cols, init_cols)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sc.pts.shape == (600_000, 3) and sc.init_pts.shape == (150_000, 3)
    for mine, theirs in ((sc.train_cameras, train), (sc.test_cameras, test)):
        assert [c.uid for c in mine] == [c.uid for c in theirs]
        for a, b in zip(mine, theirs):
            assert (a.image_name, a.width, a.height, a.fovx, a.fovy) == (
                b.image_name, b.width, b.height, b.fovx, b.fovy)
            np.testing.assert_array_equal(a.R, b.R)
            np.testing.assert_array_equal(a.T, b.T)
            np.testing.assert_array_equal(a.full_proj, b.full_proj)
    assert len(sc.train_cameras) == 60 and len(sc.test_cameras) == 6


@pytest.mark.parametrize("knobs,count", [
    # the tool's defaults: round 5's third attempt
    # (docs/runs/production_30k_r5_attempt3.log:3)
    ((8.0, 0.0), 2_487_335),
    # round 5's run (docs/runs/production_30k_r5.log:3): the ring of 14
    # that docs/runs/README.md:13-14 names, and the scale shift of 0.56
    ((14.0, 0.56), 3_332_871)])
def test_view0_instances_name_round5s_knobs(knobs, count):
    """Ground truth view 0's instances at full size, the sum of its tiles
    touched (no render needed), within 0.1 % of the count in round 5's
    log for each configuration."""
    ring, shift = knobs
    rng = np.random.default_rng(prod.SEED)
    pts, cols, log_scales = prod.build_target(rng, scale_shift=shift)
    cam = prod.build_cameras(rng, ring_radius=ring)[0][0]
    n = pts.shape[0]
    shs = torch.zeros((n, 16, 3))
    shs[:, 0] = torch.from_numpy(prod.rgb_to_sh_dc(cols))
    quats = torch.zeros((n, 4))
    quats[:, 0] = 1.0
    ci = cam.render_inputs("cpu")
    prep = tproj.preprocess(
        torch.from_numpy(pts), torch.exp(torch.from_numpy(log_scales)),
        quats, torch.sigmoid(torch.full((n,), prod.GT_OPACITY)), shs,
        torch.ones(n, dtype=torch.bool), sh_degree=3,
        world_view=ci["world_view"], full_proj=ci["full_proj"],
        camera_center=ci["camera_center"], tan_fovx=ci["tanfovx"],
        tan_fovy=ci["tanfovy"], width=prod.WIDTH, height=prod.HEIGHT,
        grid=(82, 53), low_pass=0.3)
    got = int(prep.tiles_touched.to(torch.int64).sum())
    assert abs(got - count) <= 1e-3 * count, got


def test_render_targets_match_rain_tpu():
    sc = prod.build_scene(**SMALL)
    cams = sc.test_cameras + sc.train_cameras[:1]
    images, instances = prod.render_targets(
        cams, sc.pts, sc.cols, sc.log_scales, device="cpu",
        max_instances=16_384, log_fn=lambda *a: None)
    n = sc.pts.shape[0]
    state = jgmod.from_arrays(
        xyz=sc.pts, f_dc=j_rgb_to_sh_dc(sc.cols)[:, None, :],
        f_rest=np.zeros((n, 15, 3), np.float32), scaling=sc.log_scales,
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n, 1), prod.GT_OPACITY, np.float32), capacity=n)
    for cam, img, count in zip(cams, images, instances):
        out = jstep.eval_render(
            state, {k: jnp.asarray(v) for k, v in
                    cam.render_inputs("cpu").items()},
            jnp.zeros(3, jnp.float32), jnp.asarray(0.3, jnp.float32),
            width=160, height=112, sh_degree=3, max_instances=16_384)
        assert not bool(out.overflow) and count == int(out.num_instances)
        assert img.dtype == np.float32 and img.shape == (3, 112, 160)
        np.testing.assert_allclose(
            img, np.asarray(jnp.clip(out.render, 0.0, 1.0)), rtol=1e-4,
            atol=3e-5)
    assert images[0].std() > 0.05


def test_render_targets_raise_on_overflow():
    sc = prod.build_scene(**SMALL)
    with pytest.raises(RuntimeError, match="overflow at view 0"):
        prod.render_targets(sc.test_cameras, sc.pts, sc.cols, sc.log_scales,
                            device="cpu", max_instances=1024,
                            log_fn=lambda *a: None)


def test_newest_checkpoint_goes_by_iteration_number(tmp_path):
    assert prod.newest_checkpoint(tmp_path) is None
    for it in (2, 10, 9):
        (tmp_path / f"chkpnt{it}.npz").touch()
    assert prod.newest_checkpoint(tmp_path).name == "chkpnt10.npz"


def test_cli_runs_and_resumes_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(prod, "GT_MAX_INSTANCES", 1 << 15)
    out = tmp_path / "run"
    argv = [str(out), "--device", "cpu", "--target_n", "2000", "--width",
            "96", "--height", "64", "--n_train", "3", "--n_test", "1",
            "--init_n", "500"]
    first = prod.main(argv + ["--iterations", "20", "--test_iterations",
                              "20", "--save_iterations",
                              "--checkpoint_iterations", "2", "10"])
    tr = first.trainer
    assert first.first_iteration == 0 and tr.iteration == 20
    assert tr.state.params.xyz.device.type == "cpu"
    assert len(first.gt_instances) == 4 and min(first.gt_instances) > 0
    assert tr.history[-1]["iteration"] == 20 and \
        np.isfinite(tr.history[-1]["test"]["psnr"])
    # the production preset with c2f, as the tool sets them
    assert tr.rain.c2f and tr.system.log_every == 50 and \
        tr.system.max_capacity == 1 << 23
    assert {p.name for p in out.glob("chkpnt*.npz")} == {
        "chkpnt2.npz", "chkpnt10.npz"}
    second = prod.main(argv + ["--iterations", "12", "--test_iterations",
                               "--save_iterations",
                               "--checkpoint_iterations"])
    assert second.first_iteration == 10 and second.trainer.iteration == 12
    log = capsys.readouterr().out
    assert f"[resume] from {out / 'chkpnt10.npz'}" in log
    assert "this process ran iterations 11-12 in" in log
