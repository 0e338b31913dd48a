"""The long end-to-end run in the port (rain_tpu_torch/scripts/e2e_long.py)
against rain_tpu's (tests/test_e2e_long.py), on the CPU.

(a) The scene against ``_gt_scene``: cameras, init points and colours bit
    for bit; the ground-truth images at the oracle tolerances (rtol 1e-4,
    atol 3e-5), where each value past them is a threshold flip that an
    f64 render settles (tests/torch_gt_images.py); the same instance
    count and overflow flag in every view (rain_tpu's read by wrapping
    its render).
(b) The iteration-0 report prints docs/runs/e2e_long_tpu_r4.log's digits
    (test: L1 0.02702, PSNR 24.22, SSIM 0.8591; train: 0.03217, 23.54,
    0.8218; e2e_long_cpu_r3.log has the same).
(c) The run cut at iteration 500, whose densify round makes the first
    capacity growth (512 -> 4,096; rain_tpu's TPU log grows there too):
    the growth event at 500, capacity 4,096, a finite loss and report.

The full 2,500 iterations and the test's five assertions run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 13). One JAX compilation
(``_gt_scene``'s interpret render); the cut run takes ~3 min here.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_gt_images as gt_images
from rain_tpu_torch.scripts import e2e_long

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TPU_LOG = ROOT / "docs" / "runs" / "e2e_long_tpu_r4.log"
CUT = 500          # the densify round of the first capacity growth


@pytest.fixture(scope="module")
def scene():
    return e2e_long.gt_scene(device="cpu")


@pytest.fixture(scope="module")
def cut_run(scene, tmp_path_factory):
    lines = []
    rec = e2e_long.run(scene, str(tmp_path_factory.mktemp("e2e") / "out"),
                       stop=CUT, device="cpu", log=lines.append)
    return rec, lines


def _jax_scene(monkeypatch):
    """rain_tpu's scene, with each ground-truth render's instance count and
    overflow flag."""
    from rain_tpu.ops import render as jrender
    from test_e2e_long import _gt_scene
    seen = []
    render = jrender.render

    def recorded(*a, **kw):
        out = render(*a, **kw)
        seen.append((int(out.num_instances), bool(out.overflow)))
        return out

    monkeypatch.setattr(jrender, "render", recorded)
    return _gt_scene(), seen


def test_scene_matches_rain_tpu(scene, monkeypatch):
    jscene, seen = _jax_scene(monkeypatch)
    cams = scene.train_cameras + scene.test_cameras
    jcams = jscene.train_cameras + jscene.test_cameras
    assert [c.image_name for c in cams] == [c.image_name for c in jcams]
    assert len(scene.test_cameras) == len(jscene.test_cameras) == 3
    for c, j in zip(cams, jcams):
        for f in ("R", "T", "world_view", "full_proj", "camera_center"):
            assert np.array_equal(getattr(c, f), getattr(j, f)), f
        assert (c.uid, c.fovx, c.fovy, c.width, c.height) == \
            (j.uid, j.fovx, j.fovy, j.width, j.height)
    for f in ("points", "colors", "nerf_translate"):
        a, b = getattr(scene, f), getattr(jscene, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert scene.nerf_radius == jscene.nerf_radius
    assert list(zip(scene.gt_instances, scene.gt_overflow)) == seen
    assert not any(scene.gt_overflow)
    # raises unless every value past the tolerances is a flip that the
    # f64 render settles (59 values of 4 views here, either way round)
    gt_images.compare([c.image for c in cams], [j.image for j in jcams],
                      gt_images.F64Views())


def _log_digits(split):
    line = next(s for s in TPU_LOG.read_text().splitlines()
                if s.startswith(f"[ITER 0] Evaluating {split}:"))
    l1, psnr, ssim = re.search(r"L1 (\S+) PSNR (\S+) SSIM (\S+)",
                               line).groups()
    return l1, psnr, ssim


def test_iteration_0_report_prints_the_logs_digits(cut_run):
    rec, lines = cut_run
    for split in ("test", "train"):
        assert e2e_long.LOG_ITER0[split] == _log_digits(split)
    assert e2e_long.units_off(rec["report0"]) == {
        "test": (0, 0, 0), "train": (0, 0, 0)}, rec["report0"]
    assert any("[ITER 0] Evaluating test: L1 0.02702 PSNR 24.22 SSIM 0.8591"
               in s for s in lines)


def test_run_crosses_the_first_capacity_growth(cut_run):
    rec, _ = cut_run
    growths = [e for e in rec["cap_events"]
               if "growing capacity" in e["line"]]
    assert [e["iteration"] for e in growths] == [CUT], rec["cap_events"]
    assert growths[0]["line"].startswith("[cap] growing capacity 512 -> 4096")
    assert rec["capacity"] == 4096 and rec["stop"] == CUT
    assert 150 < rec["n_alive"] <= 4096
    assert math.isfinite(rec["ema_loss"]) and rec["ema_loss"] > 0
    final = rec["final"]
    assert final["iteration"] == CUT
    assert all(math.isfinite(final[s][k]) for s in ("test", "train")
               for k in ("l1", "psnr", "ssim"))
    assert final["test"]["psnr"] > rec["report0"]["test"]["psnr"]
    ply = Path(rec["trainer"].model_path) / "point_cloud" / \
        f"iteration_{CUT}" / "point_cloud.ply"
    assert ply.is_file()


def test_check_holds_the_tests_assertions():
    """``check`` raises on the first of the test's five assertions that
    fails, in the test's order."""
    good = {"n_alive": 1500, "capacity": 4096, "final": {
        "test": {"psnr": 32.3}}, "report0": {"test": {"psnr": 24.22}},
        "cap_events": [{"iteration": 500, "line":
                        "[cap] growing capacity 512 -> 4096 (alive 272)"}]}
    e2e_long.check(good)
    bad = [({"n_alive": 1499}, "fewer than 1500"),
           ({"capacity": 512}, "no growth"),
           ({"cap_events": [{"iteration": 500, "line":
                             "[cap] densify overflow"}]}, "no capacity"),
           ({"final": {"test": {"psnr": 26.0}}}, "not above 26"),
           ({"final": {"test": {"psnr": 32.2}}}, "8.0 dB")]
    for change, match in bad:
        with pytest.raises(AssertionError, match=match):
            e2e_long.check({**good, **change})
