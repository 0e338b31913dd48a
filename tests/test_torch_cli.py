"""The port's CLIs (rain_tpu_torch/scripts/{train,render,metrics}.py) with
``--device cpu``: counterparts of tests/test_cli_e2e.py:252-476, and
parity with rain_tpu's CLIs on tests/test_cli_e2e.py's COLMAP scene.

Both train CLIs get the same argv (10 iterations, a report and a PLY at
10, a checkpoint at 5), each from its own working directory so that
``-m out`` names the same relative path. Tolerances:
- ``cfg_args.json`` equal; ``input.ply`` equal byte for byte;
  ``cameras.json`` equal to 1e-12;
- the report's L1, PSNR and SSIM at 10 at rtol 1e-4, the bar of
  tests/test_torch_trainer.py:26 (the Trainers' losses);
- the port's render CLI on rain_tpu's PLY: every PNG within 1 LSB of
  rain_tpu's (both truncate to uint8; a value on a 1/255 boundary can land
  on either side of it);
- the port's metrics CLI on rain_tpu's renders: rtol 1e-5 (the same PNGs;
  the SSIM blurs sum in different orders).
rain_tpu's run makes two JAX interpret compilations: its training step,
and one eval_render shared by its report and its render CLI (capacity 400
and tier 262,144 in both).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from rain_tpu_torch.data import dataset as dataset_port
from rain_tpu_torch.data import images
from rain_tpu_torch.eval import lpips as lpips_port
from rain_tpu_torch.scripts import metrics as metrics_port
from rain_tpu_torch.scripts import render as render_port
from rain_tpu_torch.scripts import train as train_port
from test_cli_e2e import (N_CAMS, _binary_to_text_sparse,  # noqa: F401
                          colmap_scene)

torch.set_num_threads(1)

ITERS = 10
CPU = ["--device", "cpu"]


def _argv(root):
    return ["-s", str(root), "-m", "out", "--iterations", str(ITERS),
            "--test_iterations", str(ITERS), "--save_iterations", str(ITERS),
            "--checkpoint_iterations", "5", "--num_cams", "3",
            "--capacity", "400", "--max_instances", "262144",
            "--resolution", "1", "--quiet"]


@pytest.fixture(scope="module")
def runs(colmap_scene, tmp_path_factory):  # noqa: F811
    """rain_tpu's train, render and metrics CLIs, then the port's train
    CLI with the same argv. Returns (rain_tpu's model dir, the port's,
    rain_tpu's results.json, its per_view.json)."""
    from rain_tpu.scripts import metrics as metrics_jax
    from rain_tpu.scripts import render as render_jax
    from rain_tpu.scripts import train as train_jax

    root = colmap_scene[0]
    mp = pytest.MonkeyPatch()
    try:
        jax_dir = tmp_path_factory.mktemp("jax")
        mp.chdir(jax_dir)
        train_jax.main(_argv(root))
        render_jax.main(["-m", "out"])
        metrics_jax.main(["-m", "out"])
        port_dir = tmp_path_factory.mktemp("port")
        mp.chdir(port_dir)
        train_port.main(_argv(root) + CPU)
    finally:
        mp.undo()
    jax_out = jax_dir / "out"
    return (jax_out, port_dir / "out",
            json.loads((jax_out / "results.json").read_text()),
            json.loads((jax_out / "per_view.json").read_text()))


def test_train_cli_matches_rain_tpu(runs):
    jax_out, port_out, *_ = runs
    assert json.loads((port_out / "cfg_args.json").read_text()) == \
        json.loads((jax_out / "cfg_args.json").read_text())
    assert (port_out / "command_line.txt").read_text() == \
        (jax_out / "command_line.txt").read_text()
    assert (port_out / "input.ply").read_bytes() == \
        (jax_out / "input.ply").read_bytes()
    got = json.loads((port_out / "cameras.json").read_text())
    want = json.loads((jax_out / "cameras.json").read_text())
    assert len(got) == len(want) == N_CAMS
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("id", "img_name", "width", "height")} == \
            {k: w[k] for k in ("id", "img_name", "width", "height")}
        for k in ("position", "rotation", "fx", "fy"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)
    got = json.loads((port_out / "log_file.txt").read_text().splitlines()[-1])
    want = json.loads((jax_out / "log_file.txt").read_text().splitlines()[-1])
    assert got["iteration"] == want["iteration"] == ITERS
    assert set(got) == set(want) == {"iteration", "test", "train"}
    for split in ("test", "train"):
        assert set(got[split]) == set(want[split]) == {"l1", "psnr", "ssim"}
        for k in ("l1", "psnr", "ssim"):
            np.testing.assert_allclose(got[split][k], want[split][k],
                                       rtol=1e-4)
    for d in (port_out, jax_out):
        assert (d / "chkpnt5.npz").exists()
        assert (d / "point_cloud" / f"iteration_{ITERS}" /
                "point_cloud.ply").exists()


def _pngs(d):
    return sorted(p.relative_to(d) for p in d.rglob("*.png"))


def test_render_cli_on_rain_tpu_ply(runs, tmp_path):
    jax_out = runs[0]
    copy = tmp_path / "out"
    shutil.copytree(jax_out, copy)
    for p in copy.rglob("*.png"):
        p.unlink()
    assert render_port.main(["-m", str(copy)] + CPU) == []
    names = _pngs(jax_out)
    assert names == _pngs(copy)
    # renders, depth, depth_inferno and gt of 3 train and 3 test views
    assert len(names) == 4 * N_CAMS
    for name in names:
        want = images.load(jax_out / name).astype(int)
        got = images.load(copy / name).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name


def test_metrics_cli_matches_rain_tpu(runs, tmp_path):
    jax_out, _, results, per_view = runs
    copy = tmp_path / "out"
    shutil.copytree(jax_out, copy)
    metrics_port.main(["-m", str(copy)] + CPU)
    got = json.loads((copy / "results.json").read_text())
    assert set(got) == set(results) == {f"ours_{ITERS}"}
    for method, entry in results.items():
        assert set(got[method]) == set(entry)
        for k, v in entry.items():
            np.testing.assert_allclose(got[method][k], v, rtol=1e-5)
    got = json.loads((copy / "per_view.json").read_text())
    for method, metrics in per_view.items():
        for k, views in metrics.items():
            assert set(got[method][k]) == set(views)
            for name, v in views.items():
                np.testing.assert_allclose(got[method][k][name], v,
                                           rtol=1e-5)


def test_train_render_metrics_cli(runs, tmp_path):
    """The port's own run, rendered and scored by the port (counterpart of
    test_cli_e2e.py:test_train_render_metrics_cli)."""
    out = tmp_path / "out"
    shutil.copytree(runs[1], out)
    assert (out / "command_line.txt").exists()
    rec = json.loads((out / "log_file.txt").read_text().splitlines()[-1])
    assert rec["iteration"] == ITERS and np.isfinite(rec["test"]["psnr"])
    render_port.main(["-m", str(out)] + CPU)
    test_dir = out / "test" / f"ours_{ITERS}"
    for kind in ("renders", "gt", "depth", "depth_inferno"):
        assert len(list((test_dir / kind).iterdir())) == 3
    assert len(list((out / "train" / f"ours_{ITERS}" / "renders")
                    .iterdir())) == 3
    metrics_port.main(["-m", str(out)] + CPU)
    entry = json.loads((out / "results.json").read_text())[f"ours_{ITERS}"]
    assert np.isfinite(entry["PSNR"]) and entry["PSNR"] > 5.0
    assert -1.0 <= entry["SSIM"] <= 1.0
    per_view = json.loads((out / "per_view.json").read_text())
    assert len(per_view[f"ours_{ITERS}"]["PSNR"]) == 3


def test_train_cli_resume_from_checkpoint(runs, colmap_scene,  # noqa: F811
                                          tmp_path):
    """--start_checkpoint resumes at the saved iteration (train.py:41-43)."""
    out = tmp_path / "resumed"
    trainer = train_port.main(
        ["-s", str(colmap_scene[0]), "-m", str(out), "--iterations", "8",
         "--test_iterations", "-1", "--num_cams", "3", "--capacity", "400",
         "--max_instances", "262144", "--resolution", "1", "--quiet",
         "--start_checkpoint", str(runs[1] / "chkpnt5.npz")] + CPU)
    assert trainer.iteration == 8 and int(trainer.opt_state.step) == 8
    assert (out / "point_cloud" / "iteration_8" / "point_cloud.ply").exists()


def test_text_sparse_loads_as_binary(colmap_scene, tmp_path):  # noqa: F811
    root = colmap_scene[0]
    troot = tmp_path / "text_scene"
    _binary_to_text_sparse(root, troot / "sparse" / "0")
    shutil.copytree(root / "images", troot / "images")
    kw = dict(num_cams=3, load_images=False)
    sb = dataset_port.load_scene(str(root), **kw)
    st = dataset_port.load_scene(str(troot), **kw)
    assert np.array_equal(st.points, sb.points)
    assert np.array_equal(st.colors, sb.colors)
    for ca, cb in zip(st.train_cameras + st.test_cameras,
                      sb.train_cameras + sb.test_cameras):
        assert np.array_equal(ca.R, cb.R) and np.array_equal(ca.T, cb.T)
        assert ca.fovx == cb.fovx and ca.fovy == cb.fovy


def test_render_only_from_result_ply(runs, colmap_scene,  # noqa: F811
                                     tmp_path):
    """--render_only keeps every camera in the train split
    (reference render.py:78, dataset_readers.py:215)."""
    ro_scene = tmp_path / "ro_scene"
    shutil.copytree(colmap_scene[0], ro_scene)
    out = tmp_path / "out"
    shutil.copytree(runs[1], out)
    shutil.copy(out / "point_cloud" / f"iteration_{ITERS}" /
                "point_cloud.ply", ro_scene / "result.ply")
    render_port.main(["-m", str(out), "-s", str(ro_scene), "--render_only",
                      "--num_cams", "3", "--resolution", "1"] + CPU)
    renders = list((out / "train" / f"ours_{ITERS}" / "renders").iterdir())
    assert len(renders) == N_CAMS


def test_render_cli_explicit_override(runs, tmp_path):
    """--white_background passed explicitly wins over the saved config."""
    out = tmp_path / "out"
    shutil.copytree(runs[1], out)
    render_port.main(["-m", str(out), "--skip_train"] + CPU)
    p = sorted((out / "test" / f"ours_{ITERS}" / "renders").iterdir())[0]
    black_mean = images.load(p).astype(np.float32).mean()
    render_port.main(["-m", str(out), "--skip_train", "--white_background"]
                     + CPU)
    white_mean = images.load(p).astype(np.float32).mean()
    assert white_mean > black_mean + 50.0


def test_metrics_cli_warns_once_without_lpips(runs, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.delenv("RAIN_TPU_LPIPS_VGG", raising=False)
    monkeypatch.setattr(lpips_port, "_warned", False)
    lpips_port._load_weights.cache_clear()
    out = tmp_path / "out"
    shutil.copytree(runs[0], out)
    metrics_port.main(["-m", str(out)] + CPU)
    metrics_port.main(["-m", str(out)] + CPU)
    assert capsys.readouterr().out.count("[lpips] VGG weights unavailable") \
        == 1
    assert "LPIPS" not in json.loads((out / "results.json").read_text())[
        f"ours_{ITERS}"]


@pytest.mark.parametrize("cli", ["train", "render", "metrics"])
def test_cli_without_device_needs_a_card(cli, colmap_scene,  # noqa: F811
                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = tmp_path / "out"
    argv = {"train": ["-s", str(colmap_scene[0]), "-m", str(out)],
            "render": ["-m", str(out), "-s", str(colmap_scene[0])],
            "metrics": ["-m", str(out)]}[cli]
    main = {"train": train_port.main, "render": render_port.main,
            "metrics": metrics_port.main}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not out.exists()
