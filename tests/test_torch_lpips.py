"""The port's LPIPS (rain_tpu_torch/eval/lpips.py) against rain_tpu's.

Both packages' ``make_lpips`` get the random VGG16 and linear-head weights
of tests/test_lpips.py:23-35, with and without the linear heads, on the
same pair of images. Tolerance: rtol 1e-5 — the two sum the same f32
products in different orders (XLA's convolution and einsum against
F.conv2d's), which leaves a few ulps on a sum of five spatial means.
The weights also load from ``$RAIN_TPU_LPIPS_VGG`` / ``$RAIN_TPU_LPIPS_LIN``
through ``torch.load(weights_only=True)``; without them
``lpips_fn_or_none`` returns None and warns once per process. With them,
both metrics CLIs agree on SSIM, PSNR and LPIPS at the same rtol, and
``Trainer.report`` gains the lpips key.
"""

import numpy as np
import pytest
import torch

from rain_tpu.eval import lpips as lpips_jax
from rain_tpu_torch.eval import lpips as lpips_port
from test_lpips import _random_weights

torch.set_num_threads(1)

RTOL = 1e-5


def _images(h=40, w=48, seed=1):
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0,
                   1).astype(np.float32)
    return img1, img2


@pytest.fixture
def weights_env(tmp_path, monkeypatch):
    """The random weights saved as state dicts, named by the two
    environment variables; the loader's cache cleared around the test."""
    convs, lins = _random_weights()
    vgg_sd = {}
    for idx, (w, b) in zip(lpips_port.VGG_CONV_IDX, convs):
        vgg_sd[f"features.{idx}.weight"] = torch.from_numpy(w)
        vgg_sd[f"features.{idx}.bias"] = torch.from_numpy(b)
    torch.save(vgg_sd, tmp_path / "vgg.pth")
    torch.save({f"{i}.1.weight": torch.from_numpy(l)
                for i, l in enumerate(lins)}, tmp_path / "lin.pth")
    monkeypatch.setenv("RAIN_TPU_LPIPS_VGG", str(tmp_path / "vgg.pth"))
    monkeypatch.setenv("RAIN_TPU_LPIPS_LIN", str(tmp_path / "lin.pth"))
    lpips_port._load_weights.cache_clear()
    lpips_jax._load_weights.cache_clear()
    yield convs, lins
    lpips_port._load_weights.cache_clear()
    lpips_jax._load_weights.cache_clear()


@pytest.mark.parametrize("with_lins", [True, False])
def test_make_lpips_matches_rain_tpu(with_lins):
    convs, lins = _random_weights()
    lins = lins if with_lins else None
    img1, img2 = _images()
    want = float(lpips_jax.make_lpips(convs, lins)(img1, img2))
    fn = lpips_port.make_lpips(convs, lins, device="cpu")
    got = fn(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    assert float(fn(torch.from_numpy(img1), torch.from_numpy(img1))) < 1e-6


def test_weights_from_the_environment(weights_env):
    convs, lins = weights_env
    fn = lpips_port.lpips_fn_or_none(device="cpu")
    assert fn is not None
    img1, img2 = _images(32, 32, seed=2)
    want = float(lpips_jax.make_lpips(convs, lins)(img1, img2))
    got = float(fn(torch.from_numpy(img1), torch.from_numpy(img2)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_without_weights_none_and_one_warning(monkeypatch):
    monkeypatch.delenv("RAIN_TPU_LPIPS_VGG", raising=False)
    monkeypatch.delenv("RAIN_TPU_LPIPS_LIN", raising=False)
    monkeypatch.setattr(lpips_port, "_warned", False)
    lpips_port._load_weights.cache_clear()
    msgs = []
    try:
        assert lpips_port.lpips_fn_or_none(log_fn=msgs.append) is None
        assert lpips_port.lpips_fn_or_none(log_fn=msgs.append) is None
    finally:
        lpips_port._load_weights.cache_clear()
    assert len(msgs) == 1 and "LPIPS" in msgs[0]


def test_metrics_cli_lpips_matches_rain_tpu(weights_env, tmp_path):
    """Both metrics CLIs on the same renders and ground truth: SSIM, PSNR
    and LPIPS at rtol 1e-5."""
    import json
    from rain_tpu.scripts import metrics as metrics_jax
    from rain_tpu_torch.data import images
    from rain_tpu_torch.scripts import metrics as metrics_port
    rng = np.random.default_rng(4)
    method = tmp_path / "m" / "test" / "ours_7"
    for i in range(2):
        gt = rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
        noise = rng.integers(-20, 21, gt.shape)
        images.save_png(method / "gt" / f"{i:05d}.png", gt)
        images.save_png(method / "renders" / f"{i:05d}.png",
                        np.clip(gt + noise, 0, 255).astype(np.uint8))
    want = metrics_jax.evaluate([tmp_path / "m"])
    got = metrics_port.main(["-m", str(tmp_path / "m"), "--device", "cpu"])
    assert set(got[str(tmp_path / "m")]["ours_7"]) == {"SSIM", "PSNR",
                                                       "LPIPS"}
    for k, v in want[str(tmp_path / "m")]["ours_7"].items():
        np.testing.assert_allclose(got[str(tmp_path / "m")]["ours_7"][k], v,
                                   rtol=RTOL)
    assert "LPIPS" in json.loads((tmp_path / "m" / "per_view.json")
                                 .read_text())["ours_7"]


def test_trainer_report_has_lpips(weights_env, tmp_path):
    """With the weights, Trainer.report gains the lpips key, in its return
    value and in log_file.txt: the mean of lpips over the views."""
    import json
    from rain_tpu_torch import config as cfg_mod
    from rain_tpu_torch.data.cameras import Camera
    from rain_tpu_torch.data.dataset import SceneData
    from rain_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (150, 2)),
                          rng.uniform(3, 5, (150, 1))], 1).astype(np.float32)
    cams = [Camera(uid=i, image_name=f"c{i}", R=np.eye(3),
                   T=np.array([0.1 * i, 0, 0]), fovx=0.8, fovy=0.6,
                   width=32, height=32,
                   image=rng.uniform(0, 1, (3, 32, 32)).astype(np.float32))
            for i in range(2)]
    scene = SceneData(cams[:1], cams[1:], pts,
                      np.full((150, 3), 0.5, np.float32), 1.0, np.zeros(3))
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("t").parse_args([]))
    tr = Trainer(scene, cfgs, str(tmp_path), device="cpu",
                 log_fn=lambda *a: None, tensorboard=False)
    res = tr.report(0)
    fn = lpips_port.make_lpips(*weights_env, device="cpu")
    out = tr._report_render(0, cams[1], tr._camera_bundle(cams[1])[0])
    want = float(fn(torch.clamp(out.render, 0, 1),
                    torch.from_numpy(cams[1].image)))
    assert res["test"]["lpips"] == want
    assert {"psnr", "l1", "ssim", "lpips"} == set(res["train"])
    logged = json.loads((tmp_path / "log_file.txt").read_text())
    assert logged["test"]["lpips"] == want
