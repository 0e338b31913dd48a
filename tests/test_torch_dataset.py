"""The port's scene loaders (rain_tpu_torch/data/dataset.py) against
rain_tpu's: counterparts of tests/test_cli_e2e.py:139-249.

Both packages' ``load_scene`` read the same on-disk scenes (the COLMAP and
Blender scenes of tests/test_cli_e2e.py) with the same
``np.random.default_rng`` seeds. Tolerance: none. Cameras (R, T, fov,
size, image and the matrices made from them), points and colours are equal
bit for bit for every init policy, for the Blender loader on white and
black backgrounds, for the text-format sparse model and for render_only;
``_resolution_for`` gives the same table, and point-cloud PLYs written by
either package read back the same in the other. No JAX computation runs.
"""

import dataclasses
import shutil
import sys

import numpy as np
import pytest
import torch

from rain_tpu import config as cfg_jax
from rain_tpu.data import dataset as dataset_jax
from rain_tpu.data import ply as ply_jax
from rain_tpu_torch import config as cfg_port
from rain_tpu_torch.data import dataset as dataset_port
from rain_tpu_torch.data import ply as ply_port
from test_cli_e2e import (_binary_to_text_sparse, blender_scene,  # noqa: F401
                          colmap_scene)

torch.set_num_threads(1)

CAMERA_ARRAYS = ("world_view", "full_proj", "camera_center")


def _bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _same_cameras(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                _bits(a, b, f"{w.image_name}.{f.name}")
            else:
                assert type(a) is type(b) and a == b, (w.image_name, f.name)
        for k in CAMERA_ARRAYS:
            _bits(getattr(g, k), getattr(w, k), f"{w.image_name}.{k}")


def _same_scene(got, want):
    _same_cameras(got.train_cameras, want.train_cameras)
    _same_cameras(got.test_cameras, want.test_cameras)
    _bits(got.points, want.points, "points")
    _bits(got.colors, want.colors, "colors")
    assert got.nerf_radius == want.nerf_radius
    _bits(got.nerf_translate, want.nerf_translate, "nerf_translate")
    assert got.ply_path == want.ply_path


def _both(root, rain=None, seed=0, **kw):
    """load_scene of each package with its own RainParams, and a fresh
    default_rng(seed) each."""
    scenes = []
    for dataset, cfg in ((dataset_port, cfg_port), (dataset_jax, cfg_jax)):
        extra = {} if rain is None else \
            {"rain_cfg": cfg.RainParams(**rain)}
        scenes.append(dataset.load_scene(
            str(root), rng=np.random.default_rng(seed), **extra, **kw))
    return scenes


POLICIES = {
    "sfm": {},
    "noisy_sfm": {"train_from": "noisy_sfm"},
    "reprojection": {"ours_new": True, "train_from": "reprojection"},
    "cluster": {"ours_new": True, "train_from": "cluster"},
    "noisy_cluster": {"ours_new": True, "train_from": "noisy_sfm"},
    "paper_random": {"paper_random": True, "num_gaussians": 1234},
    "ours": {"ours": True, "num_gaussians": 777},
    "ours_new_random": {"ours_new": True, "num_gaussians": 555},
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_colmap_init_policies(colmap_scene, policy):  # noqa: F811
    root = colmap_scene[0]
    got, want = _both(root, POLICIES[policy], seed=11, num_cams=3,
                      resolution=1, load_images=(policy == "sfm"))
    _same_scene(got, want)
    assert len(got.points) > 0


@pytest.mark.parametrize("policy", ["cluster", "noisy_cluster"])
def test_cluster_voxel_fallback_without_sklearn(colmap_scene, policy,
                                                monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    got, want = _both(colmap_scene[0], POLICIES[policy], seed=5,
                      num_cams=3, load_images=False)
    _same_scene(got, want)


def test_colmap_images_and_split(colmap_scene):  # noqa: F811
    got, want = _both(colmap_scene[0], {}, num_cams=2, resolution=-1)
    _same_scene(got, want)
    assert len(got.train_cameras) == 2 and got.train_cameras[0].image.shape \
        == (3, 48, 64)
    # resolution 2 resizes through PIL (the same filter in both packages)
    got, want = _both(colmap_scene[0], {}, num_cams=3, resolution=2)
    _same_scene(got, want)
    assert got.test_cameras[0].image.shape == (3, 24, 32)


def test_colmap_text_sparse(colmap_scene, tmp_path):  # noqa: F811
    root = colmap_scene[0]
    troot = tmp_path / "text_scene"
    _binary_to_text_sparse(root, troot / "sparse" / "0")
    shutil.copytree(root / "images", troot / "images")
    got, want = _both(troot, {}, num_cams=3, resolution=1)
    _same_scene(got, want)


def test_render_only(colmap_scene, tmp_path):  # noqa: F811
    root = colmap_scene[0]
    ro = tmp_path / "ro"
    shutil.copytree(root, ro)
    rng = np.random.default_rng(2)
    ply_jax.write_point_cloud(ro / "result.ply",
                              rng.normal(size=(50, 3)),
                              rng.integers(0, 256, (50, 3)))
    got, want = _both(ro, {}, num_cams=3, render_only=True,
                      load_images=False)
    _same_scene(got, want)
    assert len(got.train_cameras) == 6 and not got.test_cameras
    # a result.ply that is not a point cloud: no points, as in rain_tpu
    shutil.copy(ro / "images" / "img_000.png", ro / "result.ply")
    got, want = _both(ro, {}, num_cams=3, render_only=True,
                      load_images=False)
    _same_scene(got, want)


@pytest.mark.parametrize("white", [True, False])
def test_blender_loader(blender_scene, white):  # noqa: F811
    got, want = _both(blender_scene, white_background=white, seed=4)
    _same_scene(got, want)
    assert got.points.shape == (100_000, 3)
    got, want = _both(blender_scene, white_background=white,
                      eval_split=False, load_images=False)
    _same_scene(got, want)


def test_blender_loader_with_points3d(blender_scene, tmp_path):  # noqa: F811
    root = tmp_path / "b"
    shutil.copytree(blender_scene, root)
    rng = np.random.default_rng(9)
    ply_port.write_point_cloud(root / "points3d.ply",
                               rng.normal(size=(300, 3)),
                               rng.integers(0, 256, (300, 3)))
    got, want = _both(root, white_background=True)
    _same_scene(got, want)
    assert got.points.shape == (300, 3)


def test_resolution_table():
    for w in (1, 640, 799, 1600, 1601, 3200, 4946):
        for h in (1, 480, 1000, 3264):
            for flag in (-1, 1, 2, 4, 8, 3, 400, 1000):
                for scale in (1.0, 2.0):
                    assert dataset_port._resolution_for(w, h, flag, scale) \
                        == dataset_jax._resolution_for(w, h, flag, scale)


def test_point_cloud_ply_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(100, 3))
    rgb = rng.integers(0, 256, (100, 3)) * 1.0
    for writer, reader in ((ply_port, ply_jax), (ply_jax, ply_port),
                           (ply_port, ply_port)):
        path = tmp_path / f"{writer.__name__}.ply"
        writer.write_point_cloud(path, xyz, rgb)
        want = ply_jax.read_point_cloud(path)
        for a, b in zip(reader.read_point_cloud(path), want):
            _bits(a, b, "point cloud")
    # the two writers' files are the same bytes
    assert (tmp_path / "rain_tpu_torch.data.ply.ply").read_bytes() == \
        (tmp_path / "rain_tpu.data.ply.ply").read_bytes()
