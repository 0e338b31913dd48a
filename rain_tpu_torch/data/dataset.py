"""Scene assembly: load COLMAP/Blender datasets, splits, init point clouds.

A copy of rain_tpu/data/dataset.py (numpy only), the counterpart of
reference scene/dataset_readers.py + scene/__init__.py: camera loading
with the resolution policy, the every-Nth train/test split, nerf++
normalization, and all the initialization-point-cloud policies (SfM /
noisy_sfm / reprojection-filtered / cluster / paper_random / "ours"
camera-cube random / Blender random).

Images are loaded into float32 [3, H, W] in [0, 1] with the same bits as
rain_tpu's PIL path: PNG by ``images`` (numpy and zlib), JPEG and resizing
by PIL, which then must import. Blender RGBA is composited over the
background (dataset_readers.py:254-258). The loaders return numpy, and
their ``rng`` draws are rain_tpu's calls in rain_tpu's order, so the init
points are the same bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from rain_tpu_torch.data import colmap as colmap_io
from rain_tpu_torch.data import images
from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.data.cameras import (Camera, focal2fov, fov2focal,
                                         world_to_view)
from rain_tpu_torch.ops.sh import sh_dc_to_rgb


@dataclasses.dataclass
class SceneData:
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    points: np.ndarray          # [N, 3]
    colors: np.ndarray          # [N, 3] in [0, 1]
    nerf_radius: float          # cameras_extent (scene/__init__.py:61)
    nerf_translate: np.ndarray
    ply_path: str | None = None


def _load_image(path, resolution, bg=None):
    arr = np.asarray(images.load(path, resolution), np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    if arr.shape[2] == 4:
        if bg is None:
            rgb = arr[:, :, :3] * arr[:, :, 3:4]
        else:
            rgb = arr[:, :, :3] * arr[:, :, 3:4] + \
                np.asarray(bg, np.float32) * (1 - arr[:, :, 3:4])
        arr = rgb
    return np.clip(arr[:, :, :3].transpose(2, 0, 1), 0.0, 1.0)


def _resolution_for(orig_w, orig_h, resolution_flag, scale=1.0):
    """The loadCam resolution policy (utils/camera_utils.py:8-31):
    -1 → cap width at 1600 px; 1/2/4/8 → divide; other → target width."""
    if resolution_flag in (1, 2, 4, 8):
        return (round(orig_w / (scale * resolution_flag)),
                round(orig_h / (scale * resolution_flag)))
    if resolution_flag == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution_flag
    s = float(global_down) * float(scale)
    return (int(orig_w / s), int(orig_h / s))


def nerfpp_norm(cameras: list[Camera]):
    """(getNerfppNorm, dataset_readers.py:34-55)."""
    centers = []
    for cam in cameras:
        w2c = world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = float(np.linalg.norm(centers - avg, axis=0).max())
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def load_colmap_scene(source_path, *, images_dir="images", eval_split=True,
                      num_cams=10, resolution=-1, rain_cfg=None,
                      load_images=True, render_only=False,
                      result_ply=None, rng=None) -> SceneData:
    """readColmapSceneInfo (dataset_readers.py:118-227)."""
    rng = rng or np.random.default_rng(0)
    source = Path(source_path)
    sparse = source / "sparse" / "0"
    cams, imgs = colmap_io.load_sparse(sparse)

    cam_infos = []
    for iid in imgs:
        extr = imgs[iid]
        intr = cams[extr.camera_id]
        R = colmap_io.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = intr.params[0]
        elif intr.model in ("PINHOLE", "OPENCV", "RADIAL"):
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(f"unsupported camera model {intr.model}")
        fovy = focal2fov(fy, intr.height)
        fovx = focal2fov(fx, intr.width)
        img_path = source / images_dir / os.path.basename(extr.name)
        cam_infos.append((img_path.stem, R, T, fovx, fovy, img_path,
                          intr.width, intr.height))
    cam_infos.sort(key=lambda c: c[0])

    def build(idx, info):
        name, R, T, fovx, fovy, img_path, w, h = info
        image = None
        if load_images:
            res = _resolution_for(*images.size(img_path), resolution)
            image = _load_image(img_path, res)
            h, w = image.shape[1], image.shape[2]
        else:
            res = _resolution_for(w, h, resolution)
            w, h = res
        return Camera(uid=idx, image_name=name, R=R, T=T, fovx=fovx,
                      fovy=fovy, image=image, width=w, height=h)

    # every-Nth split with llffhold = n_cams / num_cams
    # (dataset_readers.py:133-140)
    llffhold = len(cam_infos) / num_cams
    if eval_split and not render_only:
        train_idx = [i for i in range(len(cam_infos)) if i % llffhold == 0]
    else:
        train_idx = list(range(len(cam_infos)))
    train_cams = [build(i, cam_infos[i]) for i in train_idx]
    test_cams = [build(i, cam_infos[i]) for i in range(len(cam_infos))
                 if i not in set(train_idx)] if eval_split and not render_only \
        else []

    norm = nerfpp_norm(train_cams)

    if render_only:
        # the reference tolerates a result.ply that is not a color point
        # cloud (e.g. a trained-Gaussian PLY): fetchPly is wrapped in
        # try/except and the pcd is unused by the render flow
        # (dataset_readers.py:215-220 — the model itself is loaded from
        # the model dir's point_cloud snapshot)
        try:
            pts, colors, _ = ply_io.read_point_cloud(
                result_ply or source / "result.ply")
        except Exception:
            pts = np.zeros((0, 3), np.float32)
            colors = np.zeros((0, 3), np.float32)
        return SceneData(train_cams, test_cams, pts, colors,
                         norm["radius"], norm["translate"])

    pts, colors = _init_points_colmap(source, sparse, imgs, norm, rain_cfg,
                                      rng)
    return SceneData(train_cams, test_cams, pts, colors,
                     norm["radius"], norm["translate"])


def _init_points_colmap(source, sparse, imgs, norm, rain_cfg, rng):
    """Initialization-point-cloud policies (dataset_readers.py:145-216)."""
    def read_sfm():
        if (sparse / "points3D.bin").exists():
            return colmap_io.read_points3d_binary(sparse / "points3D.bin")
        return colmap_io.read_points3d_text(sparse / "points3D.txt")

    train_from = getattr(rain_cfg, "train_from", "random")
    paper_random = getattr(rain_cfg, "paper_random", False)
    ours = getattr(rain_cfg, "ours", False)
    ours_new = getattr(rain_cfg, "ours_new", False)
    num_gaussians = getattr(rain_cfg, "num_gaussians", 1_000_000)

    if not (paper_random or ours or ours_new):
        xyz, rgb, _ = read_sfm()
        if train_from == "noisy_sfm":
            xyz = xyz + rng.normal(0, 1.0, xyz.shape)
            rgb = np.clip(rgb + rng.normal(0, 1.0, rgb.shape), 0, 255)
        return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32)

    if not ours and train_from == "reprojection":
        xyz, rgb, error = read_sfm()
        thr = np.percentile(error[:, 0], 10)
        keep = error[:, 0] < thr
        return (xyz[keep].astype(np.float32),
                (rgb[keep] / 255.0).astype(np.float32))

    if not ours and train_from in ("cluster", "noisy_sfm"):
        xyz, rgb, _ = read_sfm()
        if train_from == "noisy_sfm":
            xyz = xyz + rng.normal(0, 1.0, xyz.shape)
        try:
            from sklearn.cluster import HDBSCAN
            xyz = HDBSCAN(min_cluster_size=5,
                          store_centers="both").fit(xyz).centroids_
        except ImportError:
            # fall back to voxel downsampling when sklearn is unavailable
            vox = np.round(xyz / (norm["radius"] * 0.01))
            _, idx = np.unique(vox, axis=0, return_index=True)
            xyz = xyz[idx]
        shs = rng.random((len(xyz), 3))
        return xyz.astype(np.float32), sh_dc_to_rgb(shs).astype(np.float32)

    # random initializations
    if paper_random:
        xyz = (rng.random((num_gaussians, 3)) * norm["radius"] * 3 -
               norm["radius"] * 1.5) + norm["translate"]
    else:
        # "ours" camera-cube random (dataset_readers.py:196-210)
        cam_pos = np.array([imgs[k].tvec for k in imgs])
        mn, mx = cam_pos.min(), cam_pos.max()
        mean = (mn + mx) / 2.0
        cube_mean = (mx - mn) * 1.5
        xyz = rng.random((num_gaussians, 3)) * (mx - mn) * 3 - \
            (cube_mean - mean)
    shs = rng.random((num_gaussians, 3))
    return xyz.astype(np.float32), sh_dc_to_rgb(shs).astype(np.float32)


def load_blender_scene(source_path, *, white_background=False,
                       eval_split=True, load_images=True,
                       rng=None) -> SceneData:
    """readNerfSyntheticInfo (dataset_readers.py:231-300)."""
    rng = rng or np.random.default_rng(0)
    source = Path(source_path)

    def read_transforms(fname, start_uid=0):
        contents = json.loads((source / fname).read_text())
        fovx = contents["camera_angle_x"]
        cams = []
        bg = np.ones(3) if white_background else np.zeros(3)
        for idx, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            img_path = source / (frame["file_path"] + ".png")
            image = None
            if load_images:
                image = _load_image(img_path, None, bg=bg)
                h, w = image.shape[1], image.shape[2]
            else:
                w, h = images.size(img_path)
            fovy = focal2fov(fov2focal(fovx, w), h)
            cams.append(Camera(uid=start_uid + idx, image_name=img_path.stem,
                               R=R, T=T, fovx=fovx, fovy=fovy, image=image,
                               width=w, height=h))
        return cams

    train_cams = read_transforms("transforms_train.json")
    test_cams = read_transforms("transforms_test.json", len(train_cams))
    if not eval_split:
        train_cams = train_cams + test_cams
        test_cams = []
    norm = nerfpp_norm(train_cams)

    ply_path = source / "points3d.ply"
    if ply_path.exists():
        pts, colors, _ = ply_io.read_point_cloud(ply_path)
    else:
        num_pts = 100_000
        pts = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
        shs = rng.random((num_pts, 3)) / 255.0
        colors = sh_dc_to_rgb(shs).astype(np.float32)
    return SceneData(train_cams, test_cams, pts, colors,
                     norm["radius"], norm["translate"],
                     ply_path=str(ply_path))


def load_scene(source_path, **kwargs) -> SceneData:
    """Dataset-type dispatch (scene/__init__.py:28-34)."""
    source = Path(source_path)
    if (source / "sparse").exists():
        blender_keys = {"white_background"}
        cfg = {k: v for k, v in kwargs.items() if k not in blender_keys}
        return load_colmap_scene(source_path, **cfg)
    if (source / "transforms_train.json").exists():
        colmap_keys = {"images_dir", "num_cams", "resolution", "rain_cfg",
                       "render_only", "result_ply"}
        cfg = {k: v for k, v in kwargs.items() if k not in colmap_keys}
        return load_blender_scene(source_path, **cfg)
    raise ValueError(f"Could not recognize scene type at {source_path}")
