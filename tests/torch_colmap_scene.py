"""A COLMAP scene written to disk with numpy, struct and the port's PNG
encoder (no PIL, no jax): binary ``sparse/0/{cameras,images,points3D}.bin``
and ``images/*.png``, in COLMAP's own layouts.

The toy scene is tests/test_cli_e2e.py's (cameras on a circle looking at a
cube of points, gradient images). chip_smoke.py writes its full-size
scene with ``write_colmap_scene`` and loads this file by path, so it
imports numpy and the port only.
"""

import json
import struct
import zlib
from pathlib import Path

import numpy as np

from rain_tpu_torch.data import images


def rotmat2qvec(R):
    """Inverse of colmap.qvec2rotmat (Shepperd's method by the symmetric
    eigenproblem, as COLMAP does)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def look_at(pos):
    """World-to-camera rotation with camera +z toward the origin."""
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])       # rows: x, y, z camera axes


def write_colmap_scene(root, views, width, height, fx, fy, xyz, rgb, err):
    """views: [(name, R_w2c [3,3], t [3], uint8 [H, W, 3] image)]; one
    PINHOLE camera; points with empty tracks. Returns the sparse dir."""
    root = Path(root)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    buf = struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, width, height)
    buf += struct.pack("<4d", fx, fy, width / 2, height / 2)
    (sparse / "cameras.bin").write_bytes(buf)
    buf = struct.pack("<Q", len(views))
    for i, (name, R, t, image) in enumerate(views):
        buf += struct.pack("<i7di", i + 1, *rotmat2qvec(R), *t, 1)
        buf += name.encode() + b"\x00" + struct.pack("<Q", 0)
        images.save_png(root / "images" / name, image)
    (sparse / "images.bin").write_bytes(buf)
    rec = np.zeros(len(xyz), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"], rec["rgb"], rec["err"] = xyz, rgb, err
    (sparse / "points3D.bin").write_bytes(
        struct.pack("<Q", len(xyz)) + rec.tobytes())
    return sparse


def toy_scene(root, width=64, height=48, n_cams=6, n_pts=400, seed=7):
    """tests/test_cli_e2e.py:_write_colmap_scene's scene, written without
    PIL. Returns (xyz, rgb, err)."""
    rng = np.random.default_rng(seed)
    views = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        pos = np.array([4.0 * np.cos(ang), 4.0 * np.sin(ang), 1.5])
        R = look_at(pos)
        img = np.zeros((height, width, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, width)[None, :]
        img[..., 1] = np.linspace(0, 255, height)[:, None]
        img[..., 2] = int(255 * i / n_cams)
        views.append((f"img_{i:03d}.png", R, -R @ pos, img))
    xyz = rng.uniform(-1, 1, (n_pts, 3))
    rgb = rng.integers(0, 255, (n_pts, 3))
    err = rng.random(n_pts) * 2.0
    write_colmap_scene(root, views, width, height, 60.0, 60.0, xyz, rgb, err)
    return xyz, rgb, err


def save_png16(path, raw):
    """A 16-bit grey PNG of uint16 [H, W] ``raw`` (the format of upstream's
    inverse depth maps), every row filter type 0."""
    raw = np.asarray(raw, np.uint16)
    h, w = raw.shape

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = raw.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" +
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)) +
        chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
        chunk(b"IEND", b""))


def toy_depths(root, folder="depths", scales=(1.0, 1.2, 0.1, 0.9, 1.1, 1.0),
               offsets=(0.05, -0.02, 0.0, 0.01, -0.3, 0.02), width=64,
               height=48, seed=8):
    """Inverse depth maps of the toy scene's views, ``<folder>/img_###.png``
    (16-bit, seeded smooth ramps at half the images' size, so the loader
    resizes them), and ``sparse/0/depth_params.json`` with each view's
    scale and offset. Returns {image name: raw uint16 [h, w]}."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / folder).mkdir(exist_ok=True)
    h, w = height // 2, width // 2
    raws, params = {}, {}
    for i, (sc, off) in enumerate(zip(scales, offsets)):
        name = f"img_{i:03d}"
        ramp = np.linspace(0.1, 0.6, w)[None, :] + \
            np.linspace(0.0, 0.3, h)[:, None] + rng.uniform(0, 0.02, (h, w))
        raws[name] = np.round(ramp * 65535 / 0.95).astype(np.uint16)
        save_png16(root / folder / f"{name}.png", raws[name])
        params[name] = {"scale": sc, "offset": off}
    (root / "sparse" / "0" / "depth_params.json").write_text(
        json.dumps(params))
    return raws
