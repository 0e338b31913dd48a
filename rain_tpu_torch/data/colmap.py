"""COLMAP sparse-reconstruction parsing (binary and text).

A copy of rain_tpu/data/colmap.py (numpy only), the counterpart of the
reference struct-unpack parser (scene/colmap_loader.py:65-224), rewritten
with vectorized numpy record reads where the layout allows (points3D) and
single-pass buffer walking elsewhere. One difference: the native parser
(rain_tpu_torch.native) is taken whenever a C compiler exists, and a
failed build or a file it cannot parse raises, where rain_tpu drops
silently to the Python parser. Neither parser keeps the images' 2D points
or their point3D ids (nor does rain_tpu's).

Formats (COLMAP's own layouts):
  cameras.bin:  camera_id i32, model_id i32, width u64, height u64,
                params f64[num_params(model)]
  images.bin:   image_id i32, qvec f64[4], tvec f64[3], camera_id i32,
                name cstr, num_points2D u64, then (x f64, y f64, id i64)*
  points3D.bin: id u64, xyz f64[3], rgb u8[3], error f64,
                track_len u64, (image_id i32, point2D_idx i32)*
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np


def _native():
    from rain_tpu_torch import native
    return native.load()


def parser() -> str:
    """"native" or "python": the parser of images.bin and points3D.bin."""
    return "python" if _native() is None else "native"


def _parse_failed(path):
    raise ValueError(f"{path}: the native COLMAP parser could not read it "
                     f"(missing or truncated)")


# model_id → (name, num_params); scene/colmap_loader.py CAMERA_MODELS
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec):
    """(scene/colmap_loader.py:32-42)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    cams = {}
    for _ in range(n):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, np_ = CAMERA_MODELS[model_id]
        params = np.frombuffer(data, "<f8", np_, off).copy()
        off += 8 * np_
        cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                 np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_binary(path) -> dict[int, ColmapImage]:
    lib = _native()
    if lib is not None:
        return _read_images_binary_native(lib, path)
    return _read_images_binary_py(path)


def _read_images_binary_native(lib, path):
    import ctypes
    # first call sizes the buffers (cap=0 walk), second fills them
    n = lib.colmap_parse_images(str(path).encode(), None, None, None,
                                None, 0)
    if n < 0:
        _parse_failed(path)
    qvec = np.empty((n, 4))
    tvec = np.empty((n, 3))
    ids = np.empty((n, 2), np.int32)
    names = np.zeros((n, 256), np.uint8)
    n2 = lib.colmap_parse_images(
        str(path).encode(),
        qvec.ctypes.data_as(ctypes.c_void_p),
        tvec.ctypes.data_as(ctypes.c_void_p),
        ids.ctypes.data_as(ctypes.c_void_p),
        names.ctypes.data_as(ctypes.c_void_p), n)
    if n2 != n:
        _parse_failed(path)
    images = {}
    for i in range(n):
        name = bytes(names[i]).split(b"\0", 1)[0].decode("utf-8")
        images[int(ids[i, 0])] = ColmapImage(
            int(ids[i, 0]), qvec[i].copy(), tvec[i].copy(),
            int(ids[i, 1]), name)
    return images


def _read_images_binary_py(path) -> dict[int, ColmapImage]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    images = {}
    for _ in range(n):
        iid = struct.unpack_from("<i", data, off)[0]
        vals = struct.unpack_from("<7d", data, off + 4)
        cam_id = struct.unpack_from("<i", data, off + 60)[0]
        off += 64
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (npts,) = struct.unpack_from("<Q", data, off)
        off += 8 + 24 * npts          # skip 2D points (x, y, point3D_id)
        images[iid] = ColmapImage(iid, np.array(vals[:4]),
                                  np.array(vals[4:7]), cam_id, name)
    return images


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    lines = [l.strip() for l in Path(path).read_text().splitlines()
             if l.strip() and not l.startswith("#")]
    for meta in lines[::2]:           # every other line is the 2D point list
        p = meta.split()
        images[int(p[0])] = ColmapImage(
            int(p[0]), np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]), int(p[8]), p[9])
    return images


def read_points3d_binary(path):
    """(xyz [N,3], rgb [N,3], error [N,1]); the native C parser
    (rain_tpu_torch/native/colmap_fast.c) unless no C compiler exists."""
    lib = _native()
    if lib is None:
        return _read_points3d_binary_py(path)
    import ctypes
    n = lib.colmap_parse_points3d(str(path).encode(), None, None, None, 0)
    if n < 0:
        _parse_failed(path)
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n, 1))
    n2 = lib.colmap_parse_points3d(
        str(path).encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p),
        err.ctypes.data_as(ctypes.c_void_p), n)
    if n2 != n:
        _parse_failed(path)
    return xyz, rgb.astype(np.float64), err


def _read_points3d_binary_py(path):
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n, 1))
    off = 8
    buf = memoryview(data)
    for i in range(n):
        xyz[i] = np.frombuffer(buf, "<f8", 3, off + 8)
        rgb[i] = np.frombuffer(buf, "u1", 3, off + 32)
        err[i] = struct.unpack_from("<d", buf, off + 35)[0]
        (track_len,) = struct.unpack_from("<Q", buf, off + 43)
        off += 51 + 8 * track_len
    return xyz, rgb.astype(np.float64), err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        p = line.split()
        xyz.append([float(x) for x in p[1:4]])
        rgb.append([float(x) for x in p[4:7]])
        err.append([float(p[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def load_sparse(sparse_dir):
    """Load {cameras, images, points} preferring binary (dataset_readers
    readColmapSceneInfo fallback order, :119-131)."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        cams = read_cameras_binary(sparse_dir / "cameras.bin")
        images = read_images_binary(sparse_dir / "images.bin")
    else:
        cams = read_cameras_text(sparse_dir / "cameras.txt")
        images = read_images_text(sparse_dir / "images.txt")
    return cams, images
