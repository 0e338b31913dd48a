"""PLY reading/writing with the 3DGS attribute schema.

A copy of rain_tpu/data/ply.py (numpy only) for the trained-Gaussian
schema: x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*
(scene/gaussian_model.py:167-198); f_rest is flattened channel-major
(transpose(1,2).flatten), so files interchange bit-for-bit with the JAX
package and the reference's save_ply/load_ply. The point-cloud schema of
the data loaders comes with the data slice.

Supports binary_little_endian and ascii on read; writes binary.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the (first) vertex element into a dict of 1-D arrays."""
    data = Path(path).read_bytes()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_str)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("list properties not supported")
            elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))

    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")

    out = {}
    offset = 0
    for name, count, props in elements:
        if fmt == "binary_little_endian":
            dt = np.dtype([(p, "<" + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
        else:
            txt = np.loadtxt(io.BytesIO(body), max_rows=count, ndmin=2)
            dt = np.dtype([(p, t) for p, t in props])
            arr = np.zeros(count, dt)
            for i, (p, _) in enumerate(props):
                arr[p] = txt[:, i]
        if name == "vertex":
            for p, _ in props:
                out[p] = np.ascontiguousarray(arr[p])
            break
    if not out:
        raise ValueError(f"{path}: no vertex element")
    return out


def write_ply(path, columns: list[tuple[str, np.ndarray]]):
    """Write named float32/uint8 columns as a binary vertex element."""
    n = len(columns[0][1])
    dt = np.dtype([(name, col.dtype.str) for name, col in columns])
    arr = np.zeros(n, dt)
    for name, col in columns:
        arr[name] = col
    types = {"<f4": "float", "|u1": "uchar", "<f8": "double",
             "<i4": "int", "<u4": "uint"}
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}"]
    for name, col in columns:
        lines.append(f"property {types[col.dtype.str]} {name}")
    lines.append("end_header\n")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode("ascii"))
        f.write(arr.tobytes())


def write_gaussians(path, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """save_ply schema (gaussian_model.py:181-198).

    f_dc [N,1,3], f_rest [N,K-1,3] are flattened channel-major
    (transpose(1,2) then flatten) to match the reference byte-for-byte.
    """
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    f_dc_flat = np.asarray(f_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest_flat = np.asarray(f_rest, np.float32).transpose(0, 2, 1).reshape(
        n, -1)
    opacity = np.asarray(opacity, np.float32).reshape(n, -1)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)

    cols = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
            ("nx", np.zeros(n, np.float32)), ("ny", np.zeros(n, np.float32)),
            ("nz", np.zeros(n, np.float32))]
    cols += [(f"f_dc_{i}", f_dc_flat[:, i]) for i in range(f_dc_flat.shape[1])]
    cols += [(f"f_rest_{i}", f_rest_flat[:, i])
             for i in range(f_rest_flat.shape[1])]
    cols += [("opacity", opacity[:, 0])]
    cols += [(f"scale_{i}", scaling[:, i]) for i in range(scaling.shape[1])]
    cols += [(f"rot_{i}", rotation[:, i]) for i in range(rotation.shape[1])]
    write_ply(path, cols)


def read_gaussians(path, max_sh_degree: int = 3):
    """load_ply (gaussian_model.py:205-246). Returns dict of arrays with
    the model's [N, K, 3] feature layout."""
    v = read_ply(path)
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.zeros((n, 3, 1), np.float32)
    for i in range(3):
        f_dc[:, i, 0] = v[f"f_dc_{i}"]
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    expected = 3 * (max_sh_degree + 1) ** 2 - 3
    assert len(rest_names) == expected, (len(rest_names), expected)
    f_rest = np.zeros((n, 3, len(rest_names) // 3), np.float32)
    flat = np.stack([v[k] for k in rest_names], axis=1)
    f_rest = flat.reshape(n, 3, -1)
    scale_names = sorted((k for k in v if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([v[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = sorted((k for k in v if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([v[k] for k in rot_names], axis=1).astype(np.float32)
    return {
        "xyz": xyz,
        # [N, 3, K] channel-major on disk → model layout [N, K, 3]
        "f_dc": f_dc.transpose(0, 2, 1),
        "f_rest": f_rest.transpose(0, 2, 1),
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }
