"""The PNGs the port's numpy decoder does not read go through PIL, as
rain_tpu reads every image.

rain_tpu opens every image with PIL (rain_tpu/data/dataset.py:39-54,
rain_tpu/scripts/metrics.py:18-24). The port decodes 8-bit non-interlaced
PNGs with numpy and sends every other PNG to PIL. The files here are
written by hand with zlib (``_png``): 16-bit RGB and RGBA, 16-bit grey,
1-bit and 2-bit grey, a 4-bit palette, and Adam7-interlaced 8-bit RGB
(at a size where every pass holds pixels, and at one where some are
empty) and 16-bit grey. Both packages' ``_load_image`` (at the file's
size and resized) and both metrics readers (``_load_dir``) are compared
bit for bit. With PIL blocked, each of these files raises RuntimeError
naming it, and an 8-bit PNG still decodes.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from rain_tpu.data import dataset as dataset_jax
from rain_tpu.scripts import metrics as metrics_jax
from rain_tpu_torch.data import dataset as dataset_port
from rain_tpu_torch.data import images
from rain_tpu_torch.scripts import metrics as metrics_port

torch.set_num_threads(1)

# (passes of Adam7: x0, y0, dx, dy; PNG spec 8.2)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _scanlines(px, depth):
    """Filter-type-0 rows of samples ``px`` [h, w, c] at ``depth`` bits."""
    h = px.shape[0]
    if h == 0 or px.shape[1] == 0:
        return b""
    flat = px.reshape(h, -1)
    if depth == 16:
        body = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        body = flat.astype(np.uint8)
    else:
        # samples packed big-endian into bytes, the last byte padded
        per = 8 // depth
        n = flat.shape[1]
        padded = np.zeros((h, -(-n // per) * per), np.uint8)
        padded[:, :n] = flat
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        body = (padded.reshape(h, -1, per) << shifts).sum(
            axis=2, dtype=np.uint8)
    rows = np.zeros((h, body.shape[1] + 1), np.uint8)
    rows[:, 1:] = body
    return rows.tobytes()


def _png(px, depth, ctype, palette=None, interlace=0):
    """A PNG of samples ``px`` [h, w] or [h, w, c], written with zlib."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, c = px.shape
    assert c == SAMPLES[ctype]
    if interlace:
        raw = b"".join(_scanlines(px[y0::dy, x0::dx], depth)
                       for x0, y0, dx, dy in ADAM7)
    else:
        raw = _scanlines(px, depth)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))

    out = images.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _case(name, w=7, h=9):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "rgb16":
        return _png(rng.integers(0, 2**16, (h, w, 3)), 16, 2)
    if name == "rgba16":
        return _png(rng.integers(0, 2**16, (h, w, 4)), 16, 6)
    if name == "grey16":
        # low values too, so that /255 leaves some of them below 1
        return _png(rng.integers(0, 2**16, (h, w)) >> rng.integers(
            0, 16, (h, w)), 16, 0)
    if name == "grey1":
        return _png(rng.integers(0, 2, (h, w)), 1, 0)
    if name == "grey2":
        return _png(rng.integers(0, 4, (h, w)), 2, 0)
    if name == "palette4":
        return _png(rng.integers(0, 16, (h, w)), 4, 3,
                    palette=rng.integers(0, 256, (16, 3)))
    if name == "adam7_rgb8":
        return _png(rng.integers(0, 256, (h, w, 3)), 8, 2, interlace=1)
    if name == "adam7_rgb8_5x3":      # passes 3, 5 and 7 hold no row
        return _png(rng.integers(0, 256, (3, 5, 3)), 8, 2, interlace=1)
    if name == "adam7_grey16":
        return _png(rng.integers(0, 2**16, (h, w)), 16, 0, interlace=1)
    raise KeyError(name)


CASES = ("rgb16", "rgba16", "grey16", "grey1", "grey2", "palette4",
         "adam7_rgb8", "adam7_rgb8_5x3", "adam7_grey16")


def _write(tmp_path, name):
    path = tmp_path / f"{name}.png"
    path.write_bytes(_case(name))
    return path


def _bits(a):
    return a.view(np.uint32)


@pytest.mark.parametrize("name", CASES)
def test_load_image_matches_rain_tpu(name, tmp_path):
    path = _write(tmp_path, name)
    assert not images.numpy_reads(images._png_header(path))
    w, h = images.size(path)
    for resolution in (None, (w, h), (4, 5)):
        for bg in (None, np.ones(3)):
            want = dataset_jax._load_image(path, resolution, bg)
            got = dataset_port._load_image(path, resolution, bg)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape
            assert np.array_equal(_bits(got), _bits(want)), (resolution, bg)


def test_metrics_reader_matches_rain_tpu(tmp_path):
    for name in CASES:
        _write(tmp_path, name)
    images.save_png(tmp_path / "z_rgb8.png",
                    np.arange(7 * 9 * 3, dtype=np.uint8).reshape(9, 7, 3))
    want, want_names = metrics_jax._load_dir(tmp_path)
    got, got_names = metrics_port._load_dir(tmp_path)
    assert got_names == want_names and len(got) == len(CASES) + 1
    for name, a, b in zip(got_names, got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        assert np.array_equal(_bits(a), _bits(b)), name


@pytest.fixture
def no_pil(monkeypatch):
    for name in [m for m in sys.modules if m.startswith("PIL")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("name", CASES)
def test_without_pil_they_raise_naming_the_file(name, tmp_path, no_pil):
    path = _write(tmp_path, name)
    pattern = rf"{name}\.png: decoding a PNG of bit depth .* needs PIL"
    for read in (images.load, images.load_rgb,
                 lambda p: dataset_port._load_image(p, None)):
        with pytest.raises(RuntimeError, match=pattern):
            read(path)
    with pytest.raises(RuntimeError, match=pattern):
        metrics_port._load_dir(tmp_path)
    # an 8-bit PNG still decodes, and the size of any PNG is its header's
    eight = tmp_path / "eight.png"
    arr = np.arange(7 * 9 * 3, dtype=np.uint8).reshape(9, 7, 3)
    eight.write_bytes(_png(arr, 8, 2))
    assert np.array_equal(images.load(eight), arr)
    assert np.array_equal(images.load_rgb(eight), arr)
    assert images.size(path) == ((5, 3) if name.endswith("5x3") else (7, 9))
