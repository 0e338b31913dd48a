"""The port's PNG codec (rain_tpu_torch/data/images.py) against PIL.

rain_tpu reads and writes images with PIL; the port reads and writes PNG
with numpy and zlib. Tolerance: none, every comparison is bit for bit.
Decoding: PIL-written files of every colour type (grey, grey+alpha, RGB,
RGBA, palette) at widths 1, 7 and 160, and files whose rows use each of
the five scanline filters (written by ``_filtered_png`` below, with a
filter type chosen per row), against ``np.asarray(Image.open(p))`` and
``.convert("RGB")``. Encoding: the port's files decoded by PIL. Then
``_load_image``'s f32 against rain_tpu's PIL expression, and the
RuntimeError that names the file when a JPEG or a resize needs PIL and
PIL does not import.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rain_tpu_torch.data import dataset as dataset_port
from rain_tpu_torch.data import images

torch.set_num_threads(1)

MODES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}
CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}
WIDTHS = (1, 7, 160)


def _pixels(mode, width, height=9, seed=0):
    rng = np.random.default_rng(seed)
    shape = (height, width) if CHANNELS[mode] == 1 else \
        (height, width, CHANNELS[mode])
    if mode == "P":
        return rng.integers(0, 40, shape).astype(np.uint8)
    # smooth gradients plus noise, so PIL's adaptive filtering picks
    # several filter types
    ramp = np.add.outer(np.arange(height) * 7, np.arange(width) * 3)
    if len(shape) == 3:
        ramp = ramp[:, :, None] * (1 + np.arange(shape[2]))
    return ((ramp + rng.integers(0, 4, shape)) % 256).astype(np.uint8)


def _pil_png(path, mode, arr, seed=0):
    img = Image.fromarray(arr, mode)
    if mode == "P":
        rng = np.random.default_rng(seed)
        img.putpalette(rng.integers(0, 256, 3 * 40).astype(np.uint8)
                       .tolist())
    img.save(path)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered_png(arr, kinds, ctype):
    """An 8-bit PNG of ``arr`` whose row y is filtered with kinds[y], by
    the PNG specification's per-byte formulas."""
    h = arr.shape[0]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, -1).astype(int)
    out = bytearray()
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros_like(rows[y])
        out.append(int(kinds[y]))
        for i, x in enumerate(rows[y]):
            a = rows[y][i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kinds[y]]
            out.append((x - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))

    return (images.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", arr.shape[1], h, 8, ctype, 0, 0, 0)) +
        chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_matches_pil(mode, width, tmp_path):
    path = tmp_path / "x.png"
    _pil_png(path, mode, _pixels(mode, width))
    with Image.open(path) as im:
        assert im.mode == mode
        want, want_rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    got = images.load(path)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(images.load_rgb(path), want_rgb)
    assert images.size(path) == (width, 9)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_every_filter_type_decodes(mode, width, tmp_path):
    arr = _pixels(mode, width, height=15, seed=1)
    kinds = np.arange(15) % 5              # each filter type, three times
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(arr, kinds, MODES[mode]))
    with Image.open(path) as im:
        want = np.asarray(im)
    assert np.array_equal(want, arr)
    assert np.array_equal(images.load(path), arr)


@pytest.mark.parametrize("kind", range(5))
def test_one_filter_type_throughout(kind, tmp_path):
    """Rows of one type: None, Sub and Up take the row-by-row path,
    Average and Paeth the diagonal one."""
    arr = _pixels("RGB", 33, height=12, seed=kind)
    path = tmp_path / "k.png"
    path.write_bytes(_filtered_png(arr, [kind] * 12, 2))
    assert np.array_equal(images.load(path), arr)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_encode_is_read_back_by_pil(mode, width, tmp_path):
    arr = _pixels(mode, width, seed=2)
    path = tmp_path / "e.png"
    images.save_png(path, arr)
    with Image.open(path) as im:
        assert im.mode == mode
        assert np.array_equal(np.asarray(im), arr)
    assert np.array_equal(images.load(path), arr)


def test_encode_rejects_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8)):
        with pytest.raises(ValueError):
            images.save_png(tmp_path / "b.png", bad)


def _rain_tpu_load_image(path, resolution, bg=None):
    """rain_tpu/data/dataset.py:_load_image, whose PIL calls are the
    reference the port's decoder is held to."""
    from rain_tpu.data import dataset as dataset_jax
    return dataset_jax._load_image(path, resolution, bg)


@pytest.mark.parametrize("mode", list(MODES))
def test_load_image_f32_matches_pil(mode, tmp_path):
    path = tmp_path / "i.png"
    _pil_png(path, mode, _pixels(mode, 7))
    for bg in (None, np.ones(3), np.zeros(3)):
        want = _rain_tpu_load_image(path, None, bg)
        got = dataset_port._load_image(path, None, bg)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # a resize goes through PIL's own filter: the same bits
    want = _rain_tpu_load_image(path, (4, 5), None)
    assert np.array_equal(dataset_port._load_image(path, (4, 5)), want)


def test_jpeg_and_resize_need_pil(tmp_path, monkeypatch):
    png, jpg = tmp_path / "a.png", tmp_path / "b.jpg"
    arr = _pixels("RGB", 7)
    images.save_png(png, arr)
    Image.fromarray(arr).save(jpg)
    for name in [m for m in sys.modules if m.startswith("PIL")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    # a PNG at its own size needs no PIL
    assert np.array_equal(images.load(png), arr)
    assert np.array_equal(images.load(png, (7, 9)), arr)
    with pytest.raises(RuntimeError, match=r"b\.jpg.*needs PIL"):
        images.load(jpg)
    with pytest.raises(RuntimeError, match=r"b\.jpg.*needs PIL"):
        images.size(jpg)
    with pytest.raises(RuntimeError, match=r"b\.jpg.*needs PIL"):
        images.load_rgb(jpg)
    with pytest.raises(RuntimeError, match=r"a\.png: resizing.*needs PIL"):
        dataset_port._load_image(png, (4, 5))


def test_png_errors_name_the_file(tmp_path):
    path = tmp_path / "bad.png"
    data = images.encode_png(_pixels("RGB", 7))
    path.write_bytes(data[:-20])
    with pytest.raises(ValueError, match="bad.png"):
        images.load(path)
    # an Adam7 PNG goes to PIL (tests/test_torch_png_pil.py); the numpy
    # decoder itself refuses it, naming the file
    interlaced = bytearray(data)
    interlaced[28] = 1                     # the IHDR interlace byte
    with pytest.raises(ValueError, match="bad.png.*interlace"):
        images.decode_png(bytes(interlaced), path)
