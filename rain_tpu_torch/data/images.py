"""Image files: PNG read and written with numpy and zlib, the rest by PIL.

rain_tpu reads and writes every image through PIL
(rain_tpu/data/dataset.py:39-54, scripts/render.py:24-33,
scripts/metrics.py:19-26). This module gives the same arrays without it
for PNG, the format the loaders, the render CLI and the metrics CLI use:

- ``load(path)`` is ``np.asarray(PIL.Image.open(path))``: uint8 [H, W]
  for grey and for palette images (their indices, as PIL gives them),
  [H, W, 2] for grey+alpha, [H, W, 3] for RGB, [H, W, 4] for RGBA;
- ``load_rgb(path)`` is ``np.asarray(PIL.Image.open(path).convert("RGB"))``;
- ``save_png(path, arr)`` writes uint8 [H, W], [H, W, 3] or [H, W, 4].

The decoder reads 8-bit, non-interlaced PNGs of the five colour types
with all five scanline filters. JPEG and other formats, and resizing
(``PIL.Image.resize`` with PIL's own default filter, as
rain_tpu/data/dataset.py:42 calls it), go through PIL; without PIL they
raise RuntimeError naming the file. No other resampler stands in for
PIL's: it would round differently and give another image.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels per pixel (PNG spec 11.2.2)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pil(path, what: str):
    """PIL.Image, or RuntimeError naming the file and what needed PIL."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: {what} needs PIL, which does not "
                           f"import here; only 8-bit PNG is read without "
                           f"it") from None
    return Image


def is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off = 8
    while off + 12 <= len(data):
        (n,) = struct.unpack_from(">I", data, off)
        if off + 12 + n > len(data):
            break
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        (crc,) = struct.unpack_from(">I", data, off + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _header(data: bytes, path):
    kind = data[12:16]
    if data[:8] != SIGNATURE or kind != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack_from(">IIBBBBB", data, 16)


def size(path) -> tuple[int, int]:
    """(width, height), as ``PIL.Image.size``: from a PNG's header, and
    through PIL for other formats."""
    if is_png(path):
        with open(path, "rb") as f:
            w, h, *_ = _header(f.read(33), path)
        return w, h
    with _pil(path, "reading the size of a non-PNG image").open(path) as im:
        return im.size


def _unfilter_rows(raw: np.ndarray, kinds: np.ndarray, bpp: int):
    """Rows of filter types 0 (None), 1 (Sub) and 2 (Up), one at a time."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row, kind = raw[y], kinds[y]
        if kind == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = row + prev
        out[y] = prev = row
    return out


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray, bpp: int):
    """Any filter types, Average (3) and Paeth (4) included.

    A pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal (y + x = s) depend only on earlier
    diagonals. The image is skewed so that diagonal s is row s of
    ``skew``, column y + 1 (column 0 is the zero row above the image), and
    each diagonal is filtered back in one vector step."""
    h, stride = raw.shape
    w = stride // bpp
    px = raw.reshape(h, w, bpp).astype(np.int16)
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    ys, xs = np.mgrid[0:h, 0:w]
    src = np.zeros_like(skew)
    src[ys + xs + 1, ys + 1] = px
    kind_of = np.zeros(h + 1, np.int16)
    kind_of[1:] = kinds
    for s in range(1, h + w):
        lo, hi = max(1, s - w + 1), min(h, s) + 1
        a = skew[s - 1, lo:hi]           # left: (y, x - 1)
        b = skew[s - 1, lo - 1:hi - 1]   # up: (y - 1, x)
        c = skew[s - 2, lo - 1:hi - 1]   # up-left: (y - 1, x - 1)
        k = kind_of[lo:hi, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        skew[s, lo:hi] = (src[s, lo:hi] + pred) & 0xFF
    return skew[ys + xs + 1, ys + 1].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes, path="<bytes>"):
    """(pixels uint8 [H, W] or [H, W, C], colour type, palette [K, 3] or
    None) of an 8-bit non-interlaced PNG."""
    w, h, depth, ctype, _, _, interlace = _header(data, path)
    if depth != 8 or ctype not in CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; only 8-bit non-interlaced PNGs are read")
    idat, palette = [], None
    for kind, body in _chunks(data, path):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = CHANNELS[ctype]
    stride = w * bpp
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (stride + 1):
        raise ValueError(f"{path}: {flat.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    rows = flat.reshape(h, stride + 1)
    kinds, raw = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown filter type {kinds.max()}")
    if (kinds >= 3).any():
        pixels = _unfilter_wavefront(raw, kinds, bpp)
    else:
        pixels = _unfilter_rows(raw, kinds, bpp)
    pixels = pixels.reshape(h, w, bpp)
    return (pixels[:, :, 0] if bpp == 1 else pixels), ctype, palette


def load(path, resize_to=None) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))``, and with ``resize_to`` a
    (width, height) other than the file's, of ``.resize(resize_to)``."""
    path = Path(path)
    png = is_png(path)
    if png and (resize_to is None or tuple(resize_to) == size(path)):
        return decode_png(path.read_bytes(), path)[0]
    what = "resizing an image" if png else "decoding a non-PNG image"
    with _pil(path, what).open(path) as im:
        if resize_to is not None and tuple(resize_to) != im.size:
            im = im.resize(tuple(resize_to))
        return np.asarray(im)


def load_rgb(path) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert("RGB"))``, uint8 [H, W, 3]."""
    path = Path(path)
    if not is_png(path):
        with _pil(path, "decoding a non-PNG image").open(path) as im:
            return np.asarray(im.convert("RGB"))
    pixels, ctype, palette = decode_png(path.read_bytes(), path)
    if ctype == 3:
        return palette[pixels]
    if ctype in (0, 4):
        grey = pixels if ctype == 0 else pixels[:, :, 0]
        return np.repeat(grey[:, :, None], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def encode_png(arr: np.ndarray) -> bytes:
    """An 8-bit PNG of uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA): every row filter type 0, one zlib stream at level 6."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (3, 4))):
        raise ValueError(f"save_png takes uint8 [H, W], [H, W, 3] or "
                         f"[H, W, 4], not {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    ctype = {1: 0, 3: 2, 4: 6}[1 if arr.ndim == 2 else arr.shape[2]]
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)
    rows[:, 1:] = arr.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
            chunk(b"IEND", b""))


def save_png(path, arr: np.ndarray):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(arr))
