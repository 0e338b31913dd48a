"""Axis/angle image annotator: the port of rain_tpu/tools/vlm/annotate_axes.py.

Stamps a coordinate-frame overlay onto every image in a folder so a VLM
can reason about orientation: centered horizontal/vertical axes with
signed-direction labels, the two corner-to-corner diagonals in red, and
degree labels on a ring at the four diagonal angles (45/135/225/315,
math convention — screen y grows downward so the y term is subtracted).

Implementation is table-driven: the overlay for a WxH canvas is a small
geometry table built by ``build_overlay`` and rendered by ``stamp``.
This is PIL drawing on the host, with no tensor, so there is no
``--device``:

  python -m rain_tpu_torch.tools.vlm.annotate_axes --input_folder IN \
      --output_folder OUT
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

IMAGE_SUFFIXES = frozenset({".png", ".jpg", ".jpeg", ".bmp", ".gif"})
STROKE_WIDTH = 2
RING_DIVISOR = 4          # ring radius = min(W, H) / 4
RING_ANGLES = (45, 135, 225, 315)


def build_overlay(size):
    """Geometry table for a ``size = (W, H)`` canvas.

    Returns a dict with two entries:
      ``strokes``: list of (color, (x0, y0, x1, y1)) segments,
      ``texts``:   list of ((x, y), string) anchors.
    """
    w, h = size
    half_w, half_h = w // 2, h // 2

    strokes = [
        ("black", (0, half_h, w, half_h)),
        ("black", (half_w, 0, half_w, h)),
        ("red", (0, 0, w, h)),
        ("red", (w, 0, 0, h)),
    ]

    texts = [
        ((w - 30, half_h + 10), "x"),
        ((half_w + 10, 20), "y"),
        ((w - 30, half_h - 30), "+x"),
        ((20, 20), "-y"),
        ((20, h - 40), "-x"),
        ((half_w + 10, h - 40), "+y"),
    ]
    ring = min(w, h) // RING_DIVISOR
    for deg in RING_ANGLES:
        rad = math.radians(deg)
        at = (half_w + int(ring * math.cos(rad)),
              half_h - int(ring * math.sin(rad)))
        texts.append((at, f"{deg}\N{DEGREE SIGN}"))

    return {"strokes": strokes, "texts": texts}


def stamp(src_file, dst_file) -> None:
    """Render ``src_file`` onto a white canvas with the overlay on top."""
    from PIL import Image, ImageDraw, ImageFont

    with Image.open(src_file) as src:
        base = Image.new("RGB", src.size, "white")
        base.paste(src, (0, 0))
        overlay = build_overlay(src.size)

    draw = ImageDraw.Draw(base)
    try:
        face = ImageFont.load_default()
    except Exception:
        face = None

    # axes first so the text/diagonals sit on top of them
    for color, (x0, y0, x1, y1) in overlay["strokes"]:
        draw.line((x0, y0, x1, y1), fill=color, width=STROKE_WIDTH)
    for at, label in overlay["texts"]:
        kwargs = {"font": face} if face else {}
        draw.text(at, label, fill="black", **kwargs)

    base.save(dst_file)


def run(input_folder: str, output_folder: str) -> int:
    src_root = Path(input_folder)
    dst_root = Path(output_folder)
    dst_root.mkdir(parents=True, exist_ok=True)

    count = 0
    for item in sorted(src_root.iterdir()):
        if item.suffix.lower() not in IMAGE_SUFFIXES:
            continue
        stamp(item, dst_root / item.name)
        count += 1
        print(f"Processed: {item.name}")
    return count


def main(argv=None) -> None:
    cli = argparse.ArgumentParser(description=__doc__)
    cli.add_argument("--input_folder", required=True)
    cli.add_argument("--output_folder", required=True)
    ns = cli.parse_args(argv)
    run(ns.input_folder, ns.output_folder)
    print("All images processed successfully.")


if __name__ == "__main__":
    main()
