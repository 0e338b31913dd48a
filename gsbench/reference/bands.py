"""The instance count of the fullest band of tile rows, as the sharded
step counts it.

A step sharded over D cards renders the image in D bands of tile rows:
band b holds ``rows_per_band = ceil(grid_y / D)`` rows from row
b·rows_per_band, and is rendered with one halo tile row more on each
side, so its rows run from b·rows_per_band − 1 for rows_per_band + 2
rows, of which those inside the image [0, grid_y) take instances. A
Gaussian that touches tiles puts into band b its rectangle's columns
times its rows clipped to the band's; the step's ``num_instances`` is
the largest band's sum. Written out here from that layout (Grendel,
arXiv:2406.18533, splits pixels over the cards in the same way); nothing
is taken from the program.
"""

from __future__ import annotations

import torch

from gsbench.reference.preprocess import TILE, Screen

HALO = 1


def band_counts(s: Screen, height: int, bands: int) -> list[int]:
    """The instances of each band of screen ``s`` over ``bands`` bands."""
    grid_y = (height + TILE - 1) // TILE
    rows = (grid_y + bands - 1) // bands
    touches = s.tiles > 0
    x_tiles = torch.where(touches, s.rect_wh[:, 0],
                          torch.zeros_like(s.rect_wh[:, 0]))
    y0, y1 = s.rect_min[:, 1], s.rect_min[:, 1] + s.rect_wh[:, 1]
    out = []
    for b in range(bands):
        lo = max(b * rows - HALO, 0)
        hi = min(b * rows - HALO + rows + 2 * HALO, grid_y)
        h = torch.clamp(torch.clamp(y1, lo, hi) - torch.clamp(y0, lo, hi),
                        min=0)
        out.append(int(torch.sum(x_tiles * h)))
    return out


def fullest(s: Screen, height: int, bands: int) -> int:
    return max(band_counts(s, height, bands))
