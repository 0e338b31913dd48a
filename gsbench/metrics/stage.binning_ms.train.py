"""Device ms per training step of the binning inside the replayed step:
the intervals that the marks depth_sort, expand_B1, tile_sort_gather and
tile_ranges end (the depth order, B1, the tile sort and gather, the tile
ranges; gsbench.stages). Moves train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "train", stages.BINNING)
