"""Device ms per frame of the binning inside the replayed frame: the
intervals that depth_sort, expand_B1, tile_sort_gather and tile_ranges
end, as stage.binning_ms.train (gsbench.stages). Moves render_fps."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "render", stages.BINNING)
