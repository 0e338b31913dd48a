"""The whole frame's share of the chip's peak (gsbench.work.counts.frame)
over the traced ms per frame. Moves render_fps."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.step_mfu(tr, "render")
