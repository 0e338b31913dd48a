"""The share of the traced render window in which no device operation
ran (a ceiling, as device.idle_pct.train). Moves render_fps."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.idle_pct(tr, "render")
