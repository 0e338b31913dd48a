"""Device ms per frame of preprocess inside the replayed frame: the
interval from rain_mark_begin to the end of preprocess, as
stage.preprocess_ms.train (gsbench.stages). Moves render_fps."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "render", stages.PREPROCESS)
