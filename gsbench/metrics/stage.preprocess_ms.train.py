"""Device ms per training step of preprocess inside the replayed step:
the interval that the mark rain_mark_preprocess ends, from the graph's
rain_mark_begin (activation, projection, SH colours; gsbench.stages).
Moves train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "train", stages.PREPROCESS)
