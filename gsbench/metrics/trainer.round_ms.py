"""Device ms per densify round in the traced Trainer episode: in each
replayed round's graph, the interval from the end of ``rain_mark_begin``
to the start of ``rain_mark_round`` (gsbench.trainer_trace). None on a
trace of another loop or without a round. Moves train_ms_per_iter."""

from gsbench import trainer_trace

UNIT = "ms"


def read(tr):
    return trainer_trace.round_ms(tr)
