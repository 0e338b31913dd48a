"""The densify round's share of its roofline in the traced Trainer
episode: the least time of its counted bytes (gsbench.work.rounds: the
parameters, both moments, the statistics and the noise of every
capacity row read once, the compacted rows written once, at 3.35 TB/s)
over its device time (trainer.round_ms). Moves train_ms_per_iter."""

from gsbench import trainer_trace
from gsbench.work import bound_s

UNIT = "%"


def read(tr):
    ms = trainer_trace.round_ms(tr)
    if not ms or not tr.work:
        return None
    return 100.0 * bound_s(tr.work[0]["round_bytes"], 0.0) * 1e3 / ms
