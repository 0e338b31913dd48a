"""Device ms per training step of Adam inside the replayed step: the
interval that the mark adam ends, from the densification statistics'
mark (gsbench.stages). Moves train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "train", stages.ADAM)
