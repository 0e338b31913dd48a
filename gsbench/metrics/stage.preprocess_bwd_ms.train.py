"""Device ms per training step of preprocess's backward inside the
replayed step: the interval that the mark grads ends, after B2 (the
backward through the projection, the SH colours and the activation;
gsbench.stages). Moves train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "train", stages.PREPROCESS_BWD)
