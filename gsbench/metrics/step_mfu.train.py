"""The whole training step's share of the chip's peak: the least time
of the step's counted work (gsbench.work.counts.train_step: the larger of
its f32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s) over the
traced ms per iteration. Moves train_ms_per_iter."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.step_mfu(tr, "train")
