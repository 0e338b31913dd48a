"""Device ms per training step of the loss, forward and backward, inside
the replayed step: the intervals that the marks loss and loss_bwd end
(L1 and SSIM, then their backward and the image assembly's down to the
tiles' cotangent; gsbench.stages). Moves train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"


def read(tr):
    return stages.interval_ms(tr, "train", stages.LOSS)
