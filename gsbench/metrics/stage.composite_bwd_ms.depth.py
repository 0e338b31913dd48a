"""Device ms per depth-regularized training step of the compositor's
backward, inside the replayed step: the intervals that the marks
composite_bwd_B4 and reduce_B2 end (B4's depth variant, then the scatter
of its ten gradient rows to rank order and B2; gsbench.stages), in the
depth cell's traces alone (their work holds B4's depth variant). Moves
train_ms_per_iter."""

from gsbench import stages

UNIT = "ms"
BOUNDS = ("loss_bwd", "composite_bwd_B4", "reduce_B2")


def read(tr):
    if tr.kind != "train" or not tr.work or \
            any("composite_bwd_depth" not in k for _, k in tr.work):
        return None
    return stages.interval_ms(tr, "train", BOUNDS)
