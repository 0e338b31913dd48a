"""Launches of B4's depth variant per traced training step of the depth
cell: the program's counter ``composite_backward.launches_depth``
(counted in train.compiled's COUNTED, so a replay adds its graph's
launches) over the traced steps, from the loop's work record. 1.0 when
the depth term runs; 0 means it is off. None in other cells. Moves
train_ms_per_iter."""

UNIT = "launches/step"
KEY = "depth.bwd_launches_per_step"


def read(tr):
    if tr.kind != "train" or not tr.work or KEY not in tr.work[0][1]:
        return None
    return tr.work[0][1][KEY]
