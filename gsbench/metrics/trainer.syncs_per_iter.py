"""Waits of the Trainer's host for the device per iteration of the traced
episode: the Trainer's ``syncs`` counter (each step's flags read one step
late or at a flush, each round's info read) over the iterations, from
the loop's work record. Moves train_ms_per_iter."""

UNIT = "syncs/iter"


def read(tr):
    if tr.kind != "trainer" or not tr.work:
        return None
    w = tr.work[0]
    return w["counters"]["syncs"] / w["iterations"]
