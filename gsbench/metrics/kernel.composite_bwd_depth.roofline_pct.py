"""B4's depth variant (csrc/tile_render_bwd.cu:composite_depth_bwd_kernel)
against its roofline in the depth cell's training steps: the least time
of its counted work (gsbench.work.depth.composite_bwd, from the
reference's composited pairs of each traced step) over its device time.
None where the trace holds no such kernel or work. Moves
train_ms_per_iter."""

from gsbench import readers
from gsbench.work import bound_s

UNIT = "%"
KERNEL = "composite_depth_bwd_kernel"
WORK = "composite_bwd_depth"


def read(tr):
    if tr.kind != "train" or not tr.work or \
            any(WORK not in k for _, k in tr.work):
        return None
    ms = readers.per_step_ms(tr, "train", lambda o: KERNEL in o.name)
    if not ms:
        return None
    least = sum(bound_s(*k[WORK]) for _, k in tr.work) / len(tr.work)
    return 100.0 * least * 1e3 / ms
