"""Device ms per training step of the NCCL kernels inside the step's
replay (the gathers of the render streams and the rect table, the
all-to-all of their backward, the loss's and the counts' all-reduces):
each kernel's time, its wait for the other ranks included. None where
the step launches no NCCL kernel (a step on one card)."""

from gsbench import readers

UNIT = "ms"


def _nccl(op) -> bool:
    return "nccl" in op.name.lower()


def read(tr):
    if not any(_nccl(o) for o in tr.ops):
        return None
    return readers.per_step_ms(tr, "train", _nccl)
