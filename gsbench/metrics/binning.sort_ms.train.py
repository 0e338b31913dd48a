"""Device ms per training step of torch.sort's radix-sort kernels inside
the replayed step (ops/binning.py: the depth order of the Gaussians and
the tile sort of the instances). Moves train_ms_per_iter."""

from gsbench import readers

UNIT = "ms"


def read(tr):
    return readers.per_step_ms(tr, "train", lambda o: "RadixSort" in o.name)
