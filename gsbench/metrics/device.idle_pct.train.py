"""The share of the traced training window in which no device operation
ran. The profiler drops the records of some tiny kernels, so this reads
as a ceiling. Moves train_ms_per_iter."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.idle_pct(tr, "train")
