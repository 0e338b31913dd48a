"""The share of the traced Trainer episode in which no device operation
ran: the host's per-iteration work, its waits and its flushes show here.
The profiler drops the records of some tiny kernels, so this reads as a
ceiling. Moves train_ms_per_iter."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.idle_pct(tr, "trainer")
