"""Device ms per training step of the copies the compiled step issues
into and out of its graph's buffers: every device operation launched
inside the harness's train_step span that no graph replay launched (the
copies and fills of ``CompiledStep``'s ``_copy``), told apart from the
copy kernels inside the replay by their launching call. Moves
train_ms_per_iter."""

from gsbench import readers

UNIT = "ms"


def read(tr):
    return readers.per_step_ms(tr, "train", lambda o: not o.graph)
