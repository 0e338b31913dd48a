"""Device ms per frame of the copies the compiled step issues into and
out of its graph's buffers (as compiled.copy_ms.train, in the harness's
eval_render span). Moves render_fps."""

from gsbench import readers

UNIT = "ms"


def read(tr):
    return readers.per_step_ms(tr, "render", lambda o: not o.graph)
