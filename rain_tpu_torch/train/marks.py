"""Stage marks inside the compiled step's graphs.

A host range opened while a CUDA graph is captured is not replayed, so
the compiled step (train.compiled) marks its stages on the device: at
capture it passes a ``Marks`` as the step's ``on_stage`` hook, and each
stage the step reports launches the one-thread kernel ``rain_mark_<stage>``
of ``csrc/marks.cu``, which writes the device clock (%globaltimer, ns)
into the next slot of the graph's buffer. Each replay writes every slot
again. The interval between two marks is named after the mark that ends
it: "preprocess" is the time from the graph's "begin" to the end of
preprocess, "adam" the time from the statistics' mark to the end of
Adam.

``STAGES`` are every stage a graph can mark, in the order of
``csrc/marks.cu``'s list: "begin" (a graph's first node), the render's
stages (ops.render.STAGES), the loss, the backward's
(ops.render.BACKWARD_STAGES), the training step's and the end marks of
the densify round's and the opacity reset's graphs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rain_tpu_torch import _build
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.train import step as step_mod

STAGES = tuple(dict.fromkeys(
    ("begin",) + render_ops.STAGES +
    step_mod.TRAIN_STAGES[:1] + render_ops.BACKWARD_STAGES +
    step_mod.TRAIN_STAGES[1:] + ("round", "reset")))
# slots of one graph's buffer: a training graph marks 15 stages
SLOTS = 32


@functools.cache
def _load(device: torch.device) -> None:
    """Load the mark kernels on ``device`` before any capture: a kernel
    first loaded inside a stream capture may break it."""
    _build.launch(_build.kernel("marks", "rain_mark_load", ()), device)


class Marks:
    """The marks of one graph: an ``on_stage`` hook that, at capture,
    launches each reported stage's mark into the next slot and records
    the stage's name (``names``, in order)."""

    def __init__(self, device: torch.device):
        _load(device)
        self.device = device
        self.slots = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.names = []

    def __call__(self, stage: str, value: object = None) -> None:
        i = len(self.names)
        if i == SLOTS:
            raise RuntimeError(f"more than {SLOTS} stage marks in one graph")
        _build.launch(_build.kernel("marks", "rain_mark",
                                    (ctypes.c_int, ctypes.c_void_p)),
                      self.device, STAGES.index(stage),
                      self.slots.data_ptr() + i * self.slots.element_size())
        self.names.append(stage)

    def ms(self) -> dict:
        """{stage: ms} of the last replay, each interval named by the mark
        that ends it, in order (a stage marked twice adds up). One copy to
        the host, which waits for the device."""
        return intervals(self.names, self.slots[:len(self.names)].tolist())


def intervals(names, ns) -> dict:
    """{name: ms} of marks ``names`` stamped at ``ns`` (ns, in order):
    each interval from one mark to the next, named by the later one."""
    out = {}
    for name, a, b in zip(names[1:], ns, ns[1:]):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out
