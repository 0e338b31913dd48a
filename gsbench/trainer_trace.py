"""What the Trainer cells' readers share: the densify rounds' device time
in a traced episode.

Every replayed round's graph opens with ``rain_mark_begin`` and ends with
``rain_mark_round``, with no mark between them (train/compiled.py,
train/marks.py). A round's time is the interval from the end of the one
to the start of the other, as gsbench.stages measures a stage. The marks
are known by name alone: nothing of the program is imported.
"""

from __future__ import annotations

from gsbench import stages


def rounds_us(tr) -> list:
    """Device us of each replayed round in a Trainer trace, in order."""
    if tr.kind != "trainer":
        return []
    out, prev = [], None
    for name, op in stages.marks(tr.ops):
        if name == "round" and prev is not None and prev[0] == "begin":
            out.append(op.start - (prev[1].start + prev[1].dur))
        prev = (name, op)
    return out


def round_ms(tr) -> float | None:
    """Device ms per round; None without a round (or on another loop)."""
    got = rounds_us(tr)
    return sum(got) / len(got) / 1e3 if got else None
