"""One rank of a cell of several cards, and what the ranks' reports add up
to.

``run.run_ranks`` starts one rank per card with the program's launcher
(``program.spawn``: one process per card, joined in one NCCL group; in
the CPU tests, gloo). Each rank runs ``run_rank`` on its card: the
cell's set-up, then the window or the traced calls, the forbidden-module
guard, its memory peak, the release of its graphs, and its part of the
check (``loops.sharded_train``). It returns plain data. ``devices``
counts the cards that the ranks report having run on and fails where
they are fewer than the cell asks for.
"""

from __future__ import annotations

import importlib
import time
from pathlib import Path
from typing import NamedTuple

import torch

# a run's ranks are ended, and the run fails, past this
TIMEOUT_S = 300.0


class Job(NamedTuple):
    workload: str
    seed: int
    seconds: float
    trace: bool
    root: str | None      # the data root (tests); None: the benchmark's own
    start: float          # the parent's module start (perf_counter)
    since: float          # the parent's last set-up mark, before the spawn
    fault: object = None  # fault(rank, loop), in tests: planted per rank


class WrongDevices(RuntimeError):
    pass


def card(rank: int, device: torch.device) -> str:
    """The card ``device`` names, by its PCI address (or its UUID); on the
    CPU, in tests, each rank's process counts as a card of its own."""
    if device.type != "cuda":
        return f"cpu:{rank}"
    p = torch.cuda.get_device_properties(device)
    if hasattr(p, "pci_bus_id"):
        return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:" \
            f"{p.pci_device_id:02x}"
    return str(p.uuid)


def run_rank(rank: int, device: torch.device, job: Job) -> dict:
    """One rank's run of the cell (``launch.spawn`` calls it)."""
    from gsbench import program as prog
    from gsbench import readers, run
    from gsbench import trace as trace_mod
    root = Path(job.root) if job.root else None
    cell, cfg, traffic = run.cell_spec(job.workload, root)
    cuda = device.type == "cuda"
    marks, last = {}, [job.since]

    def mark(name):
        now = time.perf_counter()
        marks[name + "_s"] = now - last[0]
        last[0] = now

    mark("spawn")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    loop = importlib.import_module(
        f"gsbench.loops.{traffic['loop']}").Loop(
            cfg, traffic, job.seed, device, prog, world=cell["chips"])
    if job.fault is not None:
        job.fault(rank, loop)
    try:
        loop.setup(mark)
        out = {"rank": rank, "card": card(rank, device),
               "current_device": torch.cuda.current_device() if cuda
               else None,
               "kind": torch.cuda.get_device_name(device) if cuda
               else "cpu",
               "setup_s": time.perf_counter() - job.start, "marks": marks,
               "captures": [[str(k), ms] for k, ms in loop.steps.captures]}
        smi = [run.nvidia_smi() if cuda and rank == 0 else "cpu"]
        if job.trace:
            events = trace_mod.record(
                lambda: loop.traced(traffic["trace_calls"]))
            out["attempted"], out["failed"] = loop.outcome()
            out["e2e"] = {}
        else:
            out["e2e"], out["attempted"], out["failed"] = \
                loop.window(job.seconds)
        smi.append(run.nvidia_smi() if cuda and rank == 0 else "cpu")
        out["nvidia_smi"] = smi
        out["stage_ms"] = loop.stage_ms()
        out["instances"] = loop.instances
        run._guard()
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
            if cuda else 0
        out["reserved_bytes"] = torch.cuda.max_memory_reserved(device) \
            if cuda else 0
    finally:
        loop.release()
    if job.trace:
        tr = trace_mod.reduce(events, loop.kind, loop.work())
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        if rank == 0:
            out["metrics"] = readers.read_all(
                (root or run.ROOT) / "metrics", tr)
            out["breakdown"] = trace_mod.breakdown(tr)
    out["check"] = loop.shard_check()
    run._guard()
    return out


def devices(reports: list[dict], chips: int) -> dict:
    """``device`` of the result from the ranks' reports: the distinct cards
    they ran on, their one kind, the fullest rank's peak. WrongDevices
    where the cards are fewer than ``chips`` or of more than one kind."""
    cards = sorted({r["card"] for r in reports})
    if len(cards) < chips:
        raise WrongDevices(
            f"the cell asks for {chips} cards and its {len(reports)} ranks "
            f"ran on {len(cards)}: {cards}")
    kinds = sorted({r["kind"] for r in reports})
    if len(kinds) != 1:
        raise WrongDevices(f"the ranks ran on cards of kinds {kinds}")
    return {"platform": "cpu" if kinds[0] == "cpu" else "gpu",
            "kind": kinds[0], "count": len(cards),
            "memory_peak_bytes": max(r["peak_bytes"] for r in reports)}
