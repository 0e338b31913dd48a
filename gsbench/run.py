"""Run one cell of the port's benchmark once.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``,
whose ``loop`` names the generator ``loops/<loop>.py``), the chips it
needs and the limits of its correctness numbers. The run makes the
scene and the traffic from the seed on the card, builds or loads the
program's kernels (rain_tpu_torch's fixed ``_build/``), captures the
cell's keys and warms up (the set-up, ``setup_s``), then measures for
``--seconds`` (``--trace 0``: the end-to-end metrics) or traces a few
calls with torch.profiler (``--trace 1``: every reader of ``metrics/``).
After the window it frees the program's state and compares what the
timed path produced with the plain reference of ``reference/``.

Standard output: the set-up's breakdown, nvidia-smi's clocks and power
beside the window and the memory peaks on earlier lines, and last one
JSON object: correct, attempted, failed, metrics, device, (breakdown)
and, last, the compared numbers with their limits, which also end the
standard error. The run fails, printing no result, without a CUDA card
(or fewer than the cell asks for), or if jax, jaxlib, flax or rain_tpu
was imported.

A cell of ``chips`` > 1 runs as one rank per card (``run_ranks``): the
parent builds the kernels and starts ``chips`` processes with the
program's launcher (``program.spawn``: rank r on ``cuda:r``, one NCCL
group) and holds no CUDA context while they run. Each rank
(``ranks.run_rank``) makes the scene from the seed, keeps its shard,
sets up, and then either runs the window, with a step count that the
ranks agree on from the slowest rank's probe (a rank that stopped alone
would hang the others in a collective), or traces the same calls as
every other rank; it checks for forbidden modules, reads its peak and
returns plain data. A rank that raises, dies or outlasts
``ranks.TIMEOUT_S`` ends every rank and fails the run. The result's
numbers come from: ``train_ms_per_iter``, the largest rank's window over
the steps; ``setup_s``, the parent's module start to the window's start
on rank 0 (one clock: ``perf_counter`` is shared by the processes);
``peak_mem_gib`` and ``memory_peak_bytes``, the fullest rank;
``device.count``, the distinct cards the ranks report having run on (the
run fails, printing no result, where they are fewer than ``chips``, or
of more than one kind); with ``--trace 1`` the per-layer readers and
``breakdown`` read rank 0's trace, and ``busy_s`` and ``window_s`` are
the least busy rank's. After the ranks have ended, the parent regenerates
the whole scene from the seed on ``cuda:0`` and runs the plain reference
once over it; the ranks' norms of their shards add up to the whole
state's (the root of the sum of squares).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rain_tpu")
SMI = ("name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu")


def load(kind: str, name: str, root: Path | None = None) -> dict:
    with open((root or ROOT) / kind / f"{name}.json") as f:
        return json.load(f)


def cell_spec(workload: str,
              root: Path | None = None) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload."""
    cell = load("workloads", workload, root)
    return cell, load("configs", cell["config"], root), \
        load("traffic", cell["traffic"], root)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (rain_tpu_torch is not rain_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


class Forbidden(RuntimeError):
    pass


def _guard() -> None:
    found = forbidden_modules()
    if found:
        raise Forbidden(f"modules that the run may not load: {found}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path | None = None, start: float = T0,
             fault=None) -> tuple[dict, list]:
    """Set up, measure or trace, check. Returns (the result, the earlier
    output lines). ``fault``, in tests, is planted in the loop."""
    import torch

    from gsbench import check, readers
    from gsbench import trace as trace_mod
    cell, cfg, traffic = cell_spec(workload, root)
    marks, last = {}, [start]

    def mark(name):
        now = time.perf_counter()
        marks[name + "_s"] = now - last[0]
        last[0] = now

    mark("torch_import")
    from gsbench import program as prog
    mark("program_import")
    built = prog.build_kernels(device)
    mark("kernels")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop = importlib.import_module(
        f"gsbench.loops.{traffic['loop']}").Loop(cfg, traffic, seed, device,
                                                 prog)
    loop.fault = fault
    loop.setup(mark)
    setup_s = time.perf_counter() - start
    lines = [{"setup": {"setup_s": setup_s, **marks, "built": built,
                        "captures": [[str(k), ms] for k, ms in
                                     loop.steps.captures]}}]
    smi_before = nvidia_smi() if device.type == "cuda" else "cpu"
    if trace:
        events = trace_mod.record(
            lambda: loop.traced(traffic["trace_calls"]))
        attempted, failed = loop.outcome()
        e2e = {}
    else:
        e2e, attempted, failed = loop.window(seconds)
    smi_after = nvidia_smi() if device.type == "cuda" else "cpu"
    _guard()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    reserved = torch.cuda.max_memory_reserved(device) \
        if device.type == "cuda" else 0
    lines.append({"nvidia_smi": {"before": smi_before, "after": smi_after}})
    lines.append({"memory": {"peak_allocated_bytes": peak,
                             "peak_reserved_bytes": reserved}})
    if hasattr(loop, "instances"):
        lines.append({"instances_min_max": loop.instances})
    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, overflowed = loop.check()
    failed += overflowed
    correct, shown = check.verdict(numbers, cell["limits"])
    metrics = {}
    if trace:
        tr = trace_mod.reduce(events, loop.kind, loop.work())
        metrics = readers.read_all((root or ROOT) / "metrics", tr)
    else:
        for name, value in e2e.items():
            metrics[name] = {"value": value, "unit": loop.metrics[name]}
        metrics["peak_mem_gib"] = {"value": peak / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = shown
    _guard()
    return result, lines


def run_ranks(workload: str, seed: int, seconds: float, trace: bool,
              device, root: Path | None = None, start: float = T0,
              fault=None) -> tuple[dict, list]:
    """A cell of several cards, one rank per card (see the module's
    docstring); returns what ``run_cell`` does. ``fault``, in tests:
    ``fault(rank, loop)`` is called in each rank once its loop is made."""
    import torch

    from gsbench import check, ranks
    cell, cfg, traffic = cell_spec(workload, root)
    marks, last = {}, [start]

    def mark(name):
        now = time.perf_counter()
        marks[name + "_s"] = now - last[0]
        last[0] = now

    mark("torch_import")
    from gsbench import program as prog
    mark("program_import")
    built = prog.build_kernels(device)
    mark("kernels")
    job = ranks.Job(workload, seed, seconds, trace,
                    None if root is None else str(root), start, last[0],
                    fault)
    reports = prog.spawn(ranks.run_rank, cell["chips"], device=device,
                         timeout_s=ranks.TIMEOUT_S, args=(job,))
    dev_info = ranks.devices(reports, cell["chips"])
    _guard()
    lead = reports[0]
    peak = dev_info["memory_peak_bytes"]
    lines = [{"setup": {"setup_s": lead["setup_s"], **marks,
                        "rank0": lead["marks"], "built": built,
                        "captures": lead["captures"]}},
             {"nvidia_smi": {"before": lead["nvidia_smi"][0],
                             "after": lead["nvidia_smi"][1]}},
             {"memory": {"peak_allocated_bytes": [r["peak_bytes"]
                                                  for r in reports],
                         "peak_reserved_bytes": [r["reserved_bytes"]
                                                 for r in reports]}},
             {"instances_min_max": lead["instances"]},
             {"ranks": [[r["rank"], r["current_device"], r["card"]]
                        for r in reports]},
             {"stage_ms_rank0": lead["stage_ms"]}]
    ref_dev = torch.device(device.type, 0) if device.type == "cuda" \
        else device
    loop = importlib.import_module(
        f"gsbench.loops.{traffic['loop']}").Loop(
            cfg, traffic, seed, ref_dev, None, world=cell["chips"])
    numbers, overflowed = loop.check_shards([r["check"] for r in reports])
    failed = max(r["failed"] for r in reports) + overflowed
    correct, shown = check.verdict(numbers, cell["limits"])
    if trace:
        metrics = lead["metrics"]
        idle = min(reports, key=lambda r: r["busy_s"] / r["window_s"])
        dev_info.update(busy_s=idle["busy_s"], window_s=idle["window_s"])
    else:
        metrics = {name: {"value": value, "unit": loop.metrics[name]}
                   for name, value in lead["e2e"].items()}
        metrics["peak_mem_gib"] = {"value": peak / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": lead["setup_s"], "unit": "s"}
    result = {"correct": bool(correct and failed == 0),
              "attempted": lead["attempted"], "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = lead["breakdown"]
    result["checks"] = shown
    _guard()
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, _, _ = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"gsbench: the cell {args.workload} needs {cell['chips']} "
              f"CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from gsbench.ranks import WrongDevices
    runner = run_cell if cell["chips"] == 1 else run_ranks
    try:
        result, lines = runner(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda"))
    except (Forbidden, WrongDevices) as e:
        print(f"gsbench: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(json.dumps(line), flush=True)
    print(f"correct: {result['correct']}, failed {result['failed']} of "
          f"{result['attempted']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
