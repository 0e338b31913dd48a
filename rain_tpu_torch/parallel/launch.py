"""Run a function in one process per rank, joined in one group.

The port's counterpart of rain_tpu's device mesh (``sharding.make_mesh``
over ``jax.devices()``): PyTorch runs one process per device, so a sharded
run is ``world_size`` processes, started with the ``spawn`` method (the
parent may already hold a CUDA context, which ``fork`` cannot share).

Each rank gets an explicit device: the CPU, ``cuda:<rank % cards>``, or
``cuda:0`` for every rank when the caller asks ranks to share one card
(``share_device``; gloo only, each rank's caching allocator bounded to its
share of the card). The group meets at a ``file://`` store in a fresh
temporary directory, so parallel runs never contend for a port. Every rank
takes ``torch.set_num_threads(1)``. A rank's exception, a rank that dies
and a run past ``timeout_s`` each end every rank and raise in the caller.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path

import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.parallel import distributed

# the share of a card that ranks sharing it may hold together
SHARED_MEMORY_FRACTION = 0.9


def rank_devices(world_size: int, device=None,
                 share_device: bool = False) -> list[torch.device]:
    """The device of each rank: every rank on the CPU, one card per rank
    (``cuda:<rank % cards>``; RuntimeError with fewer cards than ranks),
    or, with ``share_device``, every rank on the card ``device`` names
    (``cuda:0`` by default). ``device`` None means the CUDA card."""
    dev = device_mod.resolve(device)
    if dev.type == "cpu":
        return [dev] * world_size
    if share_device:
        return [torch.device("cuda", dev.index or 0)] * world_size
    cards = torch.cuda.device_count()
    if cards < world_size:
        raise RuntimeError(
            f"{world_size} ranks need {world_size} CUDA cards and "
            f"{cards} are visible; pass share_device=True to run the ranks "
            f"on one card, or device='cpu'")
    return [torch.device("cuda", r % cards) for r in range(world_size)]


def default_backend(devices: list[torch.device]) -> str:
    """nccl for one card per rank; gloo on the CPU and for ranks that
    share a card (nccl needs a card of its own for each rank)."""
    if devices[0].type == "cuda" and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _worker(rank, world_size, init_method, backend, device, fraction,
            timeout_s, fn, args, results):
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and fraction is not None:
            torch.cuda.set_per_process_memory_fraction(fraction, dev)
        distributed.initialize(init_method, world_size, rank,
                               backend=backend, device=dev,
                               timeout_s=timeout_s)
        out = fn(rank, dev, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def spawn(fn, world_size: int, *, device=None, share_device: bool = False,
          backend: str | None = None, timeout_s: float = 600.0,
          args: tuple = ()) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` processes joined
    in one ``torch.distributed`` group; returns each rank's return value,
    in rank order.

    ``fn`` and ``args`` are pickled (a module-level function; plain data),
    and so is what ``fn`` returns. ``device`` and ``share_device`` place
    the ranks (``rank_devices``); ``backend`` is "gloo" or "nccl", by
    default ``default_backend``'s. Raises RuntimeError naming the rank if
    a rank raises or dies, TimeoutError past ``timeout_s`` (then every
    rank is ended).
    """
    devices = rank_devices(world_size, device, share_device)
    backend = backend or default_backend(devices)
    if backend == "nccl" and len(set(devices)) != len(devices):
        raise ValueError("nccl needs one card per rank; ranks that share a "
                         "card run over gloo")
    fraction = SHARED_MEMORY_FRACTION / world_size \
        if share_device and devices[0].type == "cuda" else None
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = (Path(tmp) / "store").as_uri()
        procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, world_size, init_method, backend, str(devices[r]),
                  fraction, timeout_s, fn, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            outs = _collect(procs, results, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    return outs


def _collect(procs, results, timeout_s):
    deadline = time.monotonic() + timeout_s
    outs = {}
    while len(outs) < len(procs):
        try:
            rank, ok, out = results.get(timeout=0.5)
        except queue_mod.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in outs and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} died with exit code "
                                   f"{procs[dead[0]].exitcode}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(len(procs))) - set(outs))} "
                    f"did not finish within {timeout_s} s")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{out}")
        outs[rank] = out
    return [outs[r] for r in range(len(procs))]
