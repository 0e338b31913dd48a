"""Process-group bring-up and the collectives of the sharded step.

Port of rain_tpu/parallel/distributed.py. rain_tpu brings up
``jax.distributed`` from the RAIN_TPU_* environment variables and then
sees every device of every host in one process. The port runs one process
per device (SPMD, PyTorch's idiom): ``initialize`` joins this process to a
``torch.distributed`` group whose address, world size, rank and backend
the caller gives (the train CLI's ``--dist_init``, ``--world_size``,
``--rank`` and ``--dist_backend``; ``parallel.launch.spawn``). Nothing
here reads the environment.

The collectives of the sharded step (parallel.sharding):

- ``gather_shards``: an autograd Function. Its forward concatenates every
  rank's shard along dim 0 (``all_gather_into_tensor``); its backward,
  the transpose, sums every rank's cotangent of the whole onto the shard's
  owner (``reduce_scatter``), so each shard gets its gradient once,
  summed over the ranks.
- ``all_gather`` and ``all_reduce`` ("sum" or "max") for values outside
  autograd.

``reduce_scatter`` sends each rank's block of the cotangent to the
block's owner (``all_to_all_single``, which moves bits and adds nothing)
and sums the blocks there in rank order. The backends' own
reduce-scatters each sum in an order of their own: NCCL's and gloo's part
at the rounding's level wherever three or more ranks add to a row, and 40
Adam steps of the train CLI turned that into 131 opacity rows of 262,144
off by more than 2e-3 on four H100s. With the sum done here, both
backends give the same bits, and so does a rerun
(tests/test_torch_sharding.py::test_sharded_step_reruns_bitwise). The
gradient sums use no float atomics.

Backends: "nccl" runs on the cards' tensors, one card per rank; "gloo"
runs on CPU tensors, and lets ranks share one card. Gloo takes CUDA
tensors for each collective used here (all_gather_into_tensor,
all_to_all_single, all_reduce, broadcast), copying them through the host
itself, so nothing here stages them and each collective of a gloo group
waits for the device. Nothing falls back from one backend to another.
"""

from __future__ import annotations

import datetime
import warnings

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: str, device: torch.device | str | None = None,
               timeout_s: float | None = None) -> None:
    """Join this process to the default group as ``rank`` of
    ``world_size``.

    init_method: the group's rendezvous, e.g. ``tcp://HOST:PORT`` or
      ``file:///PATH`` (a file every rank can reach).
    backend: "gloo" or "nccl"; "nccl" needs ``device``, a CUDA device,
      which becomes this process's current device.
    timeout_s: how long a collective may wait for the other ranks before
      it raises (the backend's default when None).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r} is not one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in [0, {world_size})")
    dev = None if device is None else torch.device(device)
    if backend == "nccl" and (dev is None or dev.type != "cuda"):
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """The group's world size; 1 without an initialised group."""
    return dist.get_world_size(group) if is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 without an initialised group."""
    return dist.get_rank(group) if is_initialized() else 0


def backend(group=None) -> str | None:
    """The group's backend, "gloo" or "nccl"; None without an initialised
    group."""
    return dist.get_backend(group) if is_initialized() else None


def shutdown() -> None:
    """Leave the default group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def _run(name: str, out: torch.Tensor, inp: torch.Tensor, group,
         **kw) -> torch.Tensor:
    """``dist.<name>(out, inp, group=group, **kw)``; returns ``out``."""
    with warnings.catch_warnings():
        # newer torch names these *_single; the old names stay available
        warnings.simplefilter("ignore", FutureWarning)
        getattr(dist, name)(out, inp, group=group, **kw)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] concatenated along dim 0 in rank order,
    [world·n, ...]; no gradient."""
    x = x.contiguous()
    out = x.new_empty((world_size(group) * x.shape[0],) + x.shape[1:])
    return _run("all_gather_into_tensor", out, x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of the sum over ranks of ``x`` [world·n, ...]:
    rows [rank·n, (rank+1)·n), [n, ...]; no gradient. Rank r's block of
    those rows comes here whole (``all_to_all_single``), and the blocks
    are summed in rank order, ((x_0 + x_1) + x_2) + ..., whatever the
    backend."""
    x = x.contiguous()
    ws = world_size(group)
    if x.shape[0] % ws:
        raise ValueError(f"{x.shape[0]} rows do not split over {ws} ranks")
    blocks = _run("all_to_all_single", torch.empty_like(x), x, group)
    blocks = blocks.view(ws, x.shape[0] // ws, *x.shape[1:])
    out = blocks[0].clone()
    for block in blocks[1:]:
        out += block
    return out


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over the ranks in place ("sum" or "max"); returns it.
    No gradient."""
    if op not in _OPS:
        raise ValueError(f"op={op!r} is not one of {tuple(_OPS)}")
    if not x.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


def gather_shards(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` under autograd: the backward sums the cotangent of the
    whole [world·n, ...] over the ranks onto each shard's owner
    (``reduce_scatter``), the transpose of rain_tpu's ``all_gather``
    (``psum_scatter``)."""
    return _GatherShards.apply(x, group)
