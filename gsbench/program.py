"""The system under test, as the benchmark drives it: rain_tpu_torch's
compiled step (``train.compiled.CompiledStep``: ``train_step``,
``eval_render`` and ``sharded_train_step`` captured once per key and
replayed as CUDA graphs), its state types, its kernel build, and for a
cell of several cards its launcher (``parallel.launch.spawn``: one
process per card, joined in one NCCL group), its shards of the state
(``parallel.sharding``) and its collectives (``parallel.distributed``).
Nothing else of the program is used: the inputs are the benchmark's, and
the plain reference imports none of this.
"""

from __future__ import annotations

import torch

import rain_tpu_torch  # noqa: F401  (pins f32 products to full precision)
from rain_tpu_torch import _build
from rain_tpu_torch.model import adam
from rain_tpu_torch.model import gaussians
from rain_tpu_torch.parallel import distributed, launch, sharding
from rain_tpu_torch.train import compiled

LEAVES = gaussians.GaussianParams._fields
STATS = gaussians.STAT_FIELDS
BETA1 = adam.BETA1


def build_kernels(device: torch.device) -> list[str]:
    """Build the program's CUDA kernels that are not built yet (into its
    fixed ``rain_tpu_torch/_build/``); the sources built by this call."""
    if device.type != "cuda":
        return []
    return sorted(_build.build_all())


def state(params: dict) -> gaussians.GaussianState:
    """A state of every row alive over ``params`` (the tensors are used,
    not copied), with zero statistics."""
    n = params["xyz"].shape[0]
    dev = params["xyz"].device
    return gaussians.GaussianState(
        gaussians.GaussianParams(**{k: params[k] for k in LEAVES}), n,
        *[torch.zeros(n, device=dev) for _ in STATS])


def adam_init(st: gaussians.GaussianState) -> adam.AdamState:
    return adam.init(st.params)


def compiled_step() -> compiled.CompiledStep:
    return compiled.CompiledStep()


def params_of(st: gaussians.GaussianState) -> dict:
    return st.params._asdict()


def stats_of(st: gaussians.GaussianState) -> dict:
    return {k: getattr(st, k) for k in STATS}


def first_moments(opt: adam.AdamState) -> dict:
    return opt.mu._asdict()


# --- a cell of several cards ---------------------------------------------
spawn = launch.spawn


def shard(st: gaussians.GaussianState) -> gaussians.GaussianState:
    """This rank's shard of a whole state (rows rank·C/D to (rank+1)·C/D)."""
    return sharding.shard_state(st, distributed.rank(),
                                distributed.world_size())


def max_over_ranks(value: float, device: torch.device) -> float:
    """The largest of every rank's ``value`` (an all-reduce, which every
    rank joins and waits for: a barrier)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    return float(distributed.all_reduce(t, "max"))


def leave_out_exchange() -> None:
    """A fault for the check's calibration and tests, planted in this
    process: every later gather of the sharded step's render streams keeps
    this rank's own rows and zeros the other ranks', as if the exchange
    between the cards were left out."""
    def local(x: torch.Tensor, group=None) -> torch.Tensor:
        r, world = distributed.rank(group), distributed.world_size(group)
        return torch.cat([x if i == r else torch.zeros_like(x)
                          for i in range(world)])
    distributed.gather_shards = local
