"""The default device of the port's entry points."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is available: the port never carries on silently on
    the CPU. Pass ``device="cpu"`` to run the plain PyTorch path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rain_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def scalar(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor. A tensor is converted where it
    lies; a Python number is filled on ``device``: a fill is a launch,
    where a copy from host memory would wait for the device."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype)
    return torch.full((), value, dtype=dtype, device=device)
