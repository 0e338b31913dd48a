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
