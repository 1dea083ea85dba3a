"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; it raises when there is no
    card, so the port never quietly falls back to the CPU.  Pass
    ``device="cpu"`` to run on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
