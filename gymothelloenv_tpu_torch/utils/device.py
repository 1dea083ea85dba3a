"""Device resolution and float32 numerics for the port's entry points."""

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


FLOAT32 = "float32, TF32 off for matmul and cuDNN"


def use_float32() -> str:
    """Compute float32 matmuls and cuDNN convolutions in full float32.

    torch leaves ``torch.backends.cudnn.allow_tf32`` True, so a card
    convolves float32 inputs in TF32 (a 10-bit mantissa) unless told
    otherwise; the port holds its net, loss and update to the JAX
    package's float32.  Every entry point that runs the net calls this.
    The flags are process-wide.  Returns a description for a log line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return FLOAT32
