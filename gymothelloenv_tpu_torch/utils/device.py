"""Device resolution and float32 numerics for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; it, and a CUDA device asked
    for by name, raise when there is no card, so the port never quietly
    falls back to the CPU.  Pass ``device="cpu"`` to run on the CPU on
    purpose."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the port on the CPU")
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def describe(device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them
    (the name alone where nvidia-smi cannot be run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


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
