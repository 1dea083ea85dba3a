"""What the measurement scripts share: JAX's ``--name=value`` arguments
and the device line every script prints first."""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.utils.device import (describe, resolve_device,
                                                  use_float32)


def flag(argv, name: str, default: str) -> str:
    """The value of ``--name=value`` in ``argv``, else ``default``."""
    return next((a.split("=", 1)[1] for a in argv
                 if a.startswith(f"--{name}=")), default)


def positional(argv) -> list:
    """The arguments that are not flags."""
    return [a for a in argv if not a.startswith("--")]


def setup(argv) -> torch.device:
    """``--device=`` (default ``cuda``; raises without a card), named on a
    first line with the card's power limit, and float32 numerics with TF32
    off."""
    dev = resolve_device(flag(argv, "device", "cuda"))
    print(f"device: {describe(dev)}; {use_float32()}", flush=True)
    return dev
