"""Feed-forward ``PolicyNet`` with the ``conv`` trunk — the port of
``models/nets.py`` (``ConvTrunk`` impl="conv", ``PolicyNet`` with
``recurrent=False``; the vendored masked ``Policy`` + ``CNNBase``,
model.py:19-98, :288-314).

Input is NCHW ``(N, 4, 8, 8)`` float32 as in JAX.  The JAX trunk runs in
NHWC and flattens its ``(2, 2, C)`` output as ``(h, w, c)``; this trunk
runs in NCHW, so it permutes to NHWC before the flatten and the fc weights
carry over unchanged (``models/convert.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gymothelloenv_tpu_torch.utils.device import resolve_device


class ConvTrunk(nn.Module):
    """conv(32w, k3, s2, p1) -> conv(64w, k2) -> conv(64w, k2), ReLU after
    each, then an NHWC flatten (dqn.py:84-94 / model.py:295-299)."""

    def __init__(self, in_channels: int = 4, width_mult: int = 1):
        super().__init__()
        c0, c1, c2 = 32 * width_mult, 64 * width_mult, 64 * width_mult
        self.conv0 = nn.Conv2d(in_channels, c0, 3, stride=2, padding=1)
        self.conv1 = nn.Conv2d(c0, c1, 2)
        self.conv2 = nn.Conv2d(c1, c2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return x.permute(0, 2, 3, 1).flatten(1)


class PolicyNet(nn.Module):
    """Masked actor-critic: trunk -> fc(hidden) + ReLU -> value (1) and
    logits (64).  Orthogonal init: relu gain for trunk and fc, 0.01 for
    the logits, 1.0 for the value, zero biases (model.py:291-304)."""

    def __init__(self, num_actions: int = 64, hidden_size: int = 512,
                 width_mult: int = 1, board_size: int = 8):
        super().__init__()
        self.trunk = ConvTrunk(4, width_mult)
        side = board_size // 2 - 2          # 8 -> 4 -> 3 -> 2
        self.fc = nn.Linear(64 * width_mult * side * side, hidden_size)
        self.value = nn.Linear(hidden_size, 1)
        self.logits = nn.Linear(hidden_size, num_actions)

    def reset_parameters(self, generator: torch.Generator | None = None):
        relu_gain = math.sqrt(2.0)
        layers = [(m, relu_gain) for m in (*self.trunk.children(), self.fc)]
        layers += [(self.value, 1.0), (self.logits, 0.01)]
        for layer, gain in layers:
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor):
        """``x`` float32 (N, 4, 8, 8) -> (logits (N, A), value (N,))."""
        y = torch.relu(self.fc(self.trunk(x)))
        return self.logits(y), self.value(y)[..., 0]


def make_policy_net(width_mult: int = 1, hidden_size: int = 512,
                    seed: int = 0, device=None) -> PolicyNet:
    """A seeded orthogonal init of ``PolicyNet`` on ``device``."""
    device = resolve_device(device)
    net = PolicyNet(hidden_size=hidden_size, width_mult=width_mult)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(device).eval()
