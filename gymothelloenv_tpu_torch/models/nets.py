"""``PolicyNet`` with the ``conv`` trunk, feed-forward or with a GRU core,
and the frame-stack cell — the port of ``models/nets.py`` (``ConvTrunk``
impl="conv", ``GRUCore``, ``PolicyNet``; the vendored masked ``Policy`` +
``CNNBase``, model.py:19-98, :201-314) and of ``train/ppo_trainer.py::
make_apply_fn_framestack``.

Input is NCHW ``(N, 4K, 8, 8)`` float32 as in JAX (K > 1 with frame
stacking).  The JAX trunk runs in NHWC and flattens its ``(2, 2, C)``
output as ``(h, w, c)``; this trunk runs in NCHW, so it permutes to NHWC
before the flatten and the fc weights carry over unchanged
(``models/convert.py``).

``dtype=torch.bfloat16`` computes as flax's ``PolicyNet(dtype=bfloat16)``
does, with explicit casts: the parameters stay float32; the trunk and the
three Dense layers cast their input and weights to bfloat16, compute the
product in bfloat16 and add the bias in bfloat16 (flax adds it after the
product, a second rounding); the GRU has no dtype, so flax promotes it to
float32 and its hidden state stays float32; the heads cast logits and
value back to float32.  ``torch.autocast`` is not used: its op list would
run the GRU's matmuls in bfloat16 too.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from gymothelloenv_tpu_torch.utils.device import resolve_device


def _apply(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype):
    """``layer`` (a Conv2d or Linear) on ``x`` at ``dtype``: as the layer
    itself in float32; else input and weights cast to ``dtype``, the
    product, then the bias added at ``dtype``."""
    if dtype == torch.float32:
        return layer(x)
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(layer, nn.Conv2d):
        y = F.conv2d(x, w, None, layer.stride, layer.padding)
        return y + b[:, None, None]
    return F.linear(x, w) + b


class ConvTrunk(nn.Module):
    """conv(32w, k3, s2, p1) -> conv(64w, k2) -> conv(64w, k2), ReLU after
    each, then an NHWC flatten (dqn.py:84-94 / model.py:295-299)."""

    def __init__(self, in_channels: int = 4, width_mult: int = 1):
        super().__init__()
        c0, c1, c2 = 32 * width_mult, 64 * width_mult, 64 * width_mult
        self.conv0 = nn.Conv2d(in_channels, c0, 3, stride=2, padding=1)
        self.conv1 = nn.Conv2d(c0, c1, 2)
        self.conv2 = nn.Conv2d(c1, c2, 2)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        for conv in (self.conv0, self.conv1, self.conv2):
            x = torch.relu(_apply(conv, x, dtype))
        return x.permute(0, 2, 3, 1).flatten(1)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell`` (flax 0.12) from its six leaves: ``ir``, ``iz``,
    ``in`` with a bias each, ``hr``, ``hz`` without one, and ``hn`` with
    one (``in`` is the attribute ``in_``).  ``torch.nn.GRUCell`` would
    carry trainable ``b_hr``/``b_hz``, which flax does not have.

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
        n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h
    """

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.ir = nn.Linear(in_features, hidden_size)
        self.iz = nn.Linear(in_features, hidden_size)
        self.in_ = nn.Linear(in_features, hidden_size)
        self.hr = nn.Linear(hidden_size, hidden_size, bias=False)
        self.hz = nn.Linear(hidden_size, hidden_size, bias=False)
        self.hn = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class PolicyNet(nn.Module):
    """Masked actor-critic: trunk -> fc(hidden) + ReLU [-> GRU(hidden)]
    -> value (1) and logits (64).  Orthogonal init: relu gain for trunk
    and fc, 0.01 for the logits, 1.0 for the value and the GRU's kernels,
    zero biases (model.py:291-304, flax ``GRUCell``'s orthogonal
    kernels).

    ``forward(x)`` gives ``(logits, value)``; a recurrent net's
    ``forward(x, h, mask)`` gives ``(logits, value, h')`` with ``h``
    zeroed where ``mask`` is 0 before the step.  ``features`` / ``core`` /
    ``heads`` split the forward as JAX's methods do, so the recurrent
    update runs the trunk once over every step of a minibatch."""

    def __init__(self, num_actions: int = 64, hidden_size: int = 512,
                 width_mult: int = 1, board_size: int = 8,
                 recurrent: bool = False, in_channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.recurrent = recurrent
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.trunk = ConvTrunk(in_channels, width_mult)
        side = board_size // 2 - 2          # 8 -> 4 -> 3 -> 2
        self.fc = nn.Linear(64 * width_mult * side * side, hidden_size)
        if recurrent:
            self.gru = GRUCell(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, 1)
        self.logits = nn.Linear(hidden_size, num_actions)

    def reset_parameters(self, generator: torch.Generator | None = None):
        relu_gain = math.sqrt(2.0)
        layers = [(m, relu_gain) for m in (*self.trunk.children(), self.fc)]
        if self.recurrent:
            layers += [(m, 1.0) for m in self.gru.children()]
        layers += [(self.value, 1.0), (self.logits, 0.01)]
        for layer, gain in layers:
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Trunk + fc + ReLU -> (N, hidden) at the net's dtype."""
        return torch.relu(_apply(self.fc, self.trunk(x, self.dtype),
                                 self.dtype))

    def core(self, feat: torch.Tensor, h: torch.Tensor, mask: torch.Tensor):
        """One GRU step in float32 -> ``(y, h')``, ``y`` being ``h'``."""
        h = h * mask[..., None]
        h = self.gru(feat.to(torch.float32), h)
        return h, h

    def heads(self, y: torch.Tensor):
        """``(logits, value)`` in float32."""
        logits = _apply(self.logits, y, self.dtype)
        value = _apply(self.value, y, self.dtype)[..., 0]
        return logits.to(torch.float32), value.to(torch.float32)

    def forward(self, x: torch.Tensor, h: torch.Tensor | None = None,
                mask: torch.Tensor | None = None):
        """``x`` float32 (N, C, 8, 8) -> ``(logits (N, A), value (N,))``,
        and the new hidden state (N, hidden) for a recurrent net."""
        y = self.features(x)
        if not self.recurrent:
            return self.heads(y)
        if h is None or mask is None:
            raise ValueError("recurrent PolicyNet needs (h, mask)")
        y, h = self.core(y, h, mask)
        return (*self.heads(y), h)


class FrameStackCell(nn.Module):
    """Frame stacking as a recurrent cell (JAX ``make_apply_fn_framestack``;
    VecPyTorchFrameStack, envs.py:210-250): ``h`` packs the previous
    ``nstack - 1`` observations flat; ``forward(obs, h, mask)`` feeds
    ``[h * mask frames, obs]`` (newest in the last 4 channels) to the
    feed-forward ``net`` and returns ``(logits, value, window[4:])``, the
    window shifted by one frame.  So the recurrent collector, update and
    evaluation drive frame stacking unchanged."""

    recurrent = True

    def __init__(self, net: PolicyNet, nstack: int):
        super().__init__()
        self.net = net
        self.nstack = nstack
        self.hidden_size = (nstack - 1) * 4 * 64

    def forward(self, obs: torch.Tensor, h: torch.Tensor,
                mask: torch.Tensor):
        n = obs.shape[0]
        prev = (h * mask[:, None]).reshape(n, (self.nstack - 1) * 4, 8, 8)
        x = torch.cat([prev, obs.to(prev.dtype)], dim=1)
        logits, value = self.net(x)
        return logits, value, x[:, 4:].reshape(n, self.hidden_size)


def params_net(policy: nn.Module) -> PolicyNet:
    """The ``PolicyNet`` that holds a policy's parameters: the net itself,
    or a ``FrameStackCell``'s."""
    return policy.net if isinstance(policy, FrameStackCell) else policy


def make_policy_net(width_mult: int = 1, hidden_size: int = 512,
                    seed: int = 0, device=None, recurrent: bool = False,
                    in_channels: int = 4,
                    dtype: torch.dtype = torch.float32) -> PolicyNet:
    """A seeded orthogonal init of ``PolicyNet`` on ``device``."""
    device = resolve_device(device)
    net = PolicyNet(hidden_size=hidden_size, width_mult=width_mult,
                    recurrent=recurrent, in_channels=in_channels,
                    dtype=dtype)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(device).eval()
