"""``PolicyNet`` with the ``conv`` trunk, feed-forward or with a GRU core,
the frame-stack cell, the DQN Q-networks and the actor-critic family —
the port of ``models/nets.py`` (``ConvTrunk`` impl="conv", ``GRUCore``,
``PolicyNet``, ``DQNNet``, ``DuelingDQNNet``, ``ActorCriticNet``,
``MLPBase``, ``DiagGaussianHead``, ``BernoulliHead``; the vendored masked
``Policy`` + ``CNNBase``/``MLPBase``, model.py:19-98, :201-348; dqn.py:
73-127; ppo.py:29-77; distributions.py:75-109) and of
``train/ppo_trainer.py::make_apply_fn_framestack``.

Input is NCHW ``(N, 4K, B, B)`` float32 as in JAX (K > 1 with frame
stacking).  The JAX trunk runs in NHWC and flattens its ``(s, s, C)``
output (``s = ceil(B / 2) - 2``: 2 on 8x8) as ``(h, w, c)``; this trunk
runs in NCHW, so it permutes to NHWC before the flatten and the fc
weights carry over unchanged (``models/convert.py``).  Where a valid
convolution's kernel is larger than its input (B = 4 ends at 0 x 0), flax
gives an empty output and the fc sees 0 features, so its output is its
bias; ``torch.nn.Conv2d`` would raise, so the trunk returns the empty
output itself.

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

from gymothelloenv_tpu_torch.models.distributions import (BernoulliDist,
                                                          DiagNormal)
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
            side = x.shape[-1] + 2 * conv.padding[0] - conv.kernel_size[0]
            if side < 0:
                # flax: a valid convolution of a smaller input is empty.
                x = x.new_zeros(x.shape[0], conv.out_channels, 0, 0,
                                dtype=dtype)
                continue
            x = torch.relu(_apply(conv, x, dtype))
        return x.permute(0, 2, 3, 1).flatten(1)


def trunk_side(board_size: int) -> int:
    """The trunk's output side for a ``board_size`` board: ``ceil(B / 2)
    - 2`` (conv0 halves with padding, each 2x2 valid conv takes one off),
    0 where it would be empty."""
    return max((board_size + 1) // 2 - 2, 0)


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
    -> value (1) and logits (``num_actions``, ``B * B``).  Orthogonal
    init: relu gain for trunk and fc, 0.01 for the logits, 1.0 for the
    value and the GRU's kernels, zero biases (model.py:291-304, flax
    ``GRUCell``'s orthogonal kernels).

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
        self.board_size = board_size
        self.dtype = dtype
        self.trunk = ConvTrunk(in_channels, width_mult)
        side = trunk_side(board_size)       # 8 -> 4 -> 3 -> 2
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
        """``x`` float32 (N, C, B, B) -> ``(logits (N, A), value (N,))``,
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
    VecPyTorchFrameStack, envs.py:210-250) on a ``board_size`` board:
    ``h`` packs the previous ``nstack - 1`` observations flat;
    ``forward(obs, h, mask)`` feeds
    ``[h * mask frames, obs]`` (newest in the last 4 channels) to the
    feed-forward ``net`` and returns ``(logits, value, window[4:])``, the
    window shifted by one frame.  So the recurrent collector, update and
    evaluation drive frame stacking unchanged."""

    recurrent = True

    def __init__(self, net: PolicyNet, nstack: int, board_size: int = 8):
        super().__init__()
        self.net = net
        self.nstack = nstack
        self.board_size = board_size
        self.hidden_size = (nstack - 1) * 4 * board_size * board_size

    def forward(self, obs: torch.Tensor, h: torch.Tensor,
                mask: torch.Tensor):
        n, b = obs.shape[0], self.board_size
        prev = (h * mask[:, None]).reshape(n, (self.nstack - 1) * 4, b, b)
        x = torch.cat([prev, obs.to(prev.dtype)], dim=1)
        logits, value = self.net(x)
        return logits, value, x[:, 4:].reshape(n, self.hidden_size)


def torch_default_init(net: nn.Module, generator=None) -> None:
    """torch's default kernel init (kaiming-uniform, ``a = sqrt(5)``; JAX's
    ``torch_default_init``) and zero biases, as flax's, on every conv and
    linear layer of ``net``."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            nn.init.zeros_(m.bias)


def _orthogonal(layers, generator=None) -> None:
    """Orthogonal kernels at each ``(layer, gain)``'s gain, zero biases."""
    for layer, gain in layers:
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        nn.init.zeros_(layer.bias)


class DQNNet(nn.Module):
    """Q-network (dqn.py:73-95; JAX ``DQNNet``): the trunk over 3 input
    planes (``agents.dqn.featurize3``) -> fc 128 + ReLU -> fc ``A``.
    ``FLAX_MODULES`` names each layer's flax module
    (``models/convert.py``)."""

    FLAX_MODULES = {"trunk.conv0": ("ConvTrunk_0", "Conv_0"),
                    "trunk.conv1": ("ConvTrunk_0", "Conv_1"),
                    "trunk.conv2": ("ConvTrunk_0", "Conv_2"),
                    "fc": ("Dense_0",), "out": ("Dense_1",)}

    def __init__(self, num_actions: int = 64, board_size: int = 8):
        super().__init__()
        self.board_size = board_size
        self.trunk = ConvTrunk(in_channels=3)
        side = trunk_side(board_size)
        self.fc = nn.Linear(64 * side * side, 128)
        self.out = nn.Linear(128, num_actions)

    def reset_parameters(self, generator: torch.Generator | None = None):
        torch_default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """float32 (N, 3, B, B) -> Q values (N, A)."""
        return self.out(torch.relu(self.fc(self.trunk(x))))


class DuelingDQNNet(DQNNet):
    """Dueling Q-network (dqn.py:97-127; JAX ``DuelingDQNNet``): advantage
    and value branches of 128 each, ``Q = V + A - mean(A)``.  flax makes
    ``Dense_0`` (advantage 128), ``Dense_1`` (value 128), ``Dense_2``
    (advantage -> A) and ``Dense_3`` (value -> 1), in that order."""

    FLAX_MODULES = {"trunk.conv0": ("ConvTrunk_0", "Conv_0"),
                    "trunk.conv1": ("ConvTrunk_0", "Conv_1"),
                    "trunk.conv2": ("ConvTrunk_0", "Conv_2"),
                    "adv_fc": ("Dense_0",), "val_fc": ("Dense_1",),
                    "adv": ("Dense_2",), "val": ("Dense_3",)}

    def __init__(self, num_actions: int = 64, board_size: int = 8):
        nn.Module.__init__(self)
        self.board_size = board_size
        self.trunk = ConvTrunk(in_channels=3)
        side = trunk_side(board_size)
        self.adv_fc = nn.Linear(64 * side * side, 128)
        self.val_fc = nn.Linear(64 * side * side, 128)
        self.adv = nn.Linear(128, num_actions)
        self.val = nn.Linear(128, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.trunk(x)
        adv = self.adv(torch.relu(self.adv_fc(feat)))
        val = self.val(torch.relu(self.val_fc(feat)))
        return val + adv - adv.mean(dim=-1, keepdim=True)


class ActorCriticNet(nn.Module):
    """The standalone PPO net (ppo.py:29-77; JAX ``ActorCriticNet``): the
    trunk -> fc 128 + ReLU -> raw logits (``num_actions``) and a value,
    torch's default init.  ``forward(x)`` gives ``(logits, value)``."""

    FLAX_MODULES = {"trunk.conv0": ("ConvTrunk_0", "Conv_0"),
                    "trunk.conv1": ("ConvTrunk_0", "Conv_1"),
                    "trunk.conv2": ("ConvTrunk_0", "Conv_2"),
                    "fc": ("Dense_0",), "logits": ("Dense_1",),
                    "value": ("Dense_2",)}

    def __init__(self, num_actions: int = 64, board_size: int = 8,
                 in_channels: int = 4):
        super().__init__()
        self.trunk = ConvTrunk(in_channels)
        side = trunk_side(board_size)
        self.fc = nn.Linear(64 * side * side, 128)
        self.logits = nn.Linear(128, num_actions)
        self.value = nn.Linear(128, 1)

    reset_parameters = torch_default_init

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.fc(self.trunk(x)))
        return self.logits(h), self.value(h)[..., 0]


class MLPBase(nn.Module):
    """2 x ``hidden_size`` tanh actor and critic towers (model.py:317-348;
    JAX ``MLPBase``): ``forward(x)`` gives ``(logits, value)`` of flat
    ``(..., in_features)`` inputs.  Orthogonal init: sqrt(2) for the
    towers, 1.0 for the value, 0.01 for the logits; zero biases.  flax
    names the layers in call order: ``Dense_0..1`` actor, ``Dense_2..3``
    critic, ``Dense_4`` value, ``Dense_5`` logits."""

    FLAX_MODULES = {"actor0": ("Dense_0",), "actor1": ("Dense_1",),
                    "critic0": ("Dense_2",), "critic1": ("Dense_3",),
                    "value": ("Dense_4",), "logits": ("Dense_5",)}

    def __init__(self, in_features: int, num_actions: int,
                 hidden_size: int = 64):
        super().__init__()
        self.actor0 = nn.Linear(in_features, hidden_size)
        self.actor1 = nn.Linear(hidden_size, hidden_size)
        self.critic0 = nn.Linear(in_features, hidden_size)
        self.critic1 = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, 1)
        self.logits = nn.Linear(hidden_size, num_actions)

    def reset_parameters(self, generator: torch.Generator | None = None):
        gain = math.sqrt(2.0)
        _orthogonal([(self.actor0, gain), (self.actor1, gain),
                     (self.critic0, gain), (self.critic1, gain),
                     (self.value, 1.0), (self.logits, 0.01)], generator)

    def forward(self, x: torch.Tensor):
        a = torch.tanh(self.actor1(torch.tanh(self.actor0(x))))
        c = torch.tanh(self.critic1(torch.tanh(self.critic0(x))))
        return self.logits(a), self.value(c)[..., 0]


class DiagGaussianHead(nn.Module):
    """``DiagGaussian`` (distributions.py:75-96; JAX ``DiagGaussianHead``):
    an orthogonal(1.0) mean projection (flax ``Dense_0``) and a
    state-independent log-std ``log_std``, zero at init.  ``forward(x)``
    gives a ``DiagNormal``."""

    FLAX_MODULES = {"mean": ("Dense_0",)}

    def __init__(self, in_features: int, num_outputs: int):
        super().__init__()
        self.mean = nn.Linear(in_features, num_outputs)
        self.log_std = nn.Parameter(torch.zeros(num_outputs))

    def reset_parameters(self, generator: torch.Generator | None = None):
        _orthogonal([(self.mean, 1.0)], generator)
        nn.init.zeros_(self.log_std)

    def forward(self, x: torch.Tensor) -> DiagNormal:
        mean = self.mean(x)
        return DiagNormal(mean=mean, log_std=self.log_std.expand_as(mean))


class BernoulliHead(nn.Module):
    """``Bernoulli`` (distributions.py:99-109; JAX ``BernoulliHead``): an
    orthogonal(1.0) logit projection (flax ``Dense_0``) over independent
    bits.  ``forward(x)`` gives a ``BernoulliDist``."""

    FLAX_MODULES = {"proj": ("Dense_0",)}

    def __init__(self, in_features: int, num_outputs: int):
        super().__init__()
        self.proj = nn.Linear(in_features, num_outputs)

    def reset_parameters(self, generator: torch.Generator | None = None):
        _orthogonal([(self.proj, 1.0)], generator)

    def forward(self, x: torch.Tensor) -> BernoulliDist:
        return BernoulliDist(logits=self.proj(x))


def params_net(policy: nn.Module) -> PolicyNet:
    """The ``PolicyNet`` that holds a policy's parameters: the net itself,
    or a ``FrameStackCell``'s."""
    return policy.net if isinstance(policy, FrameStackCell) else policy


def make_policy_net(width_mult: int = 1, hidden_size: int = 512,
                    seed: int = 0, device=None, recurrent: bool = False,
                    in_channels: int = 4,
                    dtype: torch.dtype = torch.float32,
                    board_size: int = 8) -> PolicyNet:
    """A seeded orthogonal init of ``PolicyNet`` on ``device`` for a
    ``board_size`` board."""
    device = resolve_device(device)
    net = PolicyNet(num_actions=board_size * board_size,
                    hidden_size=hidden_size, width_mult=width_mult,
                    board_size=board_size, recurrent=recurrent,
                    in_channels=in_channels, dtype=dtype)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(device).eval()
