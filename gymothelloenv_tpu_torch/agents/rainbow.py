"""Rainbow DQN — the port of ``agents/rainbow.py``: noisy linear layers
(factorized Gaussian noise; Fortunato et al.) for exploration without
epsilon, and the C51 distributional head (Bellemare et al.) with the
projected-Bellman cross-entropy loss, on the DQN stack's double action
selection, dueling heads, n-step returns and prioritized replay.

Noise is one factorized sample a forward, shared by the whole batch: each
``NoisyLinear`` takes ``f_in`` (n_in,) and ``f_out`` (out,) standard
normals and perturbs its weights by ``w_sigma * outer(f(f_in), f(f_out))``
with ``f(e) = sign(e) sqrt|e|``.  A noisy forward of ``RainbowNet`` takes
its four layers' normals as one vector of ``noise_size``, drawn by one
``draws.normals`` call (``train.self_play.Draws``; the tests inject JAX's,
which JAX derives from the layer keys).  Acting draws one sample a ply;
an update draws three: the online net's (picks a*), the target's
(evaluates it) and the trained forward's.  ``noise=None`` is the
mean-weight (noise-off) forward of evaluation and of the pool's frozen
opponents.

The net returns RAW atom logits; the loss takes the action's row first
(a gather, exact) and normalizes over the 51 atoms after, as JAX does.
The optimizer is optax ``adam(lr, eps=1.5e-4)``: ``torch.optim.Adam``,
whose eps sits outside the root as optax's does, with its state mapped to
and from optax's tree (``agents.ppo.adam_optax_state``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from gymothelloenv_tpu_torch.agents.dqn import (DQNState, featurize3,
                                                frozen_copy,
                                                greedy_legal_action)
from gymothelloenv_tpu_torch.agents.ppo import Adam
from gymothelloenv_tpu_torch.agents.replay import (Replay, ReplayConfig,
                                                   replay_gather,
                                                   replay_sample_idx,
                                                   replay_update_priorities)
from gymothelloenv_tpu_torch.models.nets import (ConvTrunk,
                                                 torch_default_init,
                                                 trunk_side)
from gymothelloenv_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RainbowConfig:
    """JAX's ``RainbowConfig``; it carries the fields the DQN collection
    loop reads from ``DQNConfig``."""
    board_size: int = 8
    state_channels: int = 3
    gamma: float = 0.99
    n_step: int = 3
    num_atoms: int = 51
    v_min: float = -1.0          # reward/64-scaled disk diffs live in +-1
    v_max: float = 1.0
    lr: float = 6.25e-5
    adam_eps: float = 1.5e-4
    batch_size: int = 32
    target_update_interval: int = 10_000
    train_interval: int = 4
    initial_replay_size: int = 20_000
    reward_scale: float = 1.0 / 64.0

    @property
    def num_actions(self) -> int:
        return self.board_size ** 2

    @property
    def gamma_n(self) -> float:
        return self.gamma ** self.n_step

    def support(self, device=None) -> torch.Tensor:
        """float32 (num_atoms,) atom values, ``linspace(v_min, v_max)``;
        within one float32 spacing of ``jnp.linspace``'s, which XLA
        rounds its own way."""
        return torch.linspace(self.v_min, self.v_max, self.num_atoms,
                              device=device)


def _scale_noise(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(torch.abs(e))


class NoisyLinear(nn.Module):
    """flax ``NoisyDense``: leaves ``w_mu`` and ``w_sigma`` ``(in, out)``,
    ``b_mu`` and ``b_sigma`` ``(out,)`` in flax's layout.  Init as JAX's:
    ``w_mu``/``b_mu`` uniform in [0, 1/sqrt(in)) (flax's ``uniform(scale)``
    draws from [0, scale)), both sigmas ``sigma0 / sqrt(in)``."""

    def __init__(self, in_features: int, out_features: int,
                 sigma0: float = 0.5):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.sigma0 = sigma0
        self.w_mu = nn.Parameter(torch.empty(in_features, out_features))
        self.b_mu = nn.Parameter(torch.empty(out_features))
        self.w_sigma = nn.Parameter(torch.empty(in_features, out_features))
        self.b_sigma = nn.Parameter(torch.empty(out_features))

    @property
    def noise_size(self) -> int:
        return self.in_features + self.out_features

    def reset_parameters(self, generator: torch.Generator | None = None):
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.w_mu.uniform_(0.0, bound, generator=generator)
            self.b_mu.uniform_(0.0, bound, generator=generator)
            self.w_sigma.fill_(self.sigma0 / math.sqrt(self.in_features))
            self.b_sigma.fill_(self.sigma0 / math.sqrt(self.in_features))

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        """``noise``: ``[f_in, f_out]`` (``noise_size``,) raw normals, or
        None for the mean weights."""
        if noise is None:
            return x @ self.w_mu + self.b_mu
        f_in, f_out = (_scale_noise(e) for e in torch.split(
            noise, (self.in_features, self.out_features)))
        w = self.w_mu + self.w_sigma * torch.outer(f_in, f_out)
        return x @ w + (self.b_mu + self.b_sigma * f_out)


class RainbowNet(nn.Module):
    """Conv trunk over ``featurize3`` planes -> noisy dueling C51 heads
    (JAX ``RainbowNet``): advantage and value branches of ``hidden``
    noisy units, then ``A x num_atoms`` advantage and ``num_atoms`` value
    atoms; ``forward(x, noise)`` returns the RAW atom logits
    ``val + adv - mean_a(adv)``, shape (N, A, num_atoms)."""

    FLAX_MODULES = {"trunk.conv0": ("ConvTrunk_0", "Conv_0"),
                    "trunk.conv1": ("ConvTrunk_0", "Conv_1"),
                    "trunk.conv2": ("ConvTrunk_0", "Conv_2"),
                    "adv_fc": ("NoisyDense_0",), "val_fc": ("NoisyDense_1",),
                    "adv": ("NoisyDense_2",), "val": ("NoisyDense_3",)}

    def __init__(self, num_actions: int = 64, num_atoms: int = 51,
                 hidden: int = 128, board_size: int = 8):
        super().__init__()
        self.num_actions, self.num_atoms = num_actions, num_atoms
        self.trunk = ConvTrunk(in_channels=3)
        side = trunk_side(board_size)
        self.adv_fc = NoisyLinear(64 * side * side, hidden)
        self.val_fc = NoisyLinear(64 * side * side, hidden)
        self.adv = NoisyLinear(hidden, num_actions * num_atoms)
        self.val = NoisyLinear(hidden, num_atoms)

    def _noisy(self):
        """The noisy layers in the order of JAX's four noise keys."""
        return (self.adv_fc, self.val_fc, self.adv, self.val)

    @property
    def noise_size(self) -> int:
        return sum(layer.noise_size for layer in self._noisy())

    def reset_parameters(self, generator: torch.Generator | None = None):
        torch_default_init(self.trunk, generator)
        for layer in self._noisy():
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        h = self.trunk(x)
        parts = ((None,) * 4 if noise is None else torch.split(
            noise, [layer.noise_size for layer in self._noisy()]))
        adv = torch.relu(self.adv_fc(h, parts[0]))
        val = torch.relu(self.val_fc(h, parts[1]))
        adv = self.adv(adv, parts[2]).reshape(
            adv.shape[:-1] + (self.num_actions, self.num_atoms))
        val = self.val(val, parts[3]).reshape(
            val.shape[:-1] + (1, self.num_atoms))
        return val + adv - adv.mean(dim=-2, keepdim=True)


def make_rainbow_net(cfg: RainbowConfig, seed: int = 0,
                     device=None) -> RainbowNet:
    net = RainbowNet(num_actions=cfg.num_actions, num_atoms=cfg.num_atoms,
                     board_size=cfg.board_size)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def rainbow_init(cfg: RainbowConfig, seed: int = 0,
                 device=None) -> DQNState:
    net = make_rainbow_net(cfg, seed, device)
    return DQNState(net=net, target=frozen_copy(net),
                    optimizer=Adam(net.parameters(), cfg.lr, cfg.adam_eps))


def expected_q(logits: torch.Tensor, cfg: RainbowConfig) -> torch.Tensor:
    """(..., A, atoms) RAW atom logits -> (..., A) expected values."""
    return (torch.softmax(logits, dim=-1)
            * cfg.support(logits.device)).sum(dim=-1)


def draw_noise(net: RainbowNet, draws, device) -> torch.Tensor:
    """One noisy forward's normals (``net.noise_size``,) from ``draws``."""
    return draws.normals(net.noise_size, device)


@torch.no_grad()
def rainbow_act(net: RainbowNet, board, turn, legal, draws,
                cfg: RainbowConfig) -> torch.Tensor:
    """Greedy over the expected Q of the noisy net, one noise sample for
    the batch: exploration comes from the noise, not epsilon.  int64
    (N,)."""
    logits = net(featurize3(board, turn),
                 draw_noise(net, draws, board.device))
    return greedy_legal_action(expected_q(logits, cfg), legal)


def _project_distribution(next_probs: torch.Tensor,
                          rewards: torch.Tensor, not_done: torch.Tensor,
                          cfg: RainbowConfig) -> torch.Tensor:
    """The categorical projection of ``r + gamma^n z`` onto the support
    (C51) in JAX's linear-interpolation form: source atom j at position
    ``b`` gives ``max(0, 1 - |b - k|)`` of its mass to atom k, one einsum
    over (N, atoms, atoms)."""
    z = cfg.support(next_probs.device)
    tz = rewards[:, None] + not_done[:, None] * cfg.gamma_n * z[None, :]
    tz = torch.clamp(tz, cfg.v_min, cfg.v_max)
    dz = (cfg.v_max - cfg.v_min) / (cfg.num_atoms - 1)
    b = (tz - cfg.v_min) / dz
    k = torch.arange(cfg.num_atoms, dtype=torch.float32,
                     device=next_probs.device)
    w = torch.clamp(1.0 - torch.abs(b[:, :, None] - k[None, None, :]),
                    0.0, 1.0)
    return torch.einsum("ns,nst->nt", next_probs, w)


def _row(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """(N, A, atoms) -> (N, atoms): each sample's action row."""
    idx = action.to(torch.int64)[:, None, None].expand(-1, 1,
                                                        logits.shape[-1])
    return logits.gather(1, idx)[:, 0]


def rainbow_loss_grads(state: DQNState, cfg: RainbowConfig, batch, draws):
    """The C51 loss (JAX ``rainbow_loss_grads``): the online net with its
    noise picks ``a*`` by expected Q, the target net with its own noise
    gives a*'s distribution, projected onto the support; the trained
    forward (a third noise sample) takes the action's row, log-softmax
    over the atoms, and the KL to the projection.  The gradients of the
    mean KL land in the online net's ``.grad``.  ``batch``: ``(board,
    turn, action, reward, next_board, next_turn, done)``.  Returns
    ``(loss, kl)``, ``kl`` per sample."""
    board, turn, action, reward, next_board, next_turn, done = batch
    dev = board.device
    with torch.no_grad():
        next_obs = featurize3(next_board, next_turn)
        online_next = state.net(next_obs,
                                draw_noise(state.net, draws, dev))
        next_a = torch.argmax(expected_q(online_next, cfg), dim=-1)
        target_next = state.target(next_obs, draw_noise(state.target,
                                                        draws, dev))
        next_probs = torch.softmax(_row(target_next, next_a), dim=-1)
        proj = _project_distribution(next_probs, reward,
                                    1.0 - done.to(torch.float32), cfg)
    logits = state.net(featurize3(board, turn),
                       draw_noise(state.net, draws, dev))
    log_pa = torch.log_softmax(_row(logits, action), dim=-1)
    kl = -(proj * log_pa).sum(dim=-1)
    loss = kl.mean()
    state.optimizer.zero_grad()
    loss.backward()
    return loss.detach(), kl.detach()


def rainbow_train_batch(state: DQNState, replay: Replay, cfg: RainbowConfig,
                        rb_cfg: ReplayConfig, draws) -> torch.Tensor:
    """One C51 update (JAX ``rainbow_train_batch``): sample
    ``batch_size`` rows (a uniform each from ``draws``), the loss and
    its gradients, an Adam step, and with PER the rows' priorities set
    from their KL terms.  Returns the loss (0-d)."""
    u = draws.replay_uniforms(cfg.batch_size, replay.priority.device)
    idx = replay_sample_idx(replay, rb_cfg, u)
    loss, kl = rainbow_loss_grads(state, cfg, replay_gather(replay, idx),
                                  draws)
    state.optimizer.step()
    if rb_cfg.prioritized:
        replay_update_priorities(replay, rb_cfg, idx, kl)
    return loss
