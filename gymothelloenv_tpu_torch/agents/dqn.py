"""DQN agent — the port of ``agents/dqn.py`` (``DQNAgent``, dqn.py:135-503):
epsilon-greedy over legal moves, n-step returns, a target network,
optional Double DQN, the dueling net and prioritized replay, RMSprop, and
rewards scaled by 1/64.

The optimizer is optax's ``rmsprop(lr, eps=0.01, momentum=0.95)`` rebuilt
by hand (``RMSprop``): ``torch.optim.RMSprop`` adds eps outside the root
and applies the learning rate after the momentum, which is another
update.  Its state maps to and from optax's ``(ScaleByRmsState(nu),
EmptyState, TraceState(trace))``, so checkpoints go both ways with the
JAX trainer's.

Randomness comes from a draws object (``train.self_play.Draws`` or the
tests' ``InjectedDraws``): a uniform a game for the epsilon test, the
index of the random legal move, and a uniform a sampled replay row.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.replay import (Replay, ReplayConfig,
                                                   replay_gather,
                                                   replay_sample_idx,
                                                   replay_update_priorities)
from gymothelloenv_tpu_torch.core.engine import nth_legal
from gymothelloenv_tpu_torch.models.nets import DQNNet, DuelingDQNNet
from gymothelloenv_tpu_torch.parallel.sharding import (all_gather_cat,
                                                       all_reduce_grads)
from gymothelloenv_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Defaults as DQNAgent.__init__ (dqn.py:136-199)."""
    board_size: int = 8
    state_channels: int = 3        # state_length (3-plane make_state)
    gamma: float = 0.99
    n_step: int = 1
    double: bool = False
    dueling: bool = False
    lr: float = 0.00025
    rms_eps: float = 0.01
    rms_momentum: float = 0.95
    batch_size: int = 32
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.1
    annealing_steps: int = 1_000_000
    initial_replay_size: int = 20_000
    target_update_interval: int = 10_000
    train_interval: int = 4
    reward_scale: float = 1.0 / 64.0   # dqn.py:292
    test_epsilon: float = 0.05         # dqn.py:481

    @property
    def gamma_n(self) -> float:
        return self.gamma ** self.n_step

    @property
    def num_actions(self) -> int:
        return self.board_size ** 2


class RMSprop:
    """optax ``rmsprop(lr, decay, eps, momentum)`` (``scale_by_rms`` ->
    ``scale_by_learning_rate`` -> ``trace``, or ``identity`` without
    momentum), on ``.grad``:

        nu = (1 - decay) g^2 + decay nu;  u = -lr * g / sqrt(nu + eps)
        trace = u + momentum * trace;     p += trace   (p += u without)

    ``nu`` and the trace start at 0, and eps sits inside the root.
    ``momentum=None`` is optax's default (A2C's optimizer)."""

    def __init__(self, params, lr: float, eps: float = 0.01,
                 momentum: float | None = 0.95, decay: float = 0.9):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.eps, self.momentum, self.decay = (lr, eps, momentum,
                                                        decay)
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.trace = ([torch.zeros_like(p) for p in self.params]
                      if momentum is not None else None)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for i, (p, nu) in enumerate(zip(self.params, self.nu)):
            g = p.grad
            nu.mul_(self.decay).add_((1.0 - self.decay) * (g * g))
            u = torch.rsqrt(nu + self.eps) * g * -self.lr
            if self.trace is None:
                p.add_(u)
                continue
            self.trace[i].mul_(self.momentum).add_(u)
            p.add_(self.trace[i])

    def to_optax_state(self, to_tree) -> dict:
        """optax's state as flax stores it: ``{"0": {"nu": tree}, "1": {},
        "2": {"trace": tree}}`` (``"2": {}`` without momentum),
        ``to_tree`` mapping one tensor a parameter to the flax tree
        (``models.convert.flax_tree``)."""
        trace = {} if self.trace is None else {"trace": to_tree(self.trace)}
        return {"0": {"nu": to_tree(self.nu)}, "1": {}, "2": trace}

    def load_optax_state(self, state, from_tree) -> None:
        """The inverse of ``to_optax_state``; another layout raises
        ``ValueError``."""
        want = set() if self.trace is None else {"trace"}
        if (not isinstance(state, dict) or set(state) != {"0", "1", "2"}
                or set(state["0"]) != {"nu"} or state["1"]
                or set(state["2"]) != want):
            layout = ("without momentum ({'0': {'nu'}, '1': {}, '2': {}})"
                      if self.trace is None else "with momentum ({'0': "
                      "{'nu'}, '1': {}, '2': {'trace'}})")
            raise ValueError("optimizer state is not the layout of optax "
                             f"rmsprop {layout}")
        pairs = [(self.nu, from_tree(state["0"]["nu"]))]
        if self.trace is not None:
            pairs.append((self.trace, from_tree(state["2"]["trace"])))
        for dst, src in pairs:
            for d, s in zip(dst, src, strict=True):
                d.copy_(s)


@dataclasses.dataclass
class DQNState:
    net: torch.nn.Module       # online Q-network
    target: torch.nn.Module    # target Q-network (no grads)
    optimizer: RMSprop
    t: int = 0                 # transitions seen (dqn.py's self.t)


def make_dqn_net(cfg: DQNConfig, seed: int = 0, device=None) -> DQNNet:
    """A seeded ``DQNNet`` or ``DuelingDQNNet`` (``cfg.dueling``) on
    ``device``."""
    cls = DuelingDQNNet if cfg.dueling else DQNNet
    net = cls(num_actions=cfg.num_actions, board_size=cfg.board_size)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def make_dqn_optimizer(cfg: DQNConfig, params) -> RMSprop:
    """RMSprop(lr, eps=0.01, momentum=0.95) (dqn.py:244), optax's."""
    return RMSprop(params, cfg.lr, eps=cfg.rms_eps,
                   momentum=cfg.rms_momentum)


def frozen_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``net`` without gradients (the target, a snapshot)."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    return target


def dqn_init(cfg: DQNConfig, seed: int = 0, device=None) -> DQNState:
    net = make_dqn_net(cfg, seed, device)
    return DQNState(net=net, target=frozen_copy(net),
                    optimizer=make_dqn_optimizer(cfg, net.parameters()))


def epsilon_at(cfg: DQNConfig, t: int) -> torch.Tensor:
    """float32 0-d: the linear anneal, frozen until the replay warm-up
    ends (dqn.py:196-198, :283-284), in JAX's float32 steps."""
    rate = np.float32((cfg.initial_epsilon - cfg.final_epsilon)
                      / cfg.annealing_steps)
    steps = np.float32(max(t - cfg.initial_replay_size, 0))
    eps = np.float32(cfg.initial_epsilon) - rate * steps
    return torch.tensor(max(eps, np.float32(cfg.final_epsilon)),
                        dtype=torch.float32)


def featurize3(board: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
    """float32 ``[black, white, turn]`` planes of signed int8 boards
    (run_2agent.py:29-46): the turn plane is ``(turn + 1) / 2``."""
    black = (board == -1).to(torch.float32)
    white = (board == 1).to(torch.float32)
    plane = ((turn.to(torch.float32) + 1.0) / 2.0)[..., None, None]
    return torch.stack([black, white, plane.expand_as(black)], dim=-3)


def greedy_legal_action(q: torch.Tensor, legal: torch.Tensor
                        ) -> torch.Tensor:
    """int64 argmax over the legal moves' Q values (dqn.py:270-273)."""
    return torch.argmax(torch.where(legal, q, torch.full_like(
        q, -float("inf"))), dim=-1)


@torch.no_grad()
def dqn_act(net: torch.nn.Module, board, turn, legal, epsilon, draws
            ) -> torch.Tensor:
    """Batched epsilon-greedy over legal moves (dqn.py:264-286): a game
    explores where its uniform from ``draws`` is at most ``epsilon`` and
    then plays the ``t``-th legal move (``t`` from ``draws``), else the
    greedy one.  int64 (N,)."""
    n = board.shape[0]
    greedy = greedy_legal_action(net(featurize3(board, turn)), legal)
    random = nth_legal(legal, draws.legal_index(legal.sum(1)))
    explore = draws.uniforms(n, board.device) <= epsilon
    return torch.where(explore, random, greedy)


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """optax ``huber_loss`` elementwise."""
    err = (pred - target).abs()
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad * quad + delta * (err - quad)


def dqn_loss_grads(state: DQNState, cfg: DQNConfig, batch, denom=None):
    """The target ``y = r + gamma^n * max_a' targetQ(s', a')`` (Double: the
    online argmax, dqn.py:439-444; ``gamma^n`` in both branches, as JAX),
    a Huber loss (delta 1) on the gathered Q; the gradients land in the
    online net's ``.grad``.  ``batch``: ``(board, turn, action, reward,
    next_board, next_turn, done)``.  ``denom``: the loss's denominator
    (``None``: the mean; on a mesh the whole minibatch's row count, of
    which ``batch`` is one rank's share).  Returns ``(loss, td)``."""
    board, turn, action, reward, next_board, next_turn, done = batch
    action = action.to(torch.int64)
    with torch.no_grad():
        next_obs = featurize3(next_board, next_turn)
        target_q = state.target(next_obs)
        if cfg.double:
            next_a = torch.argmax(state.net(next_obs), dim=-1)
            boot = target_q.gather(1, next_a[:, None])[:, 0]
        else:
            boot = target_q.max(dim=-1).values
        y = reward + (1.0 - done.to(torch.float32)) * cfg.gamma_n * boot
    q = state.net(featurize3(board, turn))
    q_a = q.gather(1, action[:, None])[:, 0]
    err = huber(q_a, y)
    loss = err.mean() if denom is None else err.sum() / denom
    state.optimizer.zero_grad()
    loss.backward()
    return loss.detach(), (y - q_a).detach()


def data_parallel_loss(state: DQNState, loss_grads, batch, mesh):
    """A minibatch's loss and per-row errors with its gradients in the
    online net's ``.grad``, by ``loss_grads(rows[, denom]) -> (loss,
    errors)``: the whole ``batch`` without a mesh (no ``denom``); on a
    mesh (JAX ``shard_minibatch_idx``: the rows sharded over ``data``)
    this data index's contiguous share of the rows, the loss divided by
    the whole minibatch's count, the gradients and the loss summed over
    the data axis in one collective and the errors all-gathered back into
    slot order, so every rank holds the world-1 gradients, loss and
    errors.  The rows must divide by the data axis."""
    if mesh is None:
        return loss_grads(batch)
    n = batch[0].shape[0]
    per, off = mesh.shard(n)
    loss, err = loss_grads(tuple(f[off:off + per] for f in batch), n)
    total = loss.reshape(1).clone()
    all_reduce_grads(state.optimizer.params, mesh, [total])
    return total[0], all_gather_cat(err, mesh)


def dqn_train_batch(state: DQNState, replay: Replay, cfg: DQNConfig,
                    rb_cfg: ReplayConfig, draws, mesh=None) -> torch.Tensor:
    """One minibatch update (train_network, dqn.py:407-467): sample
    ``batch_size`` rows (a uniform each from ``draws``), the loss and its
    gradients, an RMSprop step, and with PER the priorities of the rows
    refreshed from their TD errors.  ``mesh``: every rank holds the same
    replay and draws the same rows (global sampling), the gradients are
    data parallel (``data_parallel_loss``), and every rank refreshes the
    priorities of its whole replica from every row's TD error, so the
    replicas stay equal.  Returns the loss (0-d)."""
    u = draws.replay_uniforms(cfg.batch_size, replay.priority.device)
    idx = replay_sample_idx(replay, rb_cfg, u)
    loss, td = data_parallel_loss(
        state, lambda rows, *denom: dqn_loss_grads(state, cfg, rows, *denom),
        replay_gather(replay, idx), mesh)
    state.optimizer.step()
    if rb_cfg.prioritized:
        replay_update_priorities(replay, rb_cfg, idx, td)
    return loss


def maybe_sync_target(state: DQNState, crossed: bool) -> DQNState:
    """Copy online -> target when the interval boundary was crossed
    (dqn.py:357-358)."""
    if crossed:
        state.target.load_state_dict(state.net.state_dict())
    return state
