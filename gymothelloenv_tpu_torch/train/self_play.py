"""PPO self-play collector — the port of ``train/self_play.py``: mirror
self-play (one net plays both colours), or a frozen ``opp_net`` on the
non-learning colour (the opponent pool, JAX's ``opp_params``), with
random openings (``init_rand_steps``) and the lookahead override of the
protagonist's action (``make_lookahead_override``).

Data semantics as the reference's pipe protocol (ppo_run_self_play.py:
244-368): every game draws a random protagonist colour; both colours are
played by the same masked-sampling policy, but only the protagonist's
decisions become transitions, and the last protagonist transition of a
game carries the terminal outcome from the protagonist's side.  One rollout
slot:

  advance opponent plies -> emit the pending protagonist transition
  (crediting the terminal reward if the game ended) -> reset finished
  games (new colours and random-opening counts) -> advance opponent plies
  (black's reply in fresh white-protagonist games) -> the protagonist
  acts, becoming the new pending transition.

Random openings (othello.py:70-73): a game's first ``rand_left`` plies,
from either side, are uniform random legal moves.  As in JAX, the
protagonist's stored ``action`` and ``logp`` are the policy's (or the
override's) even when the executed ply was the random one.

JAX's ``lax.while_loop`` in ``advance_opponent`` is a host loop here with
one ``.any()`` read per iteration, bounded by ``MAX_ADVANCE_ITERS``.  The
game batch stays in bitboard words (``core.bitboard.BitState``); on the
card every ply (``BitEngine.step_where``), the reset of finished games
(``BitEngine.reset_where``) and each lookahead expansion
(``policies.scripted.expand_legal``) are one launch each of the ply kernel
(``ops/step.py``).

Randomness: one explicit ``torch.Generator`` (``Draws``) gives the colours,
the random-opening counts, one inverse-CDF uniform per row per sampled ply
and one legal-move index per row per ply with random openings;
``InjectedDraws`` replays given ones (parity tests).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from gymothelloenv_tpu_torch.agents.ppo import Transition
from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core.engine import BitEngine
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.envs.bit_vector_env import draw_rand_left
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.policies.scripted import expand_legal

# Opponent plies in a row before the collector gives up: no legal game has
# more than 60 plies, so more means a fault, not a long pass sequence.
MAX_ADVANCE_ITERS = 64
# The value of an action that is not searched (JAX's NEG).
NEG = -1e9
# Boards one forward of a search's node evaluation takes at most: the
# forward's activations (~16 KB a board for the wide2 net), not the tree's
# states, are a deep search's memory.
LEAF_SLICE = 65536

_ENGINE = BitEngine()


@dataclasses.dataclass
class Pending:
    obs: torch.Tensor     # int8 (N, 4, 8, 8) {0,1} planes
    action: torch.Tensor  # int64 (N,)
    logp: torch.Tensor    # float32 (N,)
    value: torch.Tensor   # float32 (N,)
    legal: torch.Tensor   # bool (N, 64)


@dataclasses.dataclass
class SelfPlayState:
    env: bb.BitState      # (N,) games, NOT auto-reset
    rand_left: torch.Tensor  # int64 (N,) random-opening plies left
    pcolor: torch.Tensor  # int8 (N,) protagonist colour per game
    pending: Pending
    host_syncs: int = 0   # .any() reads of advance_opponent so far


class Draws:
    """The collector's random numbers from ``generator`` (on the device
    the games are on)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def colors(self, n: int, device) -> torch.Tensor:
        """int8 (n,) protagonist colours, +-1 with p = 1/2
        (ppo_run_self_play.py:265-266)."""
        bit = torch.randint(0, 2, (n,), generator=self.generator,
                            device=device)
        return (bit * 2 - 1).to(torch.int8)

    def uniforms(self, n: int, device) -> torch.Tensor:
        """float32 (n,) in (0, 1] for ``MaskedCategorical.sample``."""
        return 1.0 - torch.rand(n, generator=self.generator, device=device)

    def rand_left(self, n: int, init_rand_steps: int,
                  device) -> torch.Tensor:
        """int64 (n,) random-opening plies, ``2 * U{0..init//2}``
        (othello.py:153-154)."""
        return draw_rand_left(n, init_rand_steps, self.generator, device)

    def legal_index(self, counts: torch.Tensor) -> torch.Tensor:
        """int64 index of the random legal move among each row's
        ``counts`` legal moves, uniform in ``[0, max(count, 1))``."""
        return bb.uniform_index(counts, self.generator)


class InjectedDraws:
    """Given draws, consumed in call order: ``colors`` int8 (N,) tensors
    (the first for ``selfplay_init``, then one per slot's reset),
    ``uniforms`` float32 (N,) tensors in (0, 1], one per sampled ply,
    ``rand_left`` (N,) counts (the first for ``selfplay_init``, then one
    per slot's reset) and ``legal_index`` (N,) move indices, one per ply
    with random openings."""

    def __init__(self, colors: Iterable[torch.Tensor],
                 uniforms: Iterable[torch.Tensor],
                 rand_left: Iterable[torch.Tensor] = (),
                 legal_index: Iterable[torch.Tensor] = ()):
        self._colors = iter(colors)
        self._uniforms = iter(uniforms)
        self._rand_left = iter(rand_left)
        self._legal_index = iter(legal_index)

    def colors(self, n: int, device) -> torch.Tensor:
        return next(self._colors).to(device=device, dtype=torch.int8)

    def uniforms(self, n: int, device) -> torch.Tensor:
        return next(self._uniforms).to(device=device, dtype=torch.float32)

    def rand_left(self, n: int, init_rand_steps: int,
                  device) -> torch.Tensor:
        return next(self._rand_left).to(device=device, dtype=torch.int64)

    def legal_index(self, counts: torch.Tensor) -> torch.Tensor:
        return next(self._legal_index).to(device=counts.device,
                                          dtype=torch.int64)


def node_values(net: torch.nn.Module, nodes: bb.BitState,
                reward: torch.Tensor,
                root_turn: torch.Tensor) -> torch.Tensor:
    """Root-perspective values (float32 (M,)) of a flat batch of search
    nodes: a terminal node's ``reward`` (already from the root mover's
    side), else the value head, negated where the node's player to move
    is not the root's.  The net runs over ``LEAF_SLICE`` boards at a
    time."""
    m = nodes.turn.shape[0]
    values = [net(make_state(bb.index_state(nodes, slice(i, i + LEAF_SLICE)))
                  )[1] for i in range(0, m, LEAF_SLICE)]
    v = torch.cat(values) if values else reward.new_zeros(0)
    mover_v = torch.where(nodes.turn == root_turn, v, -v)
    return torch.where(nodes.terminated, reward, mover_v)


@torch.no_grad()
def lookahead_action_values(net: torch.nn.Module, env: bb.BitState,
                            cfg: EnvConfig) -> torch.Tensor:
    """float32 (N, 64) root-mover-perspective child values of the legal
    actions (JAX self_play.py:85-143): each legal move stepped with the
    rules of ``cfg`` (one ply-kernel launch for all), a terminal child
    scored by its true reward, any other by the value head (negated when
    the turn passes).  Illegal actions hold ``NEG``."""
    parent, action, child, reward = expand_legal(env, env.legal, cfg)
    vals = node_values(net, child, reward, env.turn[parent])
    out = torch.full((env.turn.shape[0], 64), NEG, dtype=vals.dtype,
                     device=vals.device)
    out[parent, action] = vals
    return out


Override = Callable[[torch.nn.Module, bb.BitState, torch.Tensor, object],
                    torch.Tensor]


def make_lookahead_override(cfg: EnvConfig, tau: float = 0.0) -> Override:
    """Search-bootstrapped acting (JAX self_play.py:146-166): the
    protagonist's executed and stored action comes from the 1-ply value
    lookahead instead of the sampled logits.  ``tau`` > 0 samples
    ``softmax(values / tau)`` over the legal actions (one inverse-CDF
    uniform a row from ``draws``; values on the training disk-difference
    scale, +-64); ``tau`` = 0 plays the argmax, ties to the lowest index.

    Returns ``override(net, env, legal, draws) -> int64 actions``."""
    def override(net, env, legal, draws):
        vals = lookahead_action_values(net, env, cfg)
        masked = torch.where(legal, vals, torch.full_like(vals, NEG))
        if tau > 0:
            dist = MaskedCategorical(logits=masked / tau, mask=legal)
            return dist.sample(u=draws.uniforms(legal.shape[0],
                                                legal.device))
        return torch.argmax(masked, dim=-1)
    return override


def policy_sample(net: torch.nn.Module, env: bb.BitState, draws,
                  logp_mode: str = "masked",
                  act_override: Override | None = None):
    """Sample masked actions for every game; returns ``(obs, legal,
    action, logp, value)``.  ``logp_mode``: ``"masked"`` records the
    legal-subset log-prob (vendored ``Policy.act``, model.py:60-90),
    ``"full"`` the full softmax's (the simple PPO, ppo.py:309-310).
    ``act_override`` picks the action instead of sampling; the recorded
    log-prob is then the policy's of that action (the PPO ratio starts
    at 1)."""
    if logp_mode not in ("masked", "full"):
        raise ValueError(f"logp_mode must be 'masked' or 'full', got "
                         f"{logp_mode!r}")
    obs = _ENGINE.featurize(env)
    legal = _ENGINE.legal_flat(env)
    logits, value = net(obs)
    dist = MaskedCategorical(logits=logits, mask=legal)
    if act_override is not None:
        action = act_override(net, env, legal, draws)
    else:
        action = dist.sample(u=draws.uniforms(obs.shape[0], obs.device))
    if logp_mode == "full":
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, action[:, None])[:, 0]
    else:
        logp = dist.log_prob(action)
    return obs, legal, action, logp, value


def masked_step(env: bb.BitState, rand_left: torch.Tensor,
                actions: torch.Tensor, do: torch.Tensor, cfg: EnvConfig,
                draws, rand_openings: bool = True):
    """Step games where ``do``; elsewhere unchanged.  A stepping game with
    ``rand_left > 0`` plays a uniform random legal move instead and counts
    it down (othello.py:70-73).  ``rand_openings=False`` skips the random
    draw: the caller guarantees ``rand_left`` is all zeros.  Returns
    ``(env, rand_left)``."""
    if rand_openings:
        use_rand = (rand_left > 0) & do
        t = draws.legal_index(bb.popcount(env.legal))
        actions = torch.where(use_rand, bb.random_legal_bit(env.legal, t),
                              actions)
        rand_left = torch.where(use_rand, rand_left - 1, rand_left)
    return _ENGINE.step_where(env, actions, do, cfg), rand_left


def advance_opponent(net: torch.nn.Module, env: bb.BitState,
                     rand_left: torch.Tensor, pcolor: torch.Tensor,
                     cfg: EnvConfig, draws, rand_openings: bool = True):
    """Step opponent-to-move games until every game has ended or is at the
    protagonist's decision (ppo_run_self_play.py:288-300, :326-343).
    Returns ``(env, rand_left, host_syncs)``; raises after
    ``MAX_ADVANCE_ITERS`` plies."""
    for i in range(MAX_ADVANCE_ITERS + 1):
        needs = ~env.terminated & (env.turn != pcolor)
        if not bool(needs.any()):
            return env, rand_left, i + 1
        if i == MAX_ADVANCE_ITERS:
            break
        _, _, action, _, _ = policy_sample(net, env, draws)
        env, rand_left = masked_step(env, rand_left, action, needs, cfg,
                                     draws, rand_openings)
    raise RuntimeError(f"opponent still to move after {MAX_ADVANCE_ITERS} "
                       "plies in a row: the game state is corrupt")


def reset_done(env: bb.BitState, rand_left: torch.Tensor,
               pcolor: torch.Tensor, done: torch.Tensor, draws,
               init_rand_steps: int):
    """Reset finished games to the opening with fresh colours and, with
    random openings, fresh random-opening counts.  Returns ``(env,
    rand_left, pcolor)``."""
    env = _ENGINE.reset_where(env, done)
    n, device = done.shape[0], done.device
    if init_rand_steps > 0:
        rand_left = torch.where(
            done, draws.rand_left(n, init_rand_steps, device), rand_left)
    new_color = draws.colors(n, device)
    return env, rand_left, torch.where(done, new_color, pcolor)


def protagonist_act(net: torch.nn.Module, env: bb.BitState,
                    rand_left: torch.Tensor, cfg: EnvConfig, draws,
                    logp_mode: str = "masked", rand_openings: bool = True,
                    act_override: Override | None = None):
    """Sample (or override) the protagonist decision, step, return
    ``(env, rand_left, pending)``."""
    obs, legal, action, logp, value = policy_sample(
        net, env, draws, logp_mode, act_override)
    do = torch.ones_like(env.terminated)
    env, rand_left = masked_step(env, rand_left, action, do, cfg, draws,
                                 rand_openings)
    return env, rand_left, Pending(obs=obs.to(torch.int8), action=action,
                                   logp=logp, value=value, legal=legal)


@torch.no_grad()
def selfplay_init(net: torch.nn.Module, cfg: EnvConfig, num_envs: int,
                  draws, init_rand_steps: int = 0,
                  logp_mode: str = "masked", opp_net=None,
                  device=None,
                  act_override: Override | None = None) -> SelfPlayState:
    """Fresh games and the first protagonist decision (the initial
    pending transition), on ``device`` (default: the net's).
    ``opp_net`` plays the non-learning colour; ``None`` is mirror
    self-play (JAX self_play.py:294-335).  ``act_override`` replaces the
    protagonist's sampled action; opponent plies keep sampling."""
    if device is None:
        device = next(net.parameters()).device
    rand_openings = init_rand_steps > 0
    env = bb.bit_reset(num_envs, device)
    if rand_openings:
        rand_left = draws.rand_left(num_envs, init_rand_steps, device)
    else:
        rand_left = torch.zeros(num_envs, dtype=torch.int64, device=device)
    pcolor = draws.colors(num_envs, device)
    opp_net = net if opp_net is None else opp_net
    env, rand_left, syncs = advance_opponent(opp_net, env, rand_left, pcolor,
                                             cfg, draws, rand_openings)
    env, rand_left, pending = protagonist_act(
        net, env, rand_left, cfg, draws, logp_mode, rand_openings,
        act_override)
    return SelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                         pending=pending, host_syncs=syncs)


@torch.no_grad()
def collect_rollout(net: torch.nn.Module, sp: SelfPlayState, cfg: EnvConfig,
                    num_steps: int, draws, init_rand_steps: int = 0,
                    logp_mode: str = "masked", opp_net=None,
                    act_override: Override | None = None):
    """``num_steps`` slots; returns ``(new_state, Transition (T, N, ...),
    bootstrap_value (N,))``.  The bootstrap value is the behaviour value of
    the state after the last emitted transition, the new pending's.
    ``opp_net`` plays the non-learning colour (``None``: ``net``);
    ``act_override`` picks the protagonist's actions."""
    opp_net = net if opp_net is None else opp_net
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    rand_openings = init_rand_steps > 0
    syncs = sp.host_syncs
    env, rand_left, pcolor, pending = (sp.env, sp.rand_left, sp.pcolor,
                                       sp.pending)
    slots = []
    for _ in range(num_steps):
        env, rand_left, n_sync = advance_opponent(
            opp_net, env, rand_left, pcolor, cfg, draws, rand_openings)
        syncs += n_sync
        done = env.terminated
        outcome = _ENGINE.outcome_for(env, pcolor, cfg)
        reward = torch.where(done, outcome, torch.zeros_like(outcome))
        slots.append(Transition(obs=pending.obs, action=pending.action,
                                logp=pending.logp, value=pending.value,
                                reward=reward, done=done,
                                legal=pending.legal))
        env, rand_left, pcolor = reset_done(env, rand_left, pcolor, done,
                                            draws, init_rand_steps)
        env, rand_left, n_sync = advance_opponent(
            opp_net, env, rand_left, pcolor, cfg, draws, rand_openings)
        syncs += n_sync
        env, rand_left, pending = protagonist_act(
            net, env, rand_left, cfg, draws, logp_mode, rand_openings,
            act_override)
    rollout = Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in slots])
        for f in dataclasses.fields(Transition)})
    new = SelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                        pending=pending, host_syncs=syncs)
    return new, rollout, pending.value
