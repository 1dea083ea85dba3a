"""PPO self-play collector — the port of ``train/self_play.py`` without
random openings, the training default: mirror self-play (one net plays
both colours), or a frozen ``opp_net`` on the non-learning colour (the
opponent pool, JAX's ``opp_params``).

Data semantics as the reference's pipe protocol (ppo_run_self_play.py:
244-368): every game draws a random protagonist colour; both colours are
played by the same masked-sampling policy, but only the protagonist's
decisions become transitions, and the last protagonist transition of a
game carries the terminal outcome from the protagonist's side.  One rollout
slot:

  advance opponent plies -> emit the pending protagonist transition
  (crediting the terminal reward if the game ended) -> reset finished
  games (new colours) -> advance opponent plies (black's reply in fresh
  white-protagonist games) -> the protagonist acts, becoming the new
  pending transition.

JAX's ``lax.while_loop`` in ``advance_opponent`` is a host loop here with
one ``.any()`` read per iteration, bounded by ``MAX_ADVANCE_ITERS``.  The
game batch stays in bitboard words (``core.bitboard.BitState``); on the
card every ply (``BitEngine.step_where``) and the reset of finished games
(``BitEngine.reset_where``) are one launch each of the ply kernel
(``ops/step.py``).

Randomness: one explicit ``torch.Generator`` (``Draws``) gives the colours
and one inverse-CDF uniform per row per ply; ``InjectedDraws`` replays
given ones (parity tests).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from gymothelloenv_tpu_torch.agents.ppo import Transition
from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core.engine import BitEngine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical

# Opponent plies in a row before the collector gives up: no legal game has
# more than 60 plies, so more means a fault, not a long pass sequence.
MAX_ADVANCE_ITERS = 64

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


class InjectedDraws:
    """Given draws, consumed in call order: ``colors`` int8 (N,) tensors
    (the first for ``selfplay_init``, then one per slot's reset), and
    ``uniforms`` float32 (N,) tensors in (0, 1], one per sampled ply."""

    def __init__(self, colors: Iterable[torch.Tensor],
                 uniforms: Iterable[torch.Tensor]):
        self._colors = iter(colors)
        self._uniforms = iter(uniforms)

    def colors(self, n: int, device) -> torch.Tensor:
        return next(self._colors).to(device=device, dtype=torch.int8)

    def uniforms(self, n: int, device) -> torch.Tensor:
        return next(self._uniforms).to(device=device, dtype=torch.float32)


def _unported(init_rand_steps: int, logp_mode: str) -> None:
    if init_rand_steps != 0:
        raise NotImplementedError("random openings in self-play collection "
                                  "(init_rand_steps > 0) are not ported yet")
    if logp_mode != "masked":
        raise NotImplementedError(f"logp_mode={logp_mode!r} is not ported "
                                  "yet (only 'masked')")


def policy_sample(net: torch.nn.Module, env: bb.BitState, draws):
    """Sample masked actions for every game; returns ``(obs, legal,
    action, logp, value)`` with the masked behaviour log-prob (vendored
    ``Policy.act``, model.py:60-90)."""
    obs = _ENGINE.featurize(env)
    legal = _ENGINE.legal_flat(env)
    logits, value = net(obs)
    dist = MaskedCategorical(logits=logits, mask=legal)
    action = dist.sample(u=draws.uniforms(obs.shape[0], obs.device))
    return obs, legal, action, dist.log_prob(action), value


def masked_step(env: bb.BitState, actions: torch.Tensor, do: torch.Tensor,
                cfg: EnvConfig) -> bb.BitState:
    """Step games where ``do``; elsewhere unchanged."""
    return _ENGINE.step_where(env, actions, do, cfg)


def advance_opponent(net: torch.nn.Module, env: bb.BitState,
                     pcolor: torch.Tensor, cfg: EnvConfig, draws):
    """Step opponent-to-move games until every game has ended or is at the
    protagonist's decision (ppo_run_self_play.py:288-300, :326-343).
    Returns ``(env, host_syncs)``; raises after ``MAX_ADVANCE_ITERS``
    plies."""
    for i in range(MAX_ADVANCE_ITERS + 1):
        needs = ~env.terminated & (env.turn != pcolor)
        if not bool(needs.any()):
            return env, i + 1
        if i == MAX_ADVANCE_ITERS:
            break
        _, _, action, _, _ = policy_sample(net, env, draws)
        env = masked_step(env, action, needs, cfg)
    raise RuntimeError(f"opponent still to move after {MAX_ADVANCE_ITERS} "
                       "plies in a row: the game state is corrupt")


def reset_done(env: bb.BitState, pcolor: torch.Tensor, done: torch.Tensor,
               draws):
    """Reset finished games to the opening with fresh colours."""
    env = _ENGINE.reset_where(env, done)
    new_color = draws.colors(done.shape[0], done.device)
    return env, torch.where(done, new_color, pcolor)


def protagonist_act(net: torch.nn.Module, env: bb.BitState, cfg: EnvConfig,
                    draws):
    """Sample the protagonist decision, step, return ``(env, pending)``."""
    obs, legal, action, logp, value = policy_sample(net, env, draws)
    do = torch.ones_like(env.terminated)
    env = masked_step(env, action, do, cfg)
    return env, Pending(obs=obs.to(torch.int8), action=action, logp=logp,
                        value=value, legal=legal)


@torch.no_grad()
def selfplay_init(net: torch.nn.Module, cfg: EnvConfig, num_envs: int,
                  draws, init_rand_steps: int = 0,
                  logp_mode: str = "masked", opp_net=None,
                  device=None) -> SelfPlayState:
    """Fresh games and the first protagonist decision (the initial
    pending transition), on ``device`` (default: the net's).
    ``opp_net`` plays the non-learning colour; ``None`` is mirror
    self-play (JAX self_play.py:294-305)."""
    _unported(init_rand_steps, logp_mode)
    if device is None:
        device = next(net.parameters()).device
    env = bb.bit_reset(num_envs, device)
    pcolor = draws.colors(num_envs, device)
    opp_net = net if opp_net is None else opp_net
    env, syncs = advance_opponent(opp_net, env, pcolor, cfg, draws)
    env, pending = protagonist_act(net, env, cfg, draws)
    return SelfPlayState(env=env, pcolor=pcolor, pending=pending,
                         host_syncs=syncs)


@torch.no_grad()
def collect_rollout(net: torch.nn.Module, sp: SelfPlayState, cfg: EnvConfig,
                    num_steps: int, draws, init_rand_steps: int = 0,
                    logp_mode: str = "masked", opp_net=None):
    """``num_steps`` slots; returns ``(new_state, Transition (T, N, ...),
    bootstrap_value (N,))``.  The bootstrap value is the behaviour value of
    the state after the last emitted transition, the new pending's.
    ``opp_net`` plays the non-learning colour (``None``: ``net``)."""
    _unported(init_rand_steps, logp_mode)
    opp_net = net if opp_net is None else opp_net
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    syncs = sp.host_syncs
    env, pcolor, pending = sp.env, sp.pcolor, sp.pending
    slots = []
    for _ in range(num_steps):
        env, n_sync = advance_opponent(opp_net, env, pcolor, cfg, draws)
        syncs += n_sync
        done = env.terminated
        outcome = _ENGINE.outcome_for(env, pcolor, cfg)
        reward = torch.where(done, outcome, torch.zeros_like(outcome))
        slots.append(Transition(obs=pending.obs, action=pending.action,
                                logp=pending.logp, value=pending.value,
                                reward=reward, done=done,
                                legal=pending.legal))
        env, pcolor = reset_done(env, pcolor, done, draws)
        env, n_sync = advance_opponent(opp_net, env, pcolor, cfg, draws)
        syncs += n_sync
        env, pending = protagonist_act(net, env, cfg, draws)
    rollout = Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in slots])
        for f in dataclasses.fields(Transition)})
    new = SelfPlayState(env=env, pcolor=pcolor, pending=pending,
                        host_syncs=syncs)
    return new, rollout, pending.value
