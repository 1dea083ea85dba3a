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
collectors read their engine from ``core.engine.get_engine(cfg,
force_plane)`` as JAX's do, and the phase helpers take it from the
state's layout (``engine_of``).  On 8x8 the game batch stays in bitboard
words (``core.bitboard.BitState``): on the card every ply
(``BitEngine.step_where``), the reset of finished games
(``BitEngine.reset_where``) and each lookahead expansion
(``policies.scripted.expand_legal``) are one launch each of the ply kernel
(``ops/step.py``).  Other board sizes, and 8x8 with ``force_plane``, keep
plane games (``core.state.OthelloState``) and step them with the plane
rules; the lookahead override expands either (``expand_legal``).

Also ported: the time-limited collector (``collect_rollout_time_limited``,
gym's TimeLimit with the fork's TimeLimitMask) and the recurrent one
(``collect_rollout_recurrent``), which threads each colour's hidden state
through its decisions for a stateful policy ``net(obs, h, mask) ->
(logits, value, h')`` (the GRU ``PolicyNet`` or
``models.nets.FrameStackCell``).

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
from gymothelloenv_tpu_torch.core.engine import engine_of, get_engine
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig, index_games
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


@dataclasses.dataclass
class Pending:
    obs: torch.Tensor     # int8 (N, 4, B, B) {0,1} planes
    action: torch.Tensor  # int64 (N,)
    logp: torch.Tensor    # float32 (N,)
    value: torch.Tensor   # float32 (N,)
    legal: torch.Tensor   # bool (N, B*B)


@dataclasses.dataclass
class SelfPlayState:
    env: object           # (N,) games, NOT auto-reset: a BitState on the
    #                       bit engine, an OthelloState on planes
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

    def replay_uniforms(self, n: int, device) -> torch.Tensor:
        """float32 (n,) in [0, 1), one a sampled replay row
        (``agents.replay.replay_sample_idx``)."""
        return torch.rand(n, generator=self.generator, device=device)

    def normals(self, n: int, device) -> torch.Tensor:
        """float32 (n,) standard normals: one noisy forward's factorized
        noise (``agents.rainbow``), ACKTR's critic noise."""
        return torch.randn(n, generator=self.generator, device=device)

    def row_indices(self, n: int, high: int, device) -> torch.Tensor:
        """int64 (n,) uniform in ``[0, high)``, with replacement: GAIL's
        policy rows for a discriminator step."""
        return torch.randint(0, high, (n,), generator=self.generator,
                             device=device)

    def mix_uniforms(self, n: int, device) -> torch.Tensor:
        """float32 (n,) in [0, 1): GAIL's mixup weights of a gradient
        penalty."""
        return torch.rand(n, generator=self.generator, device=device)


class InjectedDraws:
    """Given draws, consumed in call order: ``colors`` int8 (N,) tensors
    (the first for ``selfplay_init``, then one per slot's reset),
    ``uniforms`` float32 (N,) tensors in (0, 1], one per sampled ply,
    ``rand_left`` (N,) counts (the first for ``selfplay_init``, then one
    per slot's reset), ``legal_index`` (N,) move indices, one per ply
    with random openings, ``replay_uniforms``, one tensor a replay
    sample, ``normals``, one tensor a ``Draws.normals`` call, and
    ``row_indices``/``mix_uniforms``, one tensor a call of each."""

    def __init__(self, colors: Iterable[torch.Tensor],
                 uniforms: Iterable[torch.Tensor],
                 rand_left: Iterable[torch.Tensor] = (),
                 legal_index: Iterable[torch.Tensor] = (),
                 replay_uniforms: Iterable[torch.Tensor] = (),
                 normals: Iterable[torch.Tensor] = (),
                 row_indices: Iterable[torch.Tensor] = (),
                 mix_uniforms: Iterable[torch.Tensor] = ()):
        self._colors = iter(colors)
        self._uniforms = iter(uniforms)
        self._rand_left = iter(rand_left)
        self._legal_index = iter(legal_index)
        self._replay_uniforms = iter(replay_uniforms)
        self._normals = iter(normals)
        self._row_indices = iter(row_indices)
        self._mix_uniforms = iter(mix_uniforms)

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

    def replay_uniforms(self, n: int, device) -> torch.Tensor:
        return next(self._replay_uniforms).to(device=device,
                                              dtype=torch.float32)

    def normals(self, n: int, device) -> torch.Tensor:
        out = next(self._normals).to(device=device, dtype=torch.float32)
        if out.shape != (n,):
            raise ValueError(f"injected normals {tuple(out.shape)} for a "
                             f"draw of {n}")
        return out

    def row_indices(self, n: int, high: int, device) -> torch.Tensor:
        return next(self._row_indices).to(device=device, dtype=torch.int64)

    def mix_uniforms(self, n: int, device) -> torch.Tensor:
        return next(self._mix_uniforms).to(device=device,
                                           dtype=torch.float32)


def node_values(net: torch.nn.Module, nodes, reward: torch.Tensor,
                root_turn: torch.Tensor) -> torch.Tensor:
    """Root-perspective values (float32 (M,)) of a flat batch of search
    nodes (a ``BitState`` or a plane ``OthelloState``): a terminal node's
    ``reward`` (already from the root mover's side), else the value head,
    negated where the node's player to move is not the root's.  The net
    runs over ``LEAF_SLICE`` boards at a time."""
    m = nodes.turn.shape[0]
    values = [net(make_state(index_games(nodes, slice(i, i + LEAF_SLICE)))
                  )[1] for i in range(0, m, LEAF_SLICE)]
    v = torch.cat(values) if values else reward.new_zeros(0)
    mover_v = torch.where(nodes.turn == root_turn, v, -v)
    return torch.where(nodes.terminated, reward, mover_v)


@torch.no_grad()
def lookahead_action_values(net: torch.nn.Module, env,
                            cfg: EnvConfig) -> torch.Tensor:
    """float32 (N, B*B) root-mover-perspective child values of the legal
    actions (JAX self_play.py:85-143) of bit or plane games: each legal
    move stepped with the rules of ``cfg`` (``expand_legal``: on 8x8 one
    ply-kernel launch for all), a terminal child scored by its true
    reward, any other by the value head (negated when the turn passes).
    Illegal actions hold ``NEG``."""
    parent, action, child, reward = expand_legal(env, env.legal, cfg)
    vals = node_values(net, child, reward, env.turn[parent])
    out = torch.full((env.turn.shape[0], cfg.num_actions), NEG,
                     dtype=vals.dtype, device=vals.device)
    out[parent, action] = vals
    return out


Override = Callable[[torch.nn.Module, object, torch.Tensor, object],
                    torch.Tensor]


def make_lookahead_override(cfg: EnvConfig, tau: float = 0.0) -> Override:
    """Search-bootstrapped acting (JAX self_play.py:146-166): the
    protagonist's executed and stored action comes from the 1-ply value
    lookahead instead of the sampled logits.  ``tau`` > 0 samples
    ``softmax(values / tau)`` over the legal actions (one inverse-CDF
    uniform a row from ``draws``; values on the training disk-difference
    scale, +-64); ``tau`` = 0 plays the argmax, ties to the lowest index.
    Any board size: bit games on 8x8, plane games otherwise.

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


def policy_sample(net: torch.nn.Module, env, draws,
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
    eng = engine_of(env)
    obs = eng.featurize(env)
    legal = eng.legal_flat(env)
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


def masked_step(env, rand_left: torch.Tensor,
                actions: torch.Tensor, do: torch.Tensor, cfg: EnvConfig,
                draws, rand_openings: bool = True):
    """Step games where ``do``; elsewhere unchanged.  A stepping game with
    ``rand_left > 0`` plays a uniform random legal move instead and counts
    it down (othello.py:70-73).  ``rand_openings=False`` skips the random
    draw: the caller guarantees ``rand_left`` is all zeros.  Returns
    ``(env, rand_left)``."""
    eng = engine_of(env)
    if rand_openings:
        use_rand = (rand_left > 0) & do
        t = draws.legal_index(eng.legal_count(env))
        actions = torch.where(use_rand, eng.random_legal(env, t), actions)
        rand_left = torch.where(use_rand, rand_left - 1, rand_left)
    return eng.step_where(env, actions, do, cfg), rand_left


def advance_opponent(net: torch.nn.Module, env,
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


def reset_done(env, rand_left: torch.Tensor, pcolor: torch.Tensor,
               done: torch.Tensor, cfg: EnvConfig, draws,
               init_rand_steps: int):
    """Reset finished games to the opening with fresh colours and, with
    random openings, fresh random-opening counts.  Returns ``(env,
    rand_left, pcolor)``."""
    env = engine_of(env).reset_where(env, done, cfg)
    n, device = done.shape[0], done.device
    if init_rand_steps > 0:
        rand_left = torch.where(
            done, draws.rand_left(n, init_rand_steps, device), rand_left)
    new_color = draws.colors(n, device)
    return env, rand_left, torch.where(done, new_color, pcolor)


def protagonist_act(net: torch.nn.Module, env,
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


def collector_engine(cfg: EnvConfig, force_plane: bool, env=None):
    """``get_engine(cfg, force_plane)``; with ``env``, a state built on
    the other engine raises (``force_plane`` must match the
    ``selfplay_init`` that built it)."""
    eng = get_engine(cfg, force_plane)
    if env is not None and engine_of(env) is not eng:
        raise ValueError(
            f"the collector state is a {type(env).__name__}, but "
            f"board_size={cfg.board_size}, force_plane={force_plane} "
            f"selects the {type(eng).__name__}: pass the force_plane of "
            "the selfplay_init that built it")
    return eng


@torch.no_grad()
def selfplay_init(net: torch.nn.Module, cfg: EnvConfig, num_envs: int,
                  draws, init_rand_steps: int = 0,
                  logp_mode: str = "masked", opp_net=None,
                  device=None,
                  act_override: Override | None = None,
                  force_plane: bool = False) -> SelfPlayState:
    """Fresh games and the first protagonist decision (the initial
    pending transition), on ``device`` (default: the net's), on the
    engine of ``get_engine(cfg, force_plane)``.  ``opp_net`` plays the
    non-learning colour; ``None`` is mirror self-play (JAX
    self_play.py:294-335).  ``act_override`` replaces the protagonist's
    sampled action; opponent plies keep sampling."""
    if device is None:
        device = next(net.parameters()).device
    rand_openings = init_rand_steps > 0
    env = collector_engine(cfg, force_plane).reset_batch(num_envs, cfg,
                                                          device)
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
                    act_override: Override | None = None,
                    force_plane: bool = False):
    """``num_steps`` slots; returns ``(new_state, Transition (T, N, ...),
    bootstrap_value (N,))``.  The bootstrap value is the behaviour value of
    the state after the last emitted transition, the new pending's.
    ``opp_net`` plays the non-learning colour (``None``: ``net``);
    ``act_override`` picks the protagonist's actions; ``force_plane`` must
    match the ``selfplay_init`` that built ``sp``."""
    eng = collector_engine(cfg, force_plane, sp.env)
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
        outcome = eng.outcome_for(env, pcolor, cfg)
        reward = torch.where(done, outcome, torch.zeros_like(outcome))
        slots.append(Transition(obs=pending.obs, action=pending.action,
                                logp=pending.logp, value=pending.value,
                                reward=reward, done=done,
                                legal=pending.legal))
        env, rand_left, pcolor = reset_done(env, rand_left, pcolor, done,
                                            cfg, draws, init_rand_steps)
        env, rand_left, n_sync = advance_opponent(
            opp_net, env, rand_left, pcolor, cfg, draws, rand_openings)
        syncs += n_sync
        env, rand_left, pending = protagonist_act(
            net, env, rand_left, cfg, draws, logp_mode, rand_openings,
            act_override)
    rollout = _stack(slots)
    new = SelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                        pending=pending, host_syncs=syncs)
    return new, rollout, pending.value


@torch.no_grad()
def collect_rollout_time_limited(net: torch.nn.Module, sp: SelfPlayState,
                                 elapsed: torch.Tensor, cfg: EnvConfig,
                                 num_steps: int, max_episode_plies: int,
                                 draws, init_rand_steps: int = 0,
                                 logp_mode: str = "masked", opp_net=None,
                                 force_plane: bool = False):
    """``collect_rollout`` with an episode step cap (JAX
    ``collect_rollout_time_limited``; TimeLimit + TimeLimitMask,
    envs.py:110-119): an episode whose protagonist has taken
    ``max_episode_plies`` decisions is truncated (done, reward 0) and
    flagged, also where the game ended on that step, so that
    ``compute_gae_time_limits`` zeroes its advantage.

    ``elapsed`` int32 (N,) counts the episode's emitted protagonist
    decisions including the pending one (ones after ``selfplay_init``).
    Returns ``(state, elapsed, rollout, bad_transition (T, N) bool,
    bootstrap_value)``."""
    eng = collector_engine(cfg, force_plane, sp.env)
    opp_net = net if opp_net is None else opp_net
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    rand_openings = init_rand_steps > 0
    syncs = sp.host_syncs
    env, rand_left, pcolor, pending = (sp.env, sp.rand_left, sp.pcolor,
                                       sp.pending)
    slots, bad = [], []
    for _ in range(num_steps):
        env, rand_left, n_sync = advance_opponent(
            opp_net, env, rand_left, pcolor, cfg, draws, rand_openings)
        syncs += n_sync
        truncated = elapsed >= max_episode_plies
        done = env.terminated | truncated
        outcome = eng.outcome_for(env, pcolor, cfg)
        reward = torch.where(env.terminated, outcome,
                             torch.zeros_like(outcome))
        slots.append(Transition(obs=pending.obs, action=pending.action,
                                logp=pending.logp, value=pending.value,
                                reward=reward, done=done,
                                legal=pending.legal))
        bad.append(truncated)
        env, rand_left, pcolor = reset_done(env, rand_left, pcolor, done,
                                            cfg, draws, init_rand_steps)
        elapsed = torch.where(done, torch.zeros_like(elapsed), elapsed)
        env, rand_left, n_sync = advance_opponent(
            opp_net, env, rand_left, pcolor, cfg, draws, rand_openings)
        syncs += n_sync
        env, rand_left, pending = protagonist_act(
            net, env, rand_left, cfg, draws, logp_mode, rand_openings)
        elapsed = elapsed + 1
    rollout = _stack(slots)
    new = SelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                        pending=pending, host_syncs=syncs)
    return new, elapsed, rollout, torch.stack(bad), pending.value


def _stack(slots) -> Transition:
    return Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in slots])
        for f in dataclasses.fields(Transition)})


# ---------------------------------------------------------------------------
# Recurrent (GRU or frame-stack) self-play collection (JAX
# self_play.py:441-625).  Each colour's decision stream is a sequence of
# the stateful policy.  ``pending.h`` is the hidden state the pending
# decision CONSUMED, so a rollout's ``h0`` is the first pending's and
# ``masks[t] = 1 - done[t-1]`` replays the live resets (games reset in the
# slot their terminal transition is emitted, both streams zeroed there).
# The opponent stream advances only on plies the opponent takes.  As in
# JAX, every ply here draws its random-opening move (the override applies
# only while ``rand_left > 0``).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecPending(Pending):
    h: torch.Tensor = None   # float32 (N, H) hidden input of this decision


@dataclasses.dataclass
class RecSelfPlayState:
    env: object              # BitState or OthelloState, as SelfPlayState
    rand_left: torch.Tensor
    pcolor: torch.Tensor
    pending: RecPending
    h_prot: torch.Tensor     # (N, H) protagonist hidden after the pending
    h_opp: torch.Tensor      # (N, H) opponent-stream hidden
    host_syncs: int = 0


def policy_sample_rec(net: torch.nn.Module, env, draws, h: torch.Tensor):
    """Recurrent ``policy_sample``: ``(obs, legal, action, logp, value,
    h')``.  Resets zero ``h`` at game boundaries, so the mask is all
    ones."""
    eng = engine_of(env)
    obs = eng.featurize(env)
    legal = eng.legal_flat(env)
    logits, value, h_new = net(obs, h, torch.ones(h.shape[0],
                                                  device=h.device))
    dist = MaskedCategorical(logits=logits, mask=legal)
    action = dist.sample(u=draws.uniforms(obs.shape[0], obs.device))
    return obs, legal, action, dist.log_prob(action), value, h_new


def advance_opponent_rec(net: torch.nn.Module, env,
                         rand_left: torch.Tensor, pcolor: torch.Tensor,
                         h_opp: torch.Tensor, cfg: EnvConfig, draws):
    """Recurrent ``advance_opponent``: the opponent's hidden stream
    advances only where its game took a ply.  Returns ``(env, rand_left,
    h_opp, host_syncs)``."""
    for i in range(MAX_ADVANCE_ITERS + 1):
        needs = ~env.terminated & (env.turn != pcolor)
        if not bool(needs.any()):
            return env, rand_left, h_opp, i + 1
        if i == MAX_ADVANCE_ITERS:
            break
        _, _, action, _, _, h_new = policy_sample_rec(net, env, draws,
                                                      h_opp)
        h_opp = torch.where(needs[:, None], h_new, h_opp)
        env, rand_left = masked_step(env, rand_left, action, needs, cfg,
                                     draws)
    raise RuntimeError(f"opponent still to move after {MAX_ADVANCE_ITERS} "
                       "plies in a row: the game state is corrupt")


def _rec_protagonist_act(net: torch.nn.Module, env,
                         rand_left: torch.Tensor, h_prot: torch.Tensor,
                         cfg: EnvConfig, draws):
    """The protagonist decides from ``h_prot`` and steps; returns ``(env,
    rand_left, pending, h')``."""
    obs, legal, action, logp, value, h_new = policy_sample_rec(
        net, env, draws, h_prot)
    env, rand_left = masked_step(env, rand_left, action,
                                 torch.ones_like(env.terminated), cfg, draws)
    pending = RecPending(obs=obs.to(torch.int8), action=action, logp=logp,
                         value=value, legal=legal, h=h_prot)
    return env, rand_left, pending, h_new


@torch.no_grad()
def selfplay_init_recurrent(net: torch.nn.Module, cfg: EnvConfig,
                            num_envs: int, hidden_size: int, draws,
                            init_rand_steps: int = 0, opp_net=None,
                            device=None,
                            force_plane: bool = False) -> RecSelfPlayState:
    """Fresh games and the first protagonist decision from zero hidden
    states, on ``device`` (default: the net's), on the engine of
    ``get_engine(cfg, force_plane)``."""
    if device is None:
        device = next(net.parameters()).device
    opp_net = net if opp_net is None else opp_net
    env = collector_engine(cfg, force_plane).reset_batch(num_envs, cfg,
                                                          device)
    rand_left = draws.rand_left(num_envs, init_rand_steps, device)
    pcolor = draws.colors(num_envs, device)
    h_prot = torch.zeros(num_envs, hidden_size, device=device)
    h_opp = torch.zeros(num_envs, hidden_size, device=device)
    env, rand_left, h_opp, syncs = advance_opponent_rec(
        opp_net, env, rand_left, pcolor, h_opp, cfg, draws)
    env, rand_left, pending, h_prot = _rec_protagonist_act(
        net, env, rand_left, h_prot, cfg, draws)
    return RecSelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                            pending=pending, h_prot=h_prot, h_opp=h_opp,
                            host_syncs=syncs)


@torch.no_grad()
def collect_rollout_recurrent(net: torch.nn.Module, sp: RecSelfPlayState,
                              cfg: EnvConfig, num_steps: int, draws,
                              init_rand_steps: int = 0, opp_net=None,
                              force_plane: bool = False):
    """``num_steps`` slots with the hidden states threaded; returns
    ``(state, rollout (T, N, ...), h0 (N, H), masks (T, N), bootstrap
    (N,))``, the inputs ``agents.ppo.ppo_update_recurrent`` replays.
    ``force_plane`` must match the ``selfplay_init_recurrent`` that built
    ``sp``."""
    eng = collector_engine(cfg, force_plane, sp.env)
    opp_net = net if opp_net is None else opp_net
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    syncs = sp.host_syncs
    env, rand_left, pcolor, pending = (sp.env, sp.rand_left, sp.pcolor,
                                       sp.pending)
    h_prot, h_opp, h0 = sp.h_prot, sp.h_opp, sp.pending.h
    slots = []
    for _ in range(num_steps):
        env, rand_left, h_opp, n_sync = advance_opponent_rec(
            opp_net, env, rand_left, pcolor, h_opp, cfg, draws)
        syncs += n_sync
        done = env.terminated
        outcome = eng.outcome_for(env, pcolor, cfg)
        reward = torch.where(done, outcome, torch.zeros_like(outcome))
        slots.append(Transition(obs=pending.obs, action=pending.action,
                                logp=pending.logp, value=pending.value,
                                reward=reward, done=done,
                                legal=pending.legal))
        env, rand_left, pcolor = reset_done(env, rand_left, pcolor, done,
                                            cfg, draws, init_rand_steps)
        # Both hidden streams start again for fresh games.
        h_prot = torch.where(done[:, None], torch.zeros_like(h_prot), h_prot)
        h_opp = torch.where(done[:, None], torch.zeros_like(h_opp), h_opp)
        env, rand_left, h_opp, n_sync = advance_opponent_rec(
            opp_net, env, rand_left, pcolor, h_opp, cfg, draws)
        syncs += n_sync
        env, rand_left, pending, h_prot = _rec_protagonist_act(
            net, env, rand_left, h_prot, cfg, draws)
    rollout = _stack(slots)
    masks = torch.cat([torch.ones_like(rollout.done[:1], dtype=torch.float32),
                       1.0 - rollout.done[:-1].to(torch.float32)])
    new = RecSelfPlayState(env=env, rand_left=rand_left, pcolor=pcolor,
                           pending=pending, h_prot=h_prot, h_opp=h_opp,
                           host_syncs=syncs)
    return new, rollout, h0, masks, pending.value
