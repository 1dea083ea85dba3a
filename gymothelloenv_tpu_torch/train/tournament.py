"""Batched tournaments at any board size — the port of
``train/tournament.py`` (``play_games``/``tally``), of
``train/ppo_trainer.py::net_tournament_policy``, and of the two-colour
protocol of ``cli/eval_checkpoint.py``.

Games step in lockstep on ``core.engine.get_engine(cfg)``, one
``step_where`` a ply (on 8x8 one launch of the ply kernel, which also
floods the legal masks; on planes the eager plane rules), until all have
ended or ``max_plies`` plies ran.
Colours are fixed per call (black = first policy).  Random openings keep
``OthelloEnv``'s semantics (othello.py:151-199): each game draws
``2 * U{0..init_rand_steps//2}`` and its first that many plies, from
either side, are uniform random legal moves.
"""

from __future__ import annotations

from typing import Callable

import torch

from gymothelloenv_tpu_torch.core.engine import engine_of, get_engine
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.train.self_play import Draws
from gymothelloenv_tpu_torch.utils.device import (resolve_device,
                                                  use_float32)

# act(state, generator) -> int64 actions, on a BitState or OthelloState.
PolicyFn = Callable[[object, "torch.Generator | None"], torch.Tensor]


def draw_max_rand_steps(draws, n: int, init_rand_steps: int,
                        device) -> torch.Tensor:
    """int64 (n,) random-opening plies, ``2 * randint(0, init // 2 + 1)``
    a game (othello.py:153-154; JAX ``draw_max_rand_steps``), drawn
    through ``draws`` (``train.self_play.Draws``, or the tests'
    ``InjectedDraws``)."""
    return draws.rand_left(n, init_rand_steps, device)


def play_games(act_black: PolicyFn, act_white: PolicyFn, num_games: int,
               init_rand_steps: int = 0, max_plies: int = 0,
               generator: torch.Generator | None = None,
               cfg: EnvConfig = EnvConfig(), device=None,
               draws=None) -> torch.Tensor:
    """Play ``num_games`` games on ``cfg``'s board; returns winners int8
    (N,) (+1 white, -1 black, 0 draw or unfinished).  ``max_plies <= 0``
    means ``B * B``, enough for any legal game.  ``draws``
    (``train.self_play.Draws`` over ``generator`` by default; the parity
    tests inject ``InjectedDraws``) gives the random-opening counts and
    each ply's random legal move; the policies sample from
    ``generator``."""
    device = resolve_device(device)
    if max_plies <= 0:
        max_plies = cfg.num_actions
    if draws is None:
        draws = Draws(generator)
    eng = get_engine(cfg)
    state = eng.reset_batch(num_games, cfg, device)
    rand_left = draw_max_rand_steps(draws, num_games, init_rand_steps, device)
    ply = 0
    while ply < max_plies and not bool(state.terminated.all()):
        a_rand = eng.random_legal(
            state, draws.legal_index(eng.legal_count(state)))
        a_black = act_black(state, generator)
        a_white = act_white(state, generator)
        action = torch.where(rand_left > 0, a_rand,
                             torch.where(state.turn == -1, a_black, a_white))
        live = ~state.terminated
        state = eng.step_where(state, action, live, cfg)
        rand_left = torch.where(live, (rand_left - 1).clamp(min=0),
                                rand_left)
        ply += 1
    return state.winner


def tally(winners: torch.Tensor):
    """(black_wins, draws, white_wins) as ints."""
    return (int((winners == -1).sum()), int((winners == 0).sum()),
            int((winners == 1).sum()))


def net_tournament_policy(net: torch.nn.Module) -> PolicyFn:
    """Wrap a ``PolicyNet`` as a sampling tournament policy
    (``Policy.act`` served over pipes, ppo_run_self_play.py:383-389).
    Sets float32 numerics (``use_float32``)."""
    use_float32()

    def act(state, generator=None) -> torch.Tensor:
        with torch.inference_mode():
            logits, _ = net(make_state(state))
            dist = MaskedCategorical(
                logits=logits, mask=engine_of(state).legal_flat(state))
            return dist.sample(generator=generator)
    return act


def evaluate(act: PolicyFn, opponent: PolicyFn, num_games: int,
             init_rand_steps: int = 10,
             generator: torch.Generator | None = None,
             cfg: EnvConfig = EnvConfig(), device=None, draws=None):
    """``num_games // 2`` games with ``act`` as black, as many as white
    (the ``cli/eval_checkpoint.py`` protocol), ``draws`` as in
    ``play_games``.  Returns ``(wins, draws, losses)`` for ``act``."""
    n = num_games // 2
    as_black = play_games(act, opponent, n, init_rand_steps,
                          generator=generator, cfg=cfg, device=device,
                          draws=draws)
    as_white = play_games(opponent, act, n, init_rand_steps,
                          generator=generator, cfg=cfg, device=device,
                          draws=draws)
    wins = int((as_black == -1).sum()) + int((as_white == 1).sum())
    draws = int((as_black == 0).sum()) + int((as_white == 0).sum())
    return wins, draws, 2 * n - wins - draws
