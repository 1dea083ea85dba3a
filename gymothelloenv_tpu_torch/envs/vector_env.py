"""Batched auto-resetting Othello env on plane games at any board size —
the port of ``envs/vector_env.py`` (random openings as in
SimpleOthelloEnv, othello.py:60-79): at reset each game draws
``2 * U{0..initial_rand_steps//2}`` forced-random plies, and while that
count lasts a uniform random legal move replaces the caller's action.

Random draws are explicit inputs or come from a ``torch.Generator``, as in
``envs/bit_vector_env.py``: ``rand_t`` is the index of the forced-random
move among each game's legal moves (``PlaneEngine.random_legal``),
``reset_rand_left`` the fresh count of games that reset.
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.engine import PlaneEngine
from gymothelloenv_tpu_torch.core.state import EnvConfig, OthelloState
from gymothelloenv_tpu_torch.envs.bit_vector_env import draw_rand_left
from gymothelloenv_tpu_torch.utils.device import resolve_device

_PLANE = PlaneEngine()


@dataclasses.dataclass
class VecEnvState:
    core: OthelloState        # (N,) games
    rand_left: torch.Tensor   # int64 (N,) forced-random plies remaining


@dataclasses.dataclass
class VecStepResult:
    state: VecEnvState
    obs: torch.Tensor         # int8 (N, B, B) canonical boards
    reward: torch.Tensor      # float32 (N,) mover-perspective terminal
    done: torch.Tensor        # bool (N,)


def vec_reset(cfg: EnvConfig, num_envs: int, initial_rand_steps: int = 0,
              generator: torch.Generator | None = None,
              rand_left: torch.Tensor | None = None,
              device=None) -> VecEnvState:
    """``num_envs`` fresh games; ``rand_left`` given or drawn."""
    device = resolve_device(device)
    if rand_left is None:
        rand_left = draw_rand_left(num_envs, initial_rand_steps, generator,
                                   device)
    return VecEnvState(core=core.reset(cfg, num_envs, device),
                       rand_left=rand_left.to(device=device,
                                              dtype=torch.int64))


def vec_step(state: VecEnvState, actions: torch.Tensor, cfg: EnvConfig,
             initial_rand_steps: int = 0,
             generator: torch.Generator | None = None,
             rand_t: torch.Tensor | None = None,
             reset_rand_left: torch.Tensor | None = None) -> VecStepResult:
    """Step every game; finished games auto-reset (``obs``/``reward``/
    ``done`` describe the terminal transition, the returned state is the
    fresh game).  Games with ``rand_left > 0`` play a uniform random legal
    move instead of their action.  With ``initial_rand_steps`` 0 no draw
    is taken."""
    games = state.core
    n, device = actions.shape[0], games.board.device
    actions = actions.to(device=device, dtype=torch.int64)
    rand_left = state.rand_left
    if initial_rand_steps != 0:
        use_rand = rand_left > 0
        rand_actions = _PLANE.random_legal(games, rand_t, generator)
        actions = torch.where(use_rand, rand_actions, actions)
        rand_left = torch.where(use_rand, rand_left - 1, rand_left)
    res = core.step(games, actions, cfg)
    fresh = core.reset(cfg, n, device)
    games = core.select_games(res.done, fresh, res.state)
    if initial_rand_steps != 0:
        if reset_rand_left is None:
            reset_rand_left = draw_rand_left(n, initial_rand_steps,
                                             generator, device)
        rand_left = torch.where(res.done, reset_rand_left.to(rand_left),
                                rand_left)
    return VecStepResult(state=VecEnvState(core=games, rand_left=rand_left),
                         obs=res.obs, reward=res.reward, done=res.done)
