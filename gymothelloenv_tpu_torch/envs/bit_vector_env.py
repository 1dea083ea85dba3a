"""Batched auto-resetting Othello env on bitboard words — the port of
``envs/bit_vector_env.py`` (random openings as in SimpleOthelloEnv,
othello.py:60-79).

Random draws are explicit inputs or come from a ``torch.Generator``:
``rand_t`` is the index of the forced-random move among each board's
legal moves (``random_legal_bit``), ``reset_rand_left`` the fresh
forced-random ply count of games that reset.
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import step
from gymothelloenv_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class BitVecEnvState:
    core: bb.BitState         # (N,) games
    rand_left: torch.Tensor   # int64 (N,) forced-random plies remaining


@dataclasses.dataclass
class BitVecStepResult:
    state: BitVecEnvState
    reward: torch.Tensor      # float32 (N,) mover-perspective terminal
    done: torch.Tensor        # bool (N,)


def draw_rand_left(n: int, initial_rand_steps: int,
                   generator: torch.Generator | None = None,
                   device=None) -> torch.Tensor:
    """Batched ``rnd.randint(0, init//2 + 1) * 2`` (othello.py:153-154)."""
    return 2 * torch.randint(0, initial_rand_steps // 2 + 1, (n,),
                             generator=generator, device=device)


def bitvec_reset(num_envs: int, initial_rand_steps: int = 0,
                 generator: torch.Generator | None = None,
                 rand_left: torch.Tensor | None = None,
                 device=None) -> BitVecEnvState:
    device = resolve_device(device)
    if rand_left is None:
        rand_left = draw_rand_left(num_envs, initial_rand_steps, generator,
                                   device)
    return BitVecEnvState(core=bb.bit_reset(num_envs, device),
                          rand_left=rand_left.to(device=device,
                                                 dtype=torch.int64))


def bitvec_step(state: BitVecEnvState, actions: torch.Tensor,
                cfg: EnvConfig, initial_rand_steps: int = 0,
                generator: torch.Generator | None = None,
                rand_t: torch.Tensor | None = None,
                reset_rand_left: torch.Tensor | None = None
                ) -> BitVecStepResult:
    """Step every game; finished games auto-reset (``reward``/``done``
    describe the terminal transition, the returned state is the fresh
    game).  Games with ``rand_left > 0`` play a uniform random legal move
    instead of their action.  The ply and the reset are one launch of the
    ply kernel on the card (``ops.step.bit_step(..., autoreset=True)``)."""
    core = state.core
    n = actions.shape[0]
    device = core.black.device
    actions = actions.to(torch.int64)
    rand_left = state.rand_left
    if initial_rand_steps != 0:
        use_rand = rand_left > 0
        rand_actions = bb.random_legal_bit(core.legal, rand_t, generator)
        actions = torch.where(use_rand, rand_actions, actions)
        rand_left = torch.where(use_rand, rand_left - 1, rand_left)

    res = step.bit_step(
        core, actions,
        sudden_death_on_invalid_move=cfg.sudden_death_on_invalid_move,
        num_disk_as_reward=cfg.num_disk_as_reward, autoreset=True)
    if initial_rand_steps != 0:
        if reset_rand_left is None:
            reset_rand_left = draw_rand_left(n, initial_rand_steps,
                                             generator, device)
        rand_left = torch.where(res.done, reset_rand_left.to(rand_left),
                                rand_left)
    return BitVecStepResult(
        state=BitVecEnvState(core=res.state, rand_left=rand_left),
        reward=res.reward, done=res.done)
