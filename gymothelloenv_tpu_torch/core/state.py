"""Environment configuration and the terminal rules of one ply — the port
of ``gymothelloenv_tpu/core/state.py`` for the 8x8 board.

Conventions (identical to the reference): +1 = white, -1 = black, black
moves first; ``turn`` is the player to move (the last mover once the game
has ended); actions are flat indices ``row * 8 + col``.  The transition
itself lives in ``core.bitboard.bit_step``; the winner and reward rules of
``state.step`` are here.
"""

from __future__ import annotations

import dataclasses

import torch

BLACK_DISK = -1
NO_DISK = 0
WHITE_DISK = 1


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (``OthelloBaseEnv.__init__``
    flags).  The port runs the 8x8 board only."""
    board_size: int = 8
    sudden_death_on_invalid_move: bool = True
    num_disk_as_reward: bool = False

    def __post_init__(self):
        if self.board_size != 8:
            raise ValueError("the port runs the 8x8 bitboard engine only "
                             f"(got board_size={self.board_size})")

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size


def terminal_winner(terminated: torch.Tensor, sudden: torch.Tensor,
                    mover: torch.Tensor, white_cnt: torch.Tensor,
                    black_cnt: torch.Tensor) -> torch.Tensor:
    """int8 winner: the opponent of the mover after sudden death (an
    illegal move), else the sign of white minus black disks; 0 while the
    game goes on."""
    count_winner = torch.sign(white_cnt - black_cnt).to(torch.int8)
    winner = torch.where(sudden, (-mover).to(torch.int8), count_winner)
    return torch.where(terminated, winner, torch.zeros_like(winner))


def terminal_reward(terminated: torch.Tensor, sudden: torch.Tensor,
                    mover: torch.Tensor, winner: torch.Tensor,
                    mover_cnt: torch.Tensor, opp_cnt: torch.Tensor,
                    num_disk_as_reward: bool) -> torch.Tensor:
    """float32 mover-perspective terminal reward (0 before the end):
    ``winner * mover``, or with ``num_disk_as_reward`` the disk margin,
    +64 for a wipe-out and -64 for sudden death."""
    if num_disk_as_reward:
        reward = (mover_cnt - opp_cnt).to(torch.float32)
        reward = torch.where(opp_cnt == 0, torch.full_like(reward, 64.0),
                             reward)
        reward = torch.where(sudden, torch.full_like(reward, -64.0), reward)
    else:
        reward = (winner.to(torch.int32) * mover.to(torch.int32)).to(
            torch.float32)
    return torch.where(terminated, reward, torch.zeros_like(reward))
