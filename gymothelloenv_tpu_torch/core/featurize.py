"""Network input planes — the port of ``core/featurize.py``: ``make_state``
on either state layout (straight from the bitboard words on 8x8, as
``BitEngine.featurize`` does, or from a plane ``OthelloState`` at any
board size), ``undo_state`` and ``make_state_3ch``."""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core.bitboard import BitState, popcount, unpack
from gymothelloenv_tpu_torch.core.state import OthelloState


def make_state(state: BitState | OthelloState,
               replicate_single_move_quirk: bool = True) -> torch.Tensor:
    """float32 ``(N, 4, B, B)``: [black disks, white disks, turn plane,
    legal-move plane] (util.py:48-74).  The reference fills the legal
    plane only with >= 2 legal moves; ``replicate_single_move_quirk``
    keeps that (default), False gives the fixed variant."""
    if isinstance(state, OthelloState):
        return _make_state_planes(state, replicate_single_move_quirk)
    black = unpack(state.black).to(torch.float32)
    white = unpack(state.white).to(torch.float32)
    legal = unpack(state.legal).to(torch.float32)
    turn = ((state.turn.to(torch.int32) + 1) // 2).to(torch.float32)
    turn = turn[:, None, None].expand_as(black)
    if replicate_single_move_quirk:
        legal = legal * (popcount(state.legal) >= 2).to(
            torch.float32)[:, None, None]
    return torch.stack([black, white, turn, legal], dim=1)


def _turn_plane(state: OthelloState) -> torch.Tensor:
    turn = ((state.turn.to(torch.int32) + 1) // 2).to(torch.float32)
    return turn[:, None, None].expand(state.board.shape)


def _make_state_planes(state: OthelloState,
                       replicate_single_move_quirk: bool) -> torch.Tensor:
    black = (state.board == -1).to(torch.float32)
    white = (state.board == 1).to(torch.float32)
    legal = state.legal.reshape(state.board.shape).to(torch.float32)
    if replicate_single_move_quirk:
        legal = legal * (state.legal.sum(1) >= 2).to(
            torch.float32)[:, None, None]
    return torch.stack([black, white, _turn_plane(state), legal], dim=1)


def undo_state(planes: torch.Tensor,
               player_turn: torch.Tensor) -> torch.Tensor:
    """The inverse of ``make_state``: canonical observations
    ``board * turn`` (util.py:77-85).  ``planes`` (N, >=3, B, B),
    ``player_turn`` (N,)."""
    black_minus_white = planes[:, 0] - planes[:, 1]
    return torch.where((player_turn == -1)[:, None, None],
                       black_minus_white, -black_minus_white)


def make_state_3ch(state: OthelloState) -> torch.Tensor:
    """float32 ``(N, 3, B, B)``: [black, white, turn], the featurizer of
    ``run_2agent.py:29-46`` (no legal-move plane)."""
    black = (state.board == -1).to(torch.float32)
    white = (state.board == 1).to(torch.float32)
    return torch.stack([black, white, _turn_plane(state)], dim=1)
