"""Network input planes — the port of ``core/featurize.py::make_state``,
computed straight from the bitboard words as ``BitEngine.featurize``
does."""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core.bitboard import BitState, popcount, unpack


def make_state(state: BitState,
               replicate_single_move_quirk: bool = True) -> torch.Tensor:
    """float32 ``(N, 4, 8, 8)``: [black disks, white disks, turn plane,
    legal-move plane] (util.py:48-74).  The reference fills the legal
    plane only with >= 2 legal moves; ``replicate_single_move_quirk``
    keeps that (default), False gives the fixed variant."""
    black = unpack(state.black).to(torch.float32)
    white = unpack(state.white).to(torch.float32)
    legal = unpack(state.legal).to(torch.float32)
    turn = ((state.turn.to(torch.int32) + 1) // 2).to(torch.float32)
    turn = turn[:, None, None].expand_as(black)
    if replicate_single_move_quirk:
        legal = legal * (popcount(state.legal) >= 2).to(
            torch.float32)[:, None, None]
    return torch.stack([black, white, turn, legal], dim=1)
