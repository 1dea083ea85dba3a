"""Batched engine ops on bitboard state — the port of
``core/engine.py::BitEngine`` (the 8x8 representation; the plane engine
for other board sizes is not ported)."""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import step

_BIG = 1 << 20


class BitEngine:
    """Every method is batched over a leading ``(N,)`` games axis and keeps
    the state in the word layout between plies."""

    def reset_where(self, state: bb.BitState,
                    done: torch.Tensor) -> bb.BitState:
        """Games where ``done`` back to the opening: one launch of the ply
        kernel's ``reset_where`` on the card."""
        return step.reset_where(state, done)

    def step_where(self, state: bb.BitState, actions: torch.Tensor,
                   do: torch.Tensor, cfg: EnvConfig) -> bb.BitState:
        """Step every game, keeping the old state where ``~do``: one launch
        of the ply kernel on the card."""
        return step.step_where(state, actions.to(torch.int64), do, cfg)

    def featurize(self, state: bb.BitState) -> torch.Tensor:
        """(N, 4, 8, 8) float32 make_state planes."""
        return make_state(state)

    def legal_flat(self, state: bb.BitState) -> torch.Tensor:
        """bool (N, 64) legal actions."""
        return bb.unpack_flat(state.legal)

    def greedy(self, state: bb.BitState) -> torch.Tensor:
        """1-ply greedy (GreedyPolicy, simple_policies.py:57-92): argmax of
        flip counts over legal moves, ties to the lowest index; int64."""
        is_black = state.turn == -1
        mine = torch.where(is_black, state.black, state.white)
        opp = torch.where(is_black, state.white, state.black)
        flips = bb.flip_counts(mine, opp)
        scores = torch.where(self.legal_flat(state), flips,
                             torch.full_like(flips, -_BIG))
        return torch.argmax(scores, dim=-1)

    def outcome_for(self, state: bb.BitState, pcolor: torch.Tensor,
                    cfg: EnvConfig) -> torch.Tensor:
        """float32 terminal outcome from the protagonist's (``pcolor``)
        side: the sign of the disk margin, or the margin itself (+-64 for
        a wipe-out) with ``num_disk_as_reward``."""
        white_cnt = bb.popcount(state.white).to(torch.float32)
        black_cnt = bb.popcount(state.black).to(torch.float32)
        is_white = pcolor == 1
        mine = torch.where(is_white, white_cnt, black_cnt)
        theirs = torch.where(is_white, black_cnt, white_cnt)
        if cfg.num_disk_as_reward:
            out = mine - theirs
            out = torch.where(theirs == 0, torch.full_like(out, 64.0), out)
            return torch.where(mine == 0, torch.full_like(out, -64.0), out)
        return torch.sign(mine - theirs)
