"""Batched engine ops for the collectors, tournaments and policies — the
port of ``core/engine.py``: ``BitEngine`` keeps 8x8 games in bitboard
words between plies (every ply one launch of the ply kernel on the card),
``PlaneEngine`` keeps int8 ``(N, B, B)`` planes at any board size (the
plane rules of ``core/state.py``), and ``get_engine(cfg, force_plane)``
picks one as JAX's does.  Both implement the reference semantics
(othello.py:217-501) and take the same injected draws: ``random_legal``
plays the ``t``-th legal action in ascending order, so a collector makes
the same moves on either engine.

Every method is batched over a leading ``(N,)`` games axis;
``engine_of(state)`` is the engine of a state's layout.
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core import bitops
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import (EnvConfig, OthelloState,
                                                select_games)
from gymothelloenv_tpu_torch.ops import step
from gymothelloenv_tpu_torch.utils.device import resolve_device

_BIG = 1 << 20


def outcome_for_board(board: torch.Tensor, pcolor: torch.Tensor,
                      cfg: EnvConfig) -> torch.Tensor:
    """float32 terminal outcome of finished games ``(N, B, B)`` from the
    protagonist's (``pcolor``) side: the sign of the disk margin, or the
    margin itself, ``+-B*B`` for a wipe-out, with ``num_disk_as_reward``
    (ppo_run_self_play.py:303-306, othello.py:444-461)."""
    p = pcolor.to(board.dtype)[:, None, None]
    mine = (board == p).flatten(1).sum(1).to(torch.float32)
    theirs = (board == -p).flatten(1).sum(1).to(torch.float32)
    if cfg.num_disk_as_reward:
        full = float(cfg.board_size ** 2)
        out = mine - theirs
        out = torch.where(theirs == 0, torch.full_like(out, full), out)
        return torch.where(mine == 0, torch.full_like(out, -full), out)
    return torch.sign(mine - theirs)


def nth_legal(legal: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """int64 index of the ``t``-th (from 0) True of each row of ``legal``
    (N, A); a row without one gives ``A - 1``."""
    before = (legal.cumsum(1) <= t.to(torch.int64)[:, None]).sum(1)
    return before.clamp(max=legal.shape[1] - 1)


class PlaneEngine:
    """int8 ``(N, B, B)`` plane games at any board size
    (``core.state.OthelloState``); a ply is ``core.state.step``."""

    def reset_batch(self, n: int, cfg: EnvConfig,
                    device=None) -> OthelloState:
        return core.reset(cfg, n, device)

    def reset_where(self, state: OthelloState, done: torch.Tensor,
                    cfg: EnvConfig) -> OthelloState:
        fresh = core.reset(cfg, done.shape[0], done.device)
        return select_games(done, fresh, state)

    def step_where(self, state: OthelloState, actions: torch.Tensor,
                   do: torch.Tensor, cfg: EnvConfig) -> OthelloState:
        """Step every game, keeping the old state where ``~do``."""
        return select_games(do, core.step(state, actions, cfg).state, state)

    def step_all(self, state: OthelloState, actions: torch.Tensor,
                 cfg: EnvConfig):
        """Step every game; ``(new_state, mover-perspective reward)``."""
        res = core.step(state, actions, cfg)
        return res.state, res.reward

    def featurize(self, state: OthelloState) -> torch.Tensor:
        """(N, 4, B, B) float32 make_state planes (util.py:48-74)."""
        return make_state(state)

    def legal_flat(self, state: OthelloState) -> torch.Tensor:
        """bool (N, B*B) legal actions."""
        return state.legal

    def legal_count(self, state: OthelloState) -> torch.Tensor:
        """int64 (N,) number of legal actions."""
        return state.legal.sum(1)

    def random_legal(self, state: OthelloState,
                     t: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """The ``t``-th legal action (int64), ``t`` injected or drawn
        uniformly in ``[0, count)`` from ``generator``."""
        if t is None:
            t = bb.uniform_index(self.legal_count(state), generator)
        return nth_legal(state.legal, t)

    def board_turn(self, state: OthelloState):
        """Signed int8 boards (N, B, B) and turns (N,)."""
        return state.board, state.turn

    def greedy(self, state: OthelloState) -> torch.Tensor:
        """1-ply greedy (GreedyPolicy, simple_policies.py:57-92): argmax
        of flip counts over legal moves, ties to the lowest index; int64."""
        mine, opp = core.disk_planes(state.board, state.turn)
        flips = bitops.flip_counts(mine, opp).flatten(1)
        scores = torch.where(state.legal, flips, torch.full_like(flips, -_BIG))
        return torch.argmax(scores, dim=1)

    def outcome_for(self, state: OthelloState, pcolor: torch.Tensor,
                    cfg: EnvConfig) -> torch.Tensor:
        return outcome_for_board(state.board, pcolor, cfg)


class BitEngine:
    """8x8 games in bitboard words (``core.bitboard.BitState``), kept in
    the word layout between plies."""

    def reset_batch(self, n: int, cfg: EnvConfig = EnvConfig(),
                    device=None) -> bb.BitState:
        """``n`` games at the opening (``bitboard.opening``, no kernel)."""
        return bb.opening(n, resolve_device(device))

    def reset_where(self, state: bb.BitState, done: torch.Tensor,
                    cfg: EnvConfig = EnvConfig()) -> bb.BitState:
        """Games where ``done`` back to the opening: one launch of the ply
        kernel's ``reset_where`` on the card."""
        return step.reset_where(state, done)

    def step_where(self, state: bb.BitState, actions: torch.Tensor,
                   do: torch.Tensor, cfg: EnvConfig) -> bb.BitState:
        """Step every game, keeping the old state where ``~do``: one launch
        of the ply kernel on the card."""
        return step.bit_step(state, actions.to(torch.int64),
                             cfg.sudden_death_on_invalid_move,
                             cfg.num_disk_as_reward, do=do).state

    def step_all(self, state: bb.BitState, actions: torch.Tensor,
                 cfg: EnvConfig):
        """Step every game; ``(new_state, mover-perspective reward)``: one
        launch of the ply kernel on the card."""
        res = step.bit_step(state, actions.to(torch.int64),
                            cfg.sudden_death_on_invalid_move,
                            cfg.num_disk_as_reward)
        return res.state, res.reward

    def featurize(self, state: bb.BitState) -> torch.Tensor:
        """(N, 4, 8, 8) float32 make_state planes."""
        return make_state(state)

    def legal_flat(self, state: bb.BitState) -> torch.Tensor:
        """bool (N, 64) legal actions."""
        return bb.unpack_flat(state.legal)

    def legal_count(self, state: bb.BitState) -> torch.Tensor:
        """int64 (N,) number of legal actions."""
        return bb.popcount(state.legal)

    def random_legal(self, state: bb.BitState,
                     t: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """The ``t``-th legal action (``random_legal_bit``)."""
        return bb.random_legal_bit(state.legal, t, generator)

    def board_turn(self, state: bb.BitState):
        """Signed int8 boards (N, 8, 8) and turns (N,)."""
        return bb.to_board(state), state.turn

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


_PLANE = PlaneEngine()
_BIT = BitEngine()


def get_engine(cfg: EnvConfig, force_plane: bool = False):
    """``BitEngine`` for 8x8 (the fast path), ``PlaneEngine`` otherwise;
    ``force_plane`` keeps 8x8 on planes (the A/B and parity path)."""
    if cfg.board_size == 8 and not force_plane:
        return _BIT
    return _PLANE


def engine_of(state):
    """The engine of a state's layout: ``BitEngine`` for a ``BitState``,
    ``PlaneEngine`` for an ``OthelloState``."""
    return _BIT if isinstance(state, bb.BitState) else _PLANE
