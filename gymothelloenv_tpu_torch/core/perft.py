"""Perft on the port's 8x8 kernels — the port of ``core/perft.py``:
exhaustive rule validation by counting every distinct sequence of
``depth`` disk placements.

The frontier stays on the device as bitboard words, a level at a time:
both sides' legal masks of every frontier position come from one launch
of K2 (``ops/legal_mask.py``) over the stacked frontier, and the children
from one launch of the ply kernel (``policies.scripted.expand_legal``, B1),
whose pair count is the level's one host read.  On a CPU tensor both take
their plain versions.  The counts are held against the C++ oracle
``native/othello_perft.cpp`` (tests/test_torch_perft.py, chip_smoke.py
``[perft]``).

Pass convention (JAX's, othello.py:436-442): a forced pass swaps the
mover and consumes no depth; a position where neither side can move is
terminal.  The ply kernel already bounces the turn back when the side to
move next has no move, so a child's side to move is its ``turn``; the
level's own pass rule then only ever swaps at the root.
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.ops.legal_mask import legal_mask
from gymothelloenv_tpu_torch.policies.scripted import expand_legal
from gymothelloenv_tpu_torch.utils.device import resolve_device


def _level_nodes(cur: torch.Tensor, opp: torch.Tensor) -> bb.BitState:
    """The frontier as ``BitState`` nodes with the side to move as black:
    forced passes resolved (JAX ``_level_masks``), and ``legal`` zero
    where neither side can move.  One K2 launch for both sides."""
    n = cur.shape[0]
    both = legal_mask(torch.cat([cur, opp]), torch.cat([opp, cur]))
    legal, legal_opp = both[:n], both[n:]
    has, opp_has = legal != 0, legal_opp != 0
    swap = ~has & opp_has
    moves = torch.where(swap, legal_opp, legal)
    return bb.BitState(
        black=torch.where(swap, opp, cur), white=torch.where(swap, cur, opp),
        turn=torch.full((n,), -1, dtype=torch.int8, device=cur.device),
        legal=torch.where(has | opp_has, moves, torch.zeros_like(moves)),
        terminated=torch.zeros(n, dtype=torch.bool, device=cur.device),
        winner=torch.zeros(n, dtype=torch.int8, device=cur.device))


def perft_from(cur: int, opp: int, depth: int, device=None,
               max_positions: int = 50_000_000) -> int:
    """Placement sequences of length ``depth`` from a position given as
    unsigned 64-bit words (``cur``: the side to move), bit ``k`` cell
    ``k``.  Raises ``ValueError`` past ``max_positions`` in a frontier."""
    device = resolve_device(device)
    cur_w = torch.tensor([bb._i64(int(cur))], dtype=torch.int64,
                         device=device)
    opp_w = torch.tensor([bb._i64(int(opp))], dtype=torch.int64,
                         device=device)
    count = 1
    for _ in range(depth):
        nodes = _level_nodes(cur_w, opp_w)
        got = expand_legal(nodes, nodes.legal, max_pairs=max_positions)
        if got is None:
            raise ValueError(f"perft frontier exceeds max_positions "
                             f"{max_positions}")
        child = got[2]
        count = child.turn.shape[0]
        if count == 0:
            return 0
        white = child.turn == 1
        cur_w = torch.where(white, child.white, child.black)
        opp_w = torch.where(white, child.black, child.white)
    return count


def perft(depth: int, device=None, max_positions: int = 50_000_000) -> int:
    """Placement sequences of length ``depth`` from the opening, black to
    move (4, 12, 56, 244, 1396, 8200, 55092 at depths 1-7)."""
    return perft_from(bb.INIT_BLACK, bb.INIT_WHITE, depth, device,
                      max_positions)
