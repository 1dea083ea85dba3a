"""Plane-shift rules for any board size — the port of
``gymothelloenv_tpu/core/bitops.py``.

A board is a pair of boolean disk planes (``mine``, ``opp``) of shape
``(..., B, B)``.  Every rule (legal placements, flips, greedy's flip
counts) is a fixed, unrolled sequence of translated-plane AND/OR algebra
(a dumb7fill flood), the same sequence as JAX's, so the results agree bit
for bit.  On the card each operation is one eager launch; the 8x8 board
has its own bitboard rules and ply kernel (``core/bitboard.py``,
``ops/step.py``).
"""

from __future__ import annotations

import torch

DIRECTIONS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _span(d: int, size: int) -> tuple:
    """Destination and source slices of a 1-cell move by ``d``."""
    if d > 0:
        return slice(1, size), slice(0, size - 1)
    if d < 0:
        return slice(0, size - 1), slice(1, size)
    return slice(0, size), slice(0, size)


def shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Translate a plane by ``(dr, dc)``, zero-filling at the edges:
    ``out[..., r, c] = x[..., r - dr, c - dc]``.  ``dr``/``dc`` in {-1, 0,
    1}.  JAX pads and slices; here the slice is written into zeros."""
    rows_to, rows_from = _span(dr, x.shape[-2])
    cols_to, cols_from = _span(dc, x.shape[-1])
    out = torch.zeros_like(x)
    out[..., rows_to, cols_to] = x[..., rows_from, cols_from]
    return out


def legal_mask(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Boolean plane of legal placements for ``mine``: empty cells from
    which, in some direction, a run of >= 1 ``opp`` disks ends in a
    ``mine`` disk (othello.py:273-343)."""
    b = mine.shape[-1]
    empty = ~(mine | opp)
    legal = torch.zeros_like(empty)
    for dr, dc in DIRECTIONS:
        t = opp & shift(mine, -dr, -dc)
        for _ in range(b - 3):
            t = t | (opp & shift(t, -dr, -dc))
        legal = legal | (empty & shift(t, -dr, -dc))
    return legal


def flip_counts(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """int32 plane ``(..., B, B)``: the opponent disks a placement at each
    cell would flip (meaningful at empty cells only)."""
    b = mine.shape[-1]
    counts = torch.zeros(mine.shape, dtype=torch.int32, device=mine.device)
    for dr, dc in DIRECTIONS:
        # s_j: cells p with p .. p+(j-1)d opponent and p+jd mine.
        s = opp & shift(mine, -dr, -dc)
        for j in range(1, b - 1):
            counts = counts + j * shift(s, -dr, -dc).to(torch.int32)
            if j < b - 2:
                s = opp & shift(s, -dr, -dc)
    return counts


def resolve_flips(onehot: torch.Tensor, mine: torch.Tensor,
                  opp: torch.Tensor) -> torch.Tensor:
    """Boolean plane of the opponent disks flipped by placing at the
    ``onehot`` cell (at most one a board): in each direction the run of
    opponent disks next to the placement, kept where a ``mine`` disk ends
    it (othello.py:391-407)."""
    b = mine.shape[-1]
    flips = torch.zeros_like(mine)
    for dr, dc in DIRECTIONS:
        f = shift(onehot, dr, dc) & opp
        for _ in range(b - 3):
            f = f | (shift(f, dr, dc) & opp)
        # Only the far end of the run can touch a non-opp cell.
        valid = (shift(f, dr, dc) & mine).flatten(-2).any(-1)
        flips = flips | (f & valid[..., None, None])
    return flips


def apply_move(onehot: torch.Tensor, mine: torch.Tensor, opp: torch.Tensor):
    """Place at ``onehot`` (presumed legal); returns ``(mine, opp)``."""
    flips = resolve_flips(onehot, mine, opp)
    return mine | onehot | flips, opp & ~flips
