"""Host-side featurizers matching ``util.make_state`` /
``run_2agent.make_state`` for the compat driver loops — the port of
``compat/featurize.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def make_state4(env) -> np.ndarray:
    """util.py:48-74 — [black, white, turn, legal] planes from a compat env
    handle, with the reference's >= 2-legal-moves quirk for the legal
    plane (util.py:55)."""
    base = env.env if hasattr(env, "env") else env
    board = base.board_state
    turn = base.player_turn
    b = board.shape[0]
    black = (board == -1).astype(float)
    white = (board == 1).astype(float)
    turn_plane = np.full_like(black, (turn + 1) // 2, dtype=float)
    legal = np.zeros_like(black)
    moves = base.possible_moves
    if len(moves) >= 2:
        for a in moves:
            legal[a // b, a % b] = 1.0
    return np.stack([black, white, turn_plane, legal])


def make_state3(env) -> np.ndarray:
    """run_2agent.py:29-46 — [black, white, turn] planes."""
    return make_state4(env)[:3]
