"""Board rendering — the port of ``utils/render.py``, which is pure
numpy and kept here as a copy so the port never imports the JAX package.

The reference's pyglet GUI is broken in its snapshot (othello.py:5
commented `rendering` import → NameError on the GUI path); the working
replacements here are the ASCII board (print_board parity lives in
compat/envs.py) and a dependency-free SVG renderer with the same visual
design: green field, grid, black/white disks, legal-move hints with action
indices (othello.py:529-587).
"""

from __future__ import annotations

import numpy as np


def board_svg(board, legal_actions=(), player_turn=-1,
              cell: int = 60) -> str:
    """SVG string for a board (numpy (B, B), +1 white / -1 black)."""
    board = np.asarray(board)
    B = board.shape[0]
    size = B * cell
    r = cell // 2 - 4
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}">',
        f'<rect width="{size}" height="{size}" fill="#66cc66"/>',
    ]
    for i in range(1, B):
        o = i * cell
        parts.append(f'<line x1="{o}" y1="0" x2="{o}" y2="{size}" '
                     'stroke="black"/>')
        parts.append(f'<line x1="0" y1="{o}" x2="{size}" y2="{o}" '
                     'stroke="black"/>')
    for row in range(B):
        for col in range(B):
            v = int(board[row, col])
            if v == 0:
                continue
            cx = col * cell + cell // 2
            cy = row * cell + cell // 2
            fill = "white" if v == 1 else "black"
            parts.append(f'<circle cx="{cx}" cy="{cy}" r="{r}" '
                         f'fill="{fill}" stroke="black"/>')
    hint = "white" if player_turn == 1 else "black"
    for a in legal_actions:
        row, col = divmod(int(a), B)
        cx = col * cell + cell // 2
        cy = row * cell + cell // 2
        parts.append(f'<circle cx="{cx}" cy="{cy}" r="{r}" fill="none" '
                     f'stroke="{hint}" stroke-dasharray="4"/>')
        parts.append(f'<text x="{cx}" y="{cy + 4}" font-size="14" '
                     f'text-anchor="middle" fill="{hint}">{int(a)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def save_board_svg(path: str, board, legal_actions=(),
                   player_turn=-1) -> None:
    with open(path, "w") as f:
        f.write(board_svg(board, legal_actions, player_turn))


def live_html(board, legal_actions=(), player_turn=-1,
              status_lines=(), refresh: float = 1.0,
              done: bool = False, keep_refreshing: bool = False) -> str:
    """Self-refreshing HTML page showing the current board — the live
    interactive board view superseding the reference's broken pyglet
    window (othello.py:503-597): the driver rewrites one file per move
    and the browser polls it via <meta http-equiv=refresh>.

    ``done`` shows the game-over caption; ``keep_refreshing`` keeps the
    <meta refresh> tag on a done page (an episode end mid-run — the
    browser must keep polling or later episodes play invisibly)."""
    svg = board_svg(board, legal_actions, player_turn)
    meta = ("" if done and not keep_refreshing else
            f'<meta http-equiv="refresh" content="{refresh}">')
    status = "".join(f"<div>{line}</div>" for line in status_lines)
    mover = "white" if player_turn == 1 else "black"
    return (
        "<!DOCTYPE html><html><head>"
        '<meta charset="utf-8">'
        f"{meta}<title>gymothelloenv_tpu live board</title>"
        "<style>body{font-family:monospace;background:#222;color:#eee;"
        "display:flex;flex-direction:column;align-items:center;"
        "gap:12px;padding:20px}</style></head><body>"
        f"<div>{'game over' if done else f'{mover} to move'}</div>"
        f"{svg}{status}</body></html>")


def save_live_html(path: str, board, legal_actions=(), player_turn=-1,
                   status_lines=(), refresh: float = 1.0,
                   done: bool = False, keep_refreshing: bool = False) -> None:
    """Atomic rewrite (tmp+rename) so the polling browser never reads a
    half-written page."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(live_html(board, legal_actions, player_turn,
                          status_lines, refresh, done, keep_refreshing))
    os.replace(tmp, path)
