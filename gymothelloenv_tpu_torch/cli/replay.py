"""Game replay viewer — the port of ``cli/replay.py``: one game between two
player specs rendered as ONE self-contained HTML file with step/play
controls (the SVG renderer of ``utils/render.py``, move captions and disk
counts).

The game is a batch of one plane game stepped by ``core.state.step`` (on
8x8 one launch of the ply kernel a ply).  Players: ``rand``, ``greedy``,
``maximin-<k>`` (``cli/tournament.policy_from_spec``) and ``net:<ckpt>``
(a msgpack or reference ``.pth`` checkpoint through
``train/ppo_trainer.load_eval_policy``; a recurrent or frame-stacked net
threads its state across the game).  A net samples its masked policy, or
with ``--deterministic`` plays its most probable legal move.  Random draws
come from a ``torch.Generator`` seeded with ``--seed``; the game runs on
``--device`` (default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.replay --black greedy \
        --white maximin-2 --out replay.html
    python -m gymothelloenv_tpu_torch.cli.replay \
        --black net:data/selfplay/ppo_wide2_4k.msgpack --deterministic
"""

from __future__ import annotations

import argparse
import html
import json

import torch

from gymothelloenv_tpu_torch.cli.tournament import policy_from_spec
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.engine import engine_of
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.policies.scripted import random_policy
from gymothelloenv_tpu_torch.train.ppo_trainer import load_eval_policy
from gymothelloenv_tpu_torch.train.self_play import Draws
from gymothelloenv_tpu_torch.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.utils.device import resolve_device
from gymothelloenv_tpu_torch.utils.render import board_svg

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Othello replay</title>
<style>
 body {{ font-family: sans-serif; margin: 24px; }}
 #board svg {{ border: 2px solid #333; }}
 #controls {{ margin: 12px 0; }}
 button {{ font-size: 16px; padding: 4px 14px; margin-right: 6px; }}
 #caption {{ font-size: 15px; margin-top: 8px; white-space: pre; }}
</style></head><body>
<h3>{title}</h3>
<div id="board"></div>
<div id="controls">
 <button onclick="go(0)">&#9198;</button>
 <button onclick="go(i-1)">&#9664;</button>
 <button onclick="toggle()" id="playbtn">&#9654;</button>
 <button onclick="go(i+1)">&#9654;&#9654;</button>
 <button onclick="go(frames.length-1)">&#9197;</button>
 <input type="range" min="0" max="{last}" value="0" id="slider"
        oninput="go(parseInt(this.value))" style="width:300px">
</div>
<div id="caption"></div>
<script>
const frames = {frames_json};
const captions = {captions_json};
let i = 0, timer = null;
function go(j) {{
  i = Math.max(0, Math.min(frames.length - 1, j));
  document.getElementById('board').innerHTML = frames[i];
  document.getElementById('caption').textContent = captions[i];
  document.getElementById('slider').value = i;
}}
function toggle() {{
  if (timer) {{ clearInterval(timer); timer = null;
    document.getElementById('playbtn').innerHTML = '&#9654;'; return; }}
  document.getElementById('playbtn').innerHTML = '&#9208;';
  timer = setInterval(() => {{
    if (i >= frames.length - 1) {{ toggle(); return; }}
    go(i + 1);
  }}, 700);
}}
document.addEventListener('keydown', e => {{
  if (e.key === 'ArrowRight') go(i + 1);
  if (e.key === 'ArrowLeft') go(i - 1);
}});
go(0);
</script></body></html>
"""


def net_player(path: str, cfg: EnvConfig, device,
               deterministic: bool = False):
    """A checkpoint as a player ``act(state, generator) -> action (1,)``
    on a batch of one game: the masked policy sampled from ``generator``,
    or its mode with ``deterministic``.  A stateful net (recurrent or
    frame-stacked) carries its state from call to call (``act.stateful``
    is then True), one game's worth."""
    policy, _ = load_eval_policy(path, cfg, device=device)
    stateful = getattr(policy, "recurrent", False)
    h = [torch.zeros(1, policy.hidden_size, device=device)] if stateful \
        else None

    def act(state, generator=None) -> torch.Tensor:
        with torch.inference_mode():
            x = make_state(state)
            if stateful:
                logits, _, h[0] = policy(x, h[0],
                                         torch.ones(1, device=x.device))
            else:
                logits, _ = policy(x)
            dist = MaskedCategorical(logits=logits,
                                     mask=engine_of(state).legal_flat(state))
            return dist.mode() if deterministic else dist.sample(
                generator=generator)
    act.stateful = stateful
    return act


def make_player(spec: str, cfg: EnvConfig, device,
                deterministic: bool = False):
    """``rand | greedy | maximin-<k> | net:<ckpt>`` -> a player."""
    if spec.startswith("net:"):
        return net_player(spec[4:], cfg, device, deterministic)
    return policy_from_spec(spec)


def play_one_game(cfg: EnvConfig, black, white,
                  generator: torch.Generator, init_rand_steps: int,
                  device) -> list:
    """One game; returns ``(board (B, B) int8 numpy, legal indices, turn,
    caption)`` frames, the terminal position last.  The first
    ``2 * U{0..init_rand_steps // 2}`` plies are uniform random legal
    moves; a stateful player still sees its decisions there, so its state
    advances through the opening (JAX ``play_one_game``)."""
    b = cfg.board_size
    s = core.reset(cfg, 1, device)
    rand_left = int(draw_max_rand_steps(Draws(generator), 1, init_rand_steps,
                                        device)[0])
    frames = []
    ply = 0
    while not bool(s.terminated[0]) and ply < b ** 2 + 10:
        turn = int(s.turn[0])
        pol = black if turn == -1 else white
        if ply < rand_left:
            if getattr(pol, "stateful", False):
                pol(s, generator)
            a = random_policy(s, generator)
            who = "random opening"
        else:
            a = pol(s, generator)
            who = "black" if turn == -1 else "white"
        board = s.board[0].cpu().numpy()
        legal = torch.nonzero(s.legal[0])[:, 0].tolist()
        mover = "BLACK" if turn == -1 else "WHITE"
        a_int = int(a.reshape(-1)[0])
        frames.append((board, legal, turn,
                       f"ply {ply}: {mover} to move ({who}) -> "
                       f"{chr(97 + a_int % b)}{a_int // b + 1} "
                       f"(action {a_int})"))
        s = core.step(s, torch.tensor([a_int], dtype=torch.int64,
                                      device=s.turn.device), cfg).state
        ply += 1

    board = s.board[0].cpu().numpy()
    blacks = int((board == -1).sum())
    whites = int((board == 1).sum())
    winner = {-1: "BLACK wins", 0: "draw", 1: "WHITE wins"}[int(s.winner[0])]
    frames.append((board, [], int(s.turn[0]),
                   f"final: {winner}  (black {blacks} - white {whites})"))
    return frames


def render_page(frames: list, black: str, white: str, seed: int) -> str:
    """The replay's self-contained HTML page."""
    svgs = [board_svg(b, legal_actions=legal, player_turn=t)
            for b, legal, t, _ in frames]
    captions = [c for _, _, _, c in frames]
    return _PAGE.format(
        title=html.escape(f"{black} (black) vs {white} (white) — "
                          f"seed {seed}"),
        last=len(frames) - 1,
        frames_json=json.dumps(svgs),
        captions_json=json.dumps(captions))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.replay")
    parser.add_argument("--black", type=str, default="greedy",
                        help="rand | greedy | maximin-<k> | net:<ckpt>")
    parser.add_argument("--white", type=str, default="rand")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--init-rand-steps", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--deterministic", action="store_true",
                        help="net players play their most probable legal "
                             "move instead of sampling")
    parser.add_argument("--out", type=str, default="replay.html")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the game (cuda or cpu)")
    return parser


def main(argv=None) -> list:
    """Writes ``--out``; returns the frames."""
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = EnvConfig(board_size=args.board_size)
    black = make_player(args.black, cfg, device, args.deterministic)
    white = make_player(args.white, cfg, device, args.deterministic)
    generator = torch.Generator(device).manual_seed(args.seed)
    frames = play_one_game(cfg, black, white, generator,
                           args.init_rand_steps, device)
    with open(args.out, "w") as f:
        f.write(render_page(frames, args.black, args.white, args.seed))
    print(f"wrote {args.out}: {len(frames)} frames; {frames[-1][3]}")
    return frames


if __name__ == "__main__":
    main()
