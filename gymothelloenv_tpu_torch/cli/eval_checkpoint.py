"""Evaluate a saved PPO policy checkpoint — the port of
``cli/eval_checkpoint.py`` for feed-forward msgpack checkpoints: the
sampling net plays a scripted opponent (``rand | greedy | maximin-<k>``)
or another checkpoint (``ckpt:<path>`` or ``*.msgpack``, head to head),
half the games on each colour (``train/tournament.evaluate``), with
``--init-rand-steps`` random opening plies.  Games run on ``--device``
(default ``cuda``).  The lookahead flags (``--lookahead``,
``--lookahead-depth``, ``--beam-k``, ``--opp-lookahead-depth``) are not
ported yet and are argparse errors (ROADMAP.md queue 1 item 6).

Usage:
    python -m gymothelloenv_tpu_torch.cli.eval_checkpoint \
        --load data/selfplay/ppo_wide2_4k.msgpack --opponent maximin-2 \
        --games 1000 --seed 0
"""

from __future__ import annotations

import argparse
import time

import torch

from gymothelloenv_tpu_torch.cli.tournament import policy_from_spec
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.ppo_trainer import load_eval_policy
from gymothelloenv_tpu_torch.train.tournament import (evaluate,
                                                      net_tournament_policy)
from gymothelloenv_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.eval_checkpoint")
    parser.add_argument("--load", type=str, required=True)
    parser.add_argument("--opponent", type=str, default="greedy",
                        help="rand | greedy | maximin-<k> | ckpt:<path> / "
                             "*.msgpack (head-to-head vs another "
                             "checkpoint)")
    parser.add_argument("--games", type=int, default=200,
                        help="total games; half as black, half as white")
    parser.add_argument("--board-size", type=int, default=8, choices=[8],
                        help="the port's bitboard engine is 8x8 only")
    parser.add_argument("--init-rand-steps", type=int, default=10)
    parser.add_argument("--expand-chunk", type=int, default=0,
                        help="game-chunk size for a maximin opponent's "
                             "expansion (0 = fit the card's free memory, "
                             "<0 = unchunked)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games and nets (cuda or "
                             "cpu)")
    return parser


def main(argv=None):
    """Prints JAX's lines; returns ``(wins, draws, losses)`` of the
    checkpoint."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = EnvConfig(board_size=args.board_size)
    net, desc = load_eval_policy(args.load, cfg, device)
    print(f"loaded {args.load} ({desc})", flush=True)
    spec = args.opponent
    if spec.startswith("ckpt:") or spec.endswith((".msgpack", ".pth",
                                                   ".pt")):
        path = spec.removeprefix("ckpt:")
        opp_net, opp_desc = load_eval_policy(path, cfg, device)
        print(f"opponent checkpoint {path} ({opp_desc})", flush=True)
        opp = net_tournament_policy(opp_net)
    else:
        opp = policy_from_spec(spec, args.expand_chunk)
    n = args.games // 2
    generator = torch.Generator(device).manual_seed(args.seed)
    t0 = time.time()
    wins, draws, losses = evaluate(net_tournament_policy(net), opp, 2 * n,
                                   args.init_rand_steps,
                                   generator=generator, cfg=cfg,
                                   device=device)
    print(f"checkpoint vs {args.opponent}: {wins} / {draws} / {losses} "
          f"(W/D/L over {2 * n} games, half each color)  "
          f"win%={wins / (2 * n):.3f}  [{time.time() - t0:.1f}s]",
          flush=True)
    return wins, draws, losses


if __name__ == "__main__":
    main()
