"""Evaluate a saved PPO policy checkpoint — the port of
``cli/eval_checkpoint.py`` for feed-forward msgpack checkpoints: the
checkpoint plays a scripted opponent (``rand | greedy | maximin-<k>``) or
another checkpoint (``ckpt:<path>`` or ``*.msgpack``, head to head), half
the games on each colour (``train/tournament.evaluate``), with
``--init-rand-steps`` random opening plies.  It samples from its policy,
or with ``--lookahead`` plays the value-lookahead search
(``train/ppo_trainer.net_lookahead_policy``: ``--lookahead-depth`` 1, 2
or 3, the last a beam of ``--beam-k``); ``--opp-lookahead-depth`` gives a
checkpoint opponent the search too.  The search scores children on the
training reward scale (disk differences) while the games keep the
default rules.  Games run on ``--device`` (default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.eval_checkpoint \
        --load data/selfplay/ppo_wide2_4k.msgpack --opponent maximin-2 \
        --games 1000 --seed 0
    python -m gymothelloenv_tpu_torch.cli.eval_checkpoint \
        --load data/selfplay/ppo_wide2_la_3500.msgpack --lookahead-depth 3 \
        --beam-k 8 --opponent maximin-2 --games 1000 --seed 321
"""

from __future__ import annotations

import argparse
import time

import torch

from gymothelloenv_tpu_torch.cli.tournament import policy_from_spec
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.ppo_trainer import (load_eval_policy,
                                                       net_lookahead_policy)
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
    parser.add_argument("--lookahead", action="store_true",
                        help="1-ply value lookahead: expand every legal "
                             "move, score children with the value head "
                             "(terminal children with the true reward), "
                             "play the argmax")
    parser.add_argument("--lookahead-depth", type=int, default=1,
                        choices=(1, 2, 3),
                        help="value-lookahead search depth (2 = full "
                             "opponent-reply minimax over the legal "
                             "grandchildren; 3 = beam search: exact "
                             "depth-2 backup under the --beam-k best "
                             "children by depth-1 value; implies "
                             "--lookahead)")
    parser.add_argument("--beam-k", type=int, default=8,
                        help="beam width for depth-3 lookahead (64 = "
                             "exact full depth 3)")
    parser.add_argument("--opp-lookahead-depth", type=int, default=0,
                        choices=(0, 1, 2, 3),
                        help="give a CHECKPOINT opponent the value "
                             "lookahead too (0 = raw sampling)")
    parser.add_argument("--expand-chunk", type=int, default=0,
                        help="game-chunk size for the search's and a "
                             "maximin opponent's expansion (0 = fit half "
                             "the card's free memory, <0 = unchunked)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games and nets (cuda or "
                             "cpu)")
    return parser


def main(argv=None):
    """Prints JAX's lines; returns ``(wins, draws, losses)`` of the
    checkpoint."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.lookahead_depth > 1:
        args.lookahead = True
    device = resolve_device(args.device)
    cfg = EnvConfig(board_size=args.board_size)
    # The search scores children on the training reward scale, so terminal
    # rewards and value estimates are commensurable.
    search_cfg = EnvConfig(board_size=args.board_size,
                           num_disk_as_reward=True)
    spec = args.opponent
    opp_is_ckpt = spec.startswith("ckpt:") or spec.endswith(
        (".msgpack", ".pth", ".pt"))
    if args.opp_lookahead_depth and not opp_is_ckpt:
        parser.error("--opp-lookahead-depth needs a checkpoint opponent "
                     "(ckpt:<path> / *.msgpack / *.pth)")
    net, desc = load_eval_policy(args.load, cfg, device)
    print(f"loaded {args.load} ({desc})", flush=True)
    if opp_is_ckpt:
        path = spec.removeprefix("ckpt:")
        opp_net, opp_desc = load_eval_policy(path, cfg, device)
        print(f"opponent checkpoint {path} ({opp_desc})", flush=True)
        opp = (net_lookahead_policy(opp_net, search_cfg,
                                    args.opp_lookahead_depth, args.beam_k,
                                    args.expand_chunk)
               if args.opp_lookahead_depth else
               net_tournament_policy(opp_net))
    else:
        opp = policy_from_spec(spec, args.expand_chunk)
    act = (net_lookahead_policy(net, search_cfg, args.lookahead_depth,
                                args.beam_k, args.expand_chunk)
           if args.lookahead else net_tournament_policy(net))
    n = args.games // 2
    generator = torch.Generator(device).manual_seed(args.seed)
    t0 = time.time()
    wins, draws, losses = evaluate(act, opp, 2 * n,
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
