"""Round-robin tournament CLI — the port of ``cli/tournament.py``: every
policy pair plays ``--games`` games on a ``--board-size`` board (default
8), the first ``--init-rand-steps`` plies random, rows play black (the
reference README table, README.md:36-50).  Games run on ``--device``
(default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.tournament --games 100
    python -m gymothelloenv_tpu_torch.cli.tournament --black greedy \
        --white maximin-2 --games 100
    python -m gymothelloenv_tpu_torch.cli.tournament --board-size 10 \
        --black maximin-1 --white greedy --games 200
"""

from __future__ import annotations

import argparse
import time

import torch

from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.policies.scripted import make_policy
from gymothelloenv_tpu_torch.train.tournament import play_games, tally
from gymothelloenv_tpu_torch.utils.device import resolve_device

DEFAULT_LINEUP = ("rand", "greedy", "maximin-1", "maximin-2", "maximin-3")


def policy_from_spec(spec: str, expand_chunk: int = 0):
    """``rand | greedy | maximin-<k>`` -> a tournament policy.
    ``expand_chunk`` bounds maximin's expansion (``scripted.
    maximin_action``: 0 fits the card's free memory, > 0 forces that many
    games a chunk, < 0 expands all at once)."""
    if spec.startswith("maximin-"):
        return make_policy("maximin", search_depth=int(spec.split("-")[1]),
                           expand_chunk=expand_chunk)
    return make_policy(spec)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.tournament")
    parser.add_argument("--games", type=int, default=100)
    parser.add_argument("--board-size", type=int, default=8,
                        help="board side; 8 runs the bitboard engine, "
                             "other sizes the plane engine")
    parser.add_argument("--init-rand-steps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--black", type=str, default=None,
                        help="single pairing: black policy spec")
    parser.add_argument("--white", type=str, default=None)
    parser.add_argument("--lineup", type=str,
                        default=",".join(DEFAULT_LINEUP))
    parser.add_argument("--expand-chunk", type=int, default=0,
                        help="game-chunk size for maximin's expansion "
                             "(0 = fit the card's free memory, <0 = "
                             "unchunked)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games (cuda or cpu)")
    return parser


def main(argv=None) -> dict:
    """Prints one row per pairing and, for a round robin, the table;
    returns ``{(black, white): (black wins, draws, white wins)}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    generator = torch.Generator(device).manual_seed(args.seed)
    cfg = EnvConfig(board_size=args.board_size)
    if args.black and args.white:
        pairs = [(args.black, args.white)]
    else:
        lineup = args.lineup.split(",")
        pairs = [(b, w) for b in lineup for w in lineup]
    policies = {}

    def get(spec):
        if spec not in policies:
            policies[spec] = policy_from_spec(spec, args.expand_chunk)
        return policies[spec]

    results = {}
    for black, white in pairs:
        t0 = time.time()
        winners = play_games(get(black), get(white), args.games,
                             args.init_rand_steps, generator=generator,
                             cfg=cfg, device=device)
        bw, d, ww = tally(winners)
        dt = time.time() - t0
        results[(black, white)] = (bw, d, ww)
        print(f"{black:>10} (B) vs {white:<10} (W):  "
              f"{bw:3d} / {d:2d} / {ww:3d}   [{dt:6.2f}s]", flush=True)

    if len(pairs) > 1:
        lineup = args.lineup.split(",")
        width = max(len(s) for s in lineup) + 2
        header = " " * width + "".join(f"{w:>14}" for w in lineup)
        print("\n" + header)
        for b in lineup:
            row = "".join("{:>14}".format("{}/{}/{}".format(
                *results[(b, w)])) for w in lineup)
            print(f"{b:<{width}}" + row)
    return results


if __name__ == "__main__":
    main()
