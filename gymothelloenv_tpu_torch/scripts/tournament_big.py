"""Large-n tournament with bounded memory — the port of
``scripts/tournament_big.py``: each pair's ``--games`` games run as
``reps`` chunks of ``--chunk`` games (``--maximin3-chunk`` where
maximin-3 plays), tallies summed, rows playing black.

The chunks draw from one generator seeded with ``--seed`` in turn, so at
``--chunk`` (and ``--maximin3-chunk``) equal to ``--games`` each pair
plays ``cli/tournament.py``'s games at the same seed.  The lines match
``cli/tournament.py``'s, so ``tournament_ci.py`` reads them.  Games run
on ``--device`` (default ``cuda``).

Usage: python -m gymothelloenv_tpu_torch.scripts.tournament_big
       [--games 1000] [--chunk 250] [--maximin3-chunk 125] [--seed 0]
"""

from __future__ import annotations

import argparse
import time

import torch

from gymothelloenv_tpu_torch.cli.tournament import policy_from_spec
from gymothelloenv_tpu_torch.train.tournament import play_games, tally
from gymothelloenv_tpu_torch.utils.device import resolve_device

LINEUP = ("rand", "greedy", "maximin-1", "maximin-2", "maximin-3")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.tournament_big")
    p.add_argument("--games", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--maximin3-chunk", type=int, default=125)
    p.add_argument("--init-rand-steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the games (cuda or cpu)")
    return p


def main(argv=None) -> dict:
    """Prints a line a pair and the table; returns ``{(black, white):
    (black wins, draws, white wins)}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    generator = torch.Generator(device).manual_seed(args.seed)
    policies = {s: policy_from_spec(s) for s in LINEUP}

    results = {}
    for black in LINEUP:
        for white in LINEUP:
            chunk = (args.maximin3_chunk
                     if "maximin-3" in (black, white) else args.chunk)
            reps = -(-args.games // chunk)
            bw = d = ww = 0
            t0 = time.time()
            for _ in range(reps):
                winners = play_games(policies[black], policies[white],
                                     chunk, args.init_rand_steps,
                                     generator=generator, device=device)
                cb, cd, cw = tally(winners)
                bw, d, ww = bw + cb, d + cd, ww + cw
            dt = time.time() - t0
            results[(black, white)] = (bw, d, ww)
            print(f"{black:>10} (B) vs {white:<10} (W):  "
                  f"{bw:4d} / {d:3d} / {ww:4d}   [{dt:6.2f}s]", flush=True)

    width = max(len(s) for s in LINEUP) + 2
    print("\n" + " " * width + "".join(f"{w:>16}" for w in LINEUP))
    for b in LINEUP:
        row = "".join("{:>16}".format("{}/{}/{}".format(
            *results[(b, w)])) for w in LINEUP)
        print(f"{b:<{width}}" + row)
    return results


if __name__ == "__main__":
    main()
