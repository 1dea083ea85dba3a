"""RESULTS.md's maximin-2 ladder through the port: three
``cli/eval_checkpoint.py`` runs on the committed checkpoints, each held
against the JAX package's figure with a two-proportion z-test on win%
(a draw is a non-win, as JAX counts it).

    python -m gymothelloenv_tpu_torch.scripts.ladder [--games 1000]
        [--seed 0] [--device cuda]

Each cell is the same as ``python -m gymothelloenv_tpu_torch.cli.
eval_checkpoint --load <ckpt> --opponent <opp> --games <games> --seed
<seed>``, whose lines it prints.  Then one JSON line per cell: W/D/L,
seconds, the JAX figure, z and the two-sided p-value, and whether p is at
or above ``ALPHA``.  Seeded JAX and torch streams never agree, so the check
is statistical.  On a card it first prints the card's name and power limit
(nvidia-smi).  Reads the two checkpoints under ``data/selfplay/``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from gymothelloenv_tpu_torch.cli import eval_checkpoint

WIDE2_4K = "data/selfplay/ppo_wide2_4k.msgpack"
LAMIX = "data/selfplay/ppo_wide2_lamix25s17_1000.msgpack"
# (checkpoint, opponent, JAX wins, JAX games, where RESULTS.md says so)
CELLS = ((WIDE2_4K, "maximin-2", 291, 400, "RESULTS.md:235"),
         (LAMIX, "maximin-2", 304, 400, "RESULTS.md:1119"),
         (LAMIX, f"ckpt:{WIDE2_4K}", 178, 400, "RESULTS.md:1119"))
ALPHA = 0.01


def two_proportion(x1: int, n1: int, x2: int, n2: int):
    """Pooled two-proportion z-test: ``(z, two-sided p)``."""
    pooled = (x1 + x2) / (n1 + n2)
    se = math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    z = (x1 / n1 - x2 / n2) / se if se > 0 else 0.0
    return z, math.erfc(abs(z) / math.sqrt(2))


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.ladder")
    parser.add_argument("--games", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
              flush=True)
    rows = []
    for ckpt, opp, jax_wins, jax_games, where in CELLS:
        t0 = time.time()
        wins, draws, losses = eval_checkpoint.main([
            "--load", ckpt, "--opponent", opp, "--games", str(args.games),
            "--seed", str(args.seed), "--device", args.device])
        seconds = time.time() - t0
        games = wins + draws + losses
        z, p = two_proportion(wins, games, jax_wins, jax_games)
        rows.append(dict(load=ckpt, opponent=opp, wins=wins, draws=draws,
                         losses=losses, win_rate=wins / games,
                         seconds=seconds, jax_wins=jax_wins,
                         jax_games=jax_games,
                         jax_win_rate=jax_wins / jax_games, source=where,
                         z=z, p=p, agrees=p >= ALPHA))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
