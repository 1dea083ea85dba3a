"""RESULTS.md's ladder through the port: ``cli/eval_checkpoint.py`` runs
on the committed checkpoints, raw and armed with the value-lookahead
search, each held against the JAX package's figure with a two-proportion
z-test on win% (a draw is a non-win, as JAX counts it).

    python -m gymothelloenv_tpu_torch.scripts.ladder [--games 1000]
        [--seed 0] [--device cuda] [--only TEXT]

Each cell is the same as ``python -m gymothelloenv_tpu_torch.cli.
eval_checkpoint --load <ckpt> --opponent <opp> [<flags>] --games <games>
--seed <seed>``, whose lines it prints.  Then one JSON line per cell: W/D/L,
seconds, the JAX figure, z and the two-sided p-value, and whether p is at
or above ``ALPHA``.  Seeded JAX and torch streams never agree, so the check
is statistical.  On a card it first prints the card's name and power limit
(nvidia-smi).  Reads five checkpoints under ``data/selfplay/``, two of
them recurrent (GRU), and the teacher-student student
``data/ts/ts_wide2_1500.student``.  ``--only TEXT`` runs the cells whose
checkpoint path holds TEXT (the two teacher-student cells: ``--only ts_
--games 400 --seed 123``, JAX's protocol for them).
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
LA3500 = "data/selfplay/ppo_wide2_la_3500.msgpack"
REC2000 = "data/selfplay/ppo_recurrent_2000.msgpack"
REC_WIDE2 = "data/selfplay/ppo_rec_wide2_2500.msgpack"
TS_STUDENT = "data/ts/ts_wide2_1500.student"
# (checkpoint, opponent, eval_checkpoint flags, JAX wins, JAX games, where
# RESULTS.md says so)
CELLS = ((WIDE2_4K, "maximin-2", (), 291, 400, "RESULTS.md:235"),
         (LAMIX, "maximin-2", (), 304, 400, "RESULTS.md:1119"),
         (LAMIX, f"ckpt:{WIDE2_4K}", (), 178, 400, "RESULTS.md:1119"),
         (LA3500, "maximin-2", ("--lookahead",), 963, 1000,
          "RESULTS.md:696"),
         (LA3500, "maximin-2", ("--lookahead-depth", "2"), 991, 1000,
          "RESULTS.md:697"),
         (LA3500, "maximin-2", ("--lookahead-depth", "3", "--beam-k", "8"),
          993, 1000, "RESULTS.md:1016"),
         (LA3500, f"ckpt:{WIDE2_4K}",
          ("--lookahead", "--opp-lookahead-depth", "1"), 891, 1000,
          "RESULTS.md:794-796"),
         (REC2000, "maximin-2", (), 289, 400,
          "RESULTS.md:288-290, data/logs/queue/06_eval_recurrent.log:3"),
         (REC_WIDE2, "maximin-2", (), 271, 400,
          "RESULTS.md:172-174, data/logs/queue/11_recurrent_wide2.log:318"),
         # 28.5% of 400 games (the league table gives the rate only).
         (LA3500, f"ckpt:{REC2000}", (), 114, 400, "RESULTS.md:674"),
         # The teacher-student student (job 59, 400 games, seed 123): 67.7%
         # of 400 (the rate only), and 322/13/65 against wide2_4k.
         (TS_STUDENT, "maximin-2", (), 271, 400, "RESULTS.md:988"),
         (TS_STUDENT, f"ckpt:{WIDE2_4K}", (), 322, 400,
          "RESULTS.md:987-988, data/logs/queue/64_ts_h2h.log:5"))
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
    parser.add_argument("--only", type=str, default="",
                        help="run only the cells whose checkpoint path "
                             "contains this text (e.g. ts_wide2)")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
              flush=True)
    rows = []
    for ckpt, opp, flags, jax_wins, jax_games, where in CELLS:
        if args.only not in ckpt:
            continue
        t0 = time.time()
        wins, draws, losses = eval_checkpoint.main([
            "--load", ckpt, "--opponent", opp, *flags, "--games",
            str(args.games), "--seed", str(args.seed), "--device",
            args.device])
        seconds = time.time() - t0
        games = wins + draws + losses
        z, p = two_proportion(wins, games, jax_wins, jax_games)
        rows.append(dict(load=ckpt, opponent=opp, flags=" ".join(flags),
                         wins=wins, draws=draws,
                         losses=losses, win_rate=wins / games,
                         seconds=seconds, jax_wins=jax_wins,
                         jax_games=jax_games,
                         jax_win_rate=jax_wins / jax_games, source=where,
                         z=z, p=p, agrees=p >= ALPHA))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
