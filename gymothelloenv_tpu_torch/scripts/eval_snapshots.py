"""Evaluate a series of policy snapshots against one opponent in one
process — the port of ``scripts/eval_snapshots.py``, the post-hoc
early-stopping companion of a trainer's ``--checkpoint path_{step}.
msgpack`` snapshots.

Each snapshot (``--glob`` with ``{step}`` for each of ``--steps``) is read
through the port's loader (the JAX package's flax msgpack files, or
``.pth``) and played exactly as ``cli/eval_checkpoint.py`` plays it
(``evaluate_checkpoint``): ``--games`` games, half on each colour, with
``--init-rand-steps`` random opening plies, sampling from its policy or,
with ``--lookahead``, playing the 1-ply value lookahead, its games seeded
with ``--seed`` plus the step, so a snapshot's line equals
``eval_checkpoint --seed <seed + step>``'s.  A missing snapshot is
skipped with a line.  Games run on ``--device`` (default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.scripts.eval_snapshots \
        --glob 'data/selfplay/run_{step}.msgpack' \
        --steps 2000,2500,3000,3500,4000 --opponent maximin-2 --games 400
"""

from __future__ import annotations

import argparse
import time

from gymothelloenv_tpu_torch.cli import eval_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.eval_snapshots")
    p.add_argument("--glob", required=True,
                   help="checkpoint path template with a {step} placeholder")
    p.add_argument("--steps", required=True,
                   help="comma-separated step numbers to evaluate")
    p.add_argument("--opponent", default="maximin-2")
    p.add_argument("--games", type=int, default=400)
    p.add_argument("--init-rand-steps", type=int, default=10)
    p.add_argument("--lookahead", action="store_true",
                   help="evaluate each snapshot with the 1-ply value "
                        "lookahead operator (feed-forward only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the games and nets (cuda or cpu)")
    return p


def main(argv=None) -> dict:
    """Prints JAX's line a snapshot; returns ``{step: (wins, draws,
    losses)}`` of the snapshots found."""
    parser = build_parser()
    args = parser.parse_args(argv)
    results = {}
    for step in (int(s) for s in args.steps.split(",")):
        path = args.glob.format(step=step)
        ck = eval_checkpoint.build_parser().parse_args(
            ["--load", path, "--opponent", args.opponent, "--games",
             str(args.games), "--init-rand-steps",
             str(args.init_rand_steps), "--seed", str(args.seed + step),
             "--device", args.device]
            + (["--lookahead"] if args.lookahead else []))
        t0 = time.time()
        try:
            wins, draws, losses = eval_checkpoint.evaluate_checkpoint(
                ck, parser.error, log=lambda *a, **k: None)
        except FileNotFoundError:
            print(f"step {step}: {path} missing, skipped", flush=True)
            continue
        results[step] = (wins, draws, losses)
        n = wins + draws + losses
        print(f"step {step}: vs {args.opponent} {wins}/{draws}/{losses} "
              f"win%={wins / n:.3f}  [{time.time() - t0:.1f}s]",
              flush=True)
    return results


if __name__ == "__main__":
    main()
