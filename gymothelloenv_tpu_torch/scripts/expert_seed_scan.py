"""Scan ``make_expert_dataset.py``'s ``--seed`` for the expert file whose
GAIL dataset holds a given number of rows.

``agents.gail.ExpertDataset`` keeps ``lengths[i] // subsample_frequency``
rows of each trajectory (``SUBSAMPLE``, 4, in job 12), so a file's row
count is a function of its games' lengths alone, and a maximin expert's
games are a function of the seed alone: the openings are
``np.random.RandomState(seed)``'s draws (the device's generator is not
read).  This script plays the games of many
seeds at once, one batch a block of seeds (``--block``), each seed's
openings drawn game after game from its own ``RandomState`` exactly as
``make_expert_dataset._openings`` draws them, then the expert's plies for
the whole block; it prints one JSON line a seed with its rows and the
first seed that matches ``--rows``.  ``tests/test_torch_tools.py`` holds
its lengths to ``make_expert_dataset.make_dataset``'s seed by seed.

Usage:
    python -m gymothelloenv_tpu_torch.scripts.expert_seed_scan \
        --seeds 0:400 --rows 3449
    python -m gymothelloenv_tpu_torch.scripts.expert_seed_scan \
        --device cpu --games 4 --search-depth 1 --seeds 0:3
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.core.engine import get_engine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.policies.scripted import make_policy
from gymothelloenv_tpu_torch.utils.device import resolve_device

# make_expert_dataset.py's openings and GAIL's subsampling in job 12
# (gail_train --num-trajectories 256, subsample_frequency 4).
INIT_RAND_STEPS = 10
SUBSAMPLE = 4


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.expert_seed_scan")
    parser.add_argument("--seeds", type=str, default="0:400",
                        help="first:end (end excluded)")
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--search-depth", type=int, default=2)
    parser.add_argument("--rows", type=int, default=3449,
                        help="the row count sought (JAX's job 12 file: "
                             "3449)")
    parser.add_argument("--block", type=int, default=32,
                        help="seeds played in one batch")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def expert_lengths(seeds, games: int, search_depth: int = 2,
                   device=None) -> np.ndarray:
    """``(len(seeds), games)`` maximin plies a game, as
    ``make_expert_dataset.make_dataset`` records them at its defaults
    (``INIT_RAND_STEPS`` opening plies, not recorded), for each seed;
    all seeds in one batch."""
    device = resolve_device(device)
    cfg = EnvConfig()
    eng = get_engine(cfg)
    act = make_policy("maximin", search_depth)
    rngs = [np.random.RandomState(s) for s in seeds]
    n = len(seeds) * games
    s = eng.reset_batch(n, cfg, device)
    for g in range(games):
        rows = np.arange(len(seeds)) * games + g
        left = np.array([rng.randint(0, INIT_RAND_STEPS // 2 + 1) * 2
                         for rng in rngs])
        while True:
            terminated = s.terminated[torch.from_numpy(rows).to(device)]
            on = (left > 0) & ~terminated.cpu().numpy()
            if not on.any():
                break
            legal = eng.legal_flat(s)[torch.from_numpy(rows[on])
                                      .to(device)].cpu().numpy()
            actions = np.zeros(n, np.int64)
            for j, row_legal in zip(np.nonzero(on)[0], legal):
                moves = np.nonzero(row_legal)[0]
                actions[rows[j]] = moves[rngs[j].randint(len(moves))]
            left = left - on
            mask = np.zeros(n, bool)
            mask[rows[on]] = True
            s = eng.step_where(s, torch.from_numpy(actions).to(device),
                               torch.from_numpy(mask).to(device), cfg)
    max_plies = cfg.board_size ** 2
    t = torch.zeros(n, dtype=torch.int64, device=device)
    while True:
        live = ~s.terminated & (t < max_plies)
        if not bool(live.any()):
            break
        a = act(s, None)
        t = torch.where(live, t + 1, t)
        s = eng.step_where(s, a, live, cfg)
    return t.cpu().numpy().reshape(len(seeds), games)


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    first, end = (int(x) for x in args.seeds.split(":"))
    t0 = time.time()
    rows_out, match = [], None
    for b in range(first, end, args.block):
        seeds = list(range(b, min(b + args.block, end)))
        lengths = expert_lengths(seeds, args.games, args.search_depth,
                                 args.device)
        for seed, lens in zip(seeds, lengths):
            rows = int((lens // SUBSAMPLE).sum())
            line = dict(seed=seed, rows=rows,
                        transitions=int(lens.sum()), games=args.games)
            rows_out.append(line)
            print(json.dumps(line), flush=True)
            if match is None and rows == args.rows:
                match = seed
    print(json.dumps(dict(scanned=f"{first}:{end}", sought=args.rows,
                          first_match=match,
                          seconds=round(time.time() - t0, 2))), flush=True)
    return rows_out


if __name__ == "__main__":
    main()
