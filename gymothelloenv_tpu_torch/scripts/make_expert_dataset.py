"""Generate a GAIL expert dataset from a scripted expert — the port of
``scripts/make_expert_dataset.py``.

The reference ships MuJoCo expert trajectories and an h5->pt converter
(gail_experts/convert_to_pytorch.py); for Othello the expert data comes
from a scripted expert (default maximin-2) playing itself, recorded as
(flattened ``make_state`` features, action) pairs.  Output: an npz with
'states' (K, T, 4 B^2) float32, 'actions' (K, T) int64 and 'lengths'
(K,) int64, the format ``agents.gail.ExpertDataset`` loads.

The games are JAX's: game ``g`` first draws its random-opening count from
``np.random.RandomState(seed)`` (``2 * randint(0, init_rand_steps // 2 +
1)``) and then one ``randint`` over the legal moves a random ply, game
after game; the openings are not recorded unless ``--include-openings``
is given.  The expert's decisions are deterministic for maximin and
greedy, so the openings are played game by game (they hold every draw)
and the expert then plays all games at once, all on ``--device``: one
``step_where`` a ply (on 8x8 one ply-kernel launch) and one
``make_policy(expert, search_depth)`` decision a ply of the batch (for
maximin one ``expand_legal`` launch a search level).  ``--expert rand``
samples from a torch generator instead, so its games are not JAX's.

Usage:
    python -m gymothelloenv_tpu_torch.scripts.make_expert_dataset \
        --games 256 --out runs/expert_maximin2_256.npz
    python -m gymothelloenv_tpu_torch.scripts.make_expert_dataset \
        --device cpu --games 4 --search-depth 1 --out /tmp/expert.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.core.engine import get_engine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.policies.scripted import make_policy
from gymothelloenv_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.make_expert_dataset")
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--expert", type=str, default="maximin")
    parser.add_argument("--search-depth", type=int, default=2)
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--init-rand-steps", type=int, default=10)
    parser.add_argument("--include-openings", action="store_true",
                        help="also record the random-opening plies as "
                             "expert data (up to init-rand-steps/game of "
                             "label noise; by default only the expert's "
                             "own decisions are recorded)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the expert's games (cuda or "
                             "cpu)")
    return parser


def _openings(args, cfg, eng, device, states, actions, lengths):
    """Each game's random opening, game by game with JAX's
    ``RandomState`` draws; returns the games' states after it (a batch on
    ``device``)."""
    rng = np.random.RandomState(args.seed)
    games = []
    for g in range(args.games):
        s = eng.reset_batch(1, cfg, device)
        rand_left = rng.randint(0, args.init_rand_steps // 2 + 1) * 2
        t = 0
        while rand_left > 0 and not bool(s.terminated[0]):
            moves = np.nonzero(eng.legal_flat(s)[0].cpu().numpy())[0]
            a = int(moves[rng.randint(len(moves))])
            rand_left -= 1
            if args.include_openings:
                states[g, t] = eng.featurize(s)[0].reshape(-1).cpu().numpy()
                actions[g, t] = a
                t += 1
            s = eng.step_where(s, torch.tensor([a], device=device),
                               ~s.terminated, cfg)
        lengths[g] = t
        games.append(s)
    return type(games[0])(**{
        name: torch.cat([getattr(s, name) for s in games])
        for name in vars(games[0])})


def make_dataset(args):
    """Play and record the games; returns ``(states, actions, lengths)``
    numpy arrays."""
    device = resolve_device(args.device)
    cfg = EnvConfig(board_size=args.board_size)
    eng = get_engine(cfg)
    act = make_policy(args.expert, args.search_depth)
    generator = torch.Generator(device).manual_seed(args.seed)
    max_plies = args.board_size ** 2
    d = 4 * args.board_size ** 2
    states = np.zeros((args.games, max_plies, d), np.float32)
    actions = np.zeros((args.games, max_plies), np.int64)
    lengths = np.zeros(args.games, np.int64)
    s = _openings(args, cfg, eng, device, states, actions, lengths)
    t = torch.from_numpy(lengths).to(device)
    rows = torch.arange(args.games, device=device)
    ply = 0
    while True:
        live = ~s.terminated & (t < max_plies)
        if not bool(live.any()):
            break
        a = act(s, generator)
        feat = eng.featurize(s).reshape(args.games, -1)
        g = rows[live]
        states[g.cpu().numpy(), t[live].cpu().numpy()] = \
            feat[live].cpu().numpy()
        actions[g.cpu().numpy(), t[live].cpu().numpy()] = \
            a[live].cpu().numpy()
        t = torch.where(live, t + 1, t)
        s = eng.step_where(s, a, live, cfg)
        ply += 1
        if ply % 16 == 0:
            print(f"ply {ply}: {int(live.sum())}/{args.games} games on",
                  flush=True)
    lengths[:] = t.cpu().numpy()
    return states, actions, lengths


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.time()
    states, actions, lengths = make_dataset(args)
    np.savez(args.out, states=states, actions=actions, lengths=lengths)
    print(f"wrote {args.out}: {int(lengths.sum())} transitions "
          f"from {args.games} games ({time.time() - t0:.1f} s)", flush=True)
    return states, actions, lengths


if __name__ == "__main__":
    main()
