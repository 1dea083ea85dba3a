"""Evaluate a saved policy checkpoint — the port of
``cli/eval_checkpoint.py``: a msgpack checkpoint, feed-forward, recurrent
(GRU) or frame-stacked, or a reference torch ``.pth``/``.pt`` (the
vendored ``Policy``, the standalone ``ActorCritic``, ``DQN`` or
``Dueling_DQN``, converted by ``compat.torch_import``; a DQN plays greedy
over its legal Q values).  The checkpoint plays a scripted opponent
(``rand | greedy | maximin-<k>``) or another checkpoint (``ckpt:<path>``,
``*.msgpack`` or ``*.pth``, head to head), half the games on each
colour, with ``--init-rand-steps`` random opening plies.  It samples
from its policy, or with ``--lookahead`` plays the value-lookahead search
(``train/ppo_trainer.net_lookahead_policy``: ``--lookahead-depth`` 1, 2
or 3, the last a beam of ``--beam-k``); ``--opp-lookahead-depth`` gives a
checkpoint opponent the search too.  A recurrent or frame-stacked side
threads its state through ``train/ppo_trainer.play_games_recurrent``
(a feed-forward protagonist against such an opponent swaps the roles, as
JAX does), and its search is depth 1 only
(``net_lookahead_cell_recurrent``); those games run in segments that fit
half the card's free memory, each segment's states starting at zero, so
the segments change no game.  The search scores children on the
training reward scale (disk differences) while the games keep the
default rules.  ``--board-size`` picks the board (the checkpoint must be
for it), the search's too.  Games run on ``--device`` (default
``cuda``).

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
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.train.ppo_trainer import (
    load_eval_policy, net_lookahead_cell_recurrent, net_lookahead_policy,
    net_sampling_cell, play_games_recurrent, rec_lookahead_game_bytes)
from gymothelloenv_tpu_torch.train.tournament import (evaluate,
                                                      net_tournament_policy)
from gymothelloenv_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.eval_checkpoint")
    parser.add_argument("--load", type=str, required=True)
    parser.add_argument("--opponent", type=str, default="greedy",
                        help="rand | greedy | maximin-<k> | ckpt:<path> / "
                             "*.msgpack / *.pth (head-to-head vs another "
                             "checkpoint)")
    parser.add_argument("--games", type=int, default=200,
                        help="total games; half as black, half as white")
    parser.add_argument("--board-size", type=int, default=8,
                        help="board side; 8 runs the bitboard engine, "
                             "other sizes the plane engine")
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
    recurrent = getattr(net, "recurrent", False)
    opp_net, opp_recurrent = None, False
    opp_la = args.opp_lookahead_depth
    if opp_is_ckpt:
        path = spec.removeprefix("ckpt:")
        opp_net, opp_desc = load_eval_policy(path, cfg, device)
        print(f"opponent checkpoint {path} ({opp_desc})", flush=True)
        opp_recurrent = getattr(opp_net, "recurrent", False)
    if opp_la and opp_recurrent and opp_la != 1:
        parser.error("recurrent opponents support lookahead depth 1 only")
    # The stateless sides: a tournament policy each.
    opp = act = None
    if opp_net is None:
        opp = policy_from_spec(spec, args.expand_chunk)
    elif not opp_recurrent:
        opp = (net_lookahead_policy(opp_net, search_cfg, opp_la,
                                    args.beam_k, args.expand_chunk)
               if opp_la else net_tournament_policy(opp_net))
    if not recurrent:
        act = (net_lookahead_policy(net, search_cfg, args.lookahead_depth,
                                    args.beam_k, args.expand_chunk)
               if args.lookahead else net_tournament_policy(net))
    n = args.games // 2
    generator = torch.Generator(device).manual_seed(args.seed)
    t0 = time.time()
    if recurrent or opp_recurrent:
        wins, draws = _play_stateful(args, cfg, search_cfg, net, opp_net,
                                     act, opp, n, generator, device)
        losses = 2 * n - wins - draws
    else:
        wins, draws, losses = evaluate(act, opp, 2 * n,
                                       args.init_rand_steps,
                                       generator=generator, cfg=cfg,
                                       device=device)
    print(f"checkpoint vs {args.opponent}: {wins} / {draws} / {losses} "
          f"(W/D/L over {2 * n} games, half each color)  "
          f"win%={wins / (2 * n):.3f}  [{time.time() - t0:.1f}s]",
          flush=True)
    return wins, draws, losses


def _play_stateful(args, cfg, search_cfg, net, opp_net, act, opp, n,
                   generator, device):
    """``n`` games on each colour where a side threads state (JAX
    eval_checkpoint.py:150-210): a recurrent protagonist, raw or with the
    depth-1 lookahead, against a tournament policy or a recurrent
    opponent (raw or armed at depth 1); or a feed-forward protagonist
    against a recurrent opponent, with the roles swapped.  The games run
    in segments that fit half the card's free memory when a recurrent
    lookahead expands inside the game loop.  Returns ``(wins, draws)`` of
    the protagonist."""
    if getattr(net, "recurrent", False):
        stateful, other, sign = net, opp, 1
        cell = (net_lookahead_cell_recurrent(net, search_cfg,
                                             args.lookahead_depth)
                if args.lookahead else None)
        opp_cell = None
        if getattr(opp_net, "recurrent", False):
            opp_cell = (net_lookahead_cell_recurrent(opp_net, search_cfg)
                        if args.opp_lookahead_depth else
                        net_sampling_cell(opp_net))
    else:
        stateful, other, sign, opp_cell = opp_net, act, -1, None
        cell = (net_lookahead_cell_recurrent(opp_net, search_cfg)
                if args.opp_lookahead_depth else None)
    per_game = rec_lookahead_game_bytes(stateful) if cell else 0
    if opp_cell is not None and args.opp_lookahead_depth:
        per_game += rec_lookahead_game_bytes(opp_net)
    seg = (n if not per_game else
           max(1, scripted.memory_budget(resolve_device(device)) // per_game))
    wins = draws = 0
    left = n
    while left > 0:
        n_seg = min(seg, left)
        # The protagonist on black, then on white.
        black, white = (play_games_recurrent(
            cfg, stateful, other, n_seg, sign * color, args.init_rand_steps,
            stateful.hidden_size, act_cell=cell, opp_cell=opp_cell,
            opp_hidden_size=opp_net.hidden_size if opp_cell else 0,
            generator=generator, device=device) for color in (-1, 1))
        wins += int((black == -1).sum()) + int((white == 1).sum())
        draws += int((black == 0).sum()) + int((white == 0).sum())
        left -= n_seg
    return wins, draws


if __name__ == "__main__":
    main()
