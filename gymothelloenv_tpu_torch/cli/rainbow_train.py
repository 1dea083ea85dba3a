"""Rainbow training CLI — the port of ``cli/rainbow_train.py`` (the runnable
stand-in for the reference's default ``rainbow`` protagonist,
util.py:42-43, whose external package is absent): every JAX flag plus
``--device``.  The nets compute in float32 with TF32 off
(``utils.device.use_float32``).  ``--data-parallel N`` trains on N
ranks, one process a rank as ``torchrun`` starts them
(``--dist-backend`` nccl or gloo), with the replay replicated or, with
``--replay-sharding per-shard``, a ring a rank; per-shard without
``--data-parallel`` is a usage error, as in JAX's CLI.  Process 0 alone
prints, logs and writes checkpoints.  Checkpoints are the JAX CLI's files (flax msgpack with ``extra.t``), so
``--load`` resumes a run of either.

Usage:
    python -m gymothelloenv_tpu_torch.cli.rainbow_train --num-chunks 500
    python -m gymothelloenv_tpu_torch.cli.rainbow_train --num-envs 1024 \
        --num-chunks 600 --batch-size 4096 --train-interval 512 \
        --opponent-pool 8 --pool-interval 50 --test-interval 25 \
        --save-interval 100 --checkpoint 'runs/rainbow_{step}.msgpack' \
        --seed 21
    python -m gymothelloenv_tpu_torch.cli.rainbow_train --device cpu \
        --num-envs 8 --chunk-plies 8 --num-chunks 2 --replay-size 4096 \
        --initial-replay-size 0 --batch-size 16 --num-test-games 4
    torchrun --nproc-per-node 4 -m gymothelloenv_tpu_torch.cli.rainbow_train \
        --data-parallel 4 --num-envs 1024 --batch-size 4096 \
        --replay-sharding per-shard
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel.multihost import (add_mesh_flags,
                                                        leave,
                                                        mesh_from_flags)
from gymothelloenv_tpu_torch.parallel.sharding import is_main
from gymothelloenv_tpu_torch.train.dqn_trainer import DQNRunConfig
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.rainbow_train")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, nets, replay and "
                             "updates (cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=128)
    parser.add_argument("--chunk-plies", type=int, default=64)
    parser.add_argument("--num-chunks", type=int, default=500)
    parser.add_argument("--opponent", type=str, default="",
                        help="''=self-play | rand | greedy")
    parser.add_argument("--n-step", type=int, default=3)
    parser.add_argument("--num-atoms", type=int, default=51)
    parser.add_argument("--lr", type=float, default=6.25e-5)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--replay-size", type=int, default=1_000_000)
    parser.add_argument("--initial-replay-size", type=int, default=20000)
    parser.add_argument("--target-update-interval", type=int, default=10000)
    parser.add_argument("--init-rand-steps", type=int, default=0)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--test-interval", type=int, default=50)
    parser.add_argument("--opponent-pool", type=int, default=0,
                        help=">0 plays the non-learning colour greedily "
                             "from a random frozen snapshot of the last K "
                             "pool entries (0 = shared self-play)")
    parser.add_argument("--pool-interval", type=int, default=100,
                        help="chunks between pool snapshots")
    parser.add_argument("--save-interval", type=int, default=200,
                        help="chunks between checkpoint saves; a {step} "
                             "placeholder in --checkpoint keeps one file "
                             "a save")
    add_mesh_flags(parser, replay=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="train minibatch (reference: 32)")
    parser.add_argument("--train-interval", type=int, default=4,
                        help="transitions per update (dqn.py:353-354)")
    return parser


def main(argv=None) -> RainbowTrainer:
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh = mesh_from_flags(parser, args)
    env_cfg = EnvConfig(board_size=args.board_size, num_disk_as_reward=True)
    rainbow_cfg = RainbowConfig(
        board_size=args.board_size, gamma=args.gamma, n_step=args.n_step,
        num_atoms=args.num_atoms, lr=args.lr,
        initial_replay_size=args.initial_replay_size,
        target_update_interval=args.target_update_interval,
        batch_size=args.batch_size, train_interval=args.train_interval)
    rb_cfg = ReplayConfig(capacity=args.replay_size,
                          board_size=args.board_size, prioritized=True)
    run_cfg = DQNRunConfig(
        num_envs=args.num_envs, chunk_plies=args.chunk_plies,
        opponent=args.opponent or None,
        init_rand_steps=args.init_rand_steps,
        opponent_pool=args.opponent_pool, pool_interval=args.pool_interval,
        num_test_games=args.num_test_games,
        test_interval=args.test_interval,
        save_interval=args.save_interval, seed=args.seed,
        replay_sharding=args.replay_sharding)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = RainbowTrainer(env_cfg=env_cfg, rainbow_cfg=rainbow_cfg,
                                 rb_cfg=rb_cfg, run_cfg=run_cfg,
                                 log_fn=logger.log if logger else None,
                                 mesh=mesh,
                                 device=None if mesh else args.device)
        say = print if is_main(mesh) else (lambda *a, **k: None)
        say(f"device: {trainer.device}; {precision}", flush=True)
        if args.load:
            trainer.load(args.load)
            say(f"resumed from {args.load} at chunk "
                  f"{trainer.chunk_count}", flush=True)
        trainer.train(args.num_chunks, log_every=args.log_every,
                      checkpoint_path=args.checkpoint or None)
        say("final eval:", trainer.evaluate(), flush=True)
    finally:
        if logger:
            logger.close()
        leave(mesh)
    return trainer


if __name__ == "__main__":
    main()
