"""Simple-PPO self-play training CLI — the port of ``cli/run_self_play.py``
(the reference's run_self_play.py: one shared policy, a protagonist colour
an episode, MC-return PPO updates) on the batched trainer: every JAX flag
plus ``--device``.  The net computes in float32 with TF32 off
(``utils.device.use_float32``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.run_self_play --num-updates 2000
    python -m gymothelloenv_tpu_torch.cli.run_self_play --device cpu \
        --num-envs 8 --num-steps 8 --num-updates 2 --num-test-games 4
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.simple_ppo import SimplePPOConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.simple_ppo_trainer import (
    SimplePPOSelfPlayTrainer, SimpleSelfPlayConfig)
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.run_self_play")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, net and update "
                             "(cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--num-steps", type=int, default=32)
    parser.add_argument("--num-updates", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--k-epochs", type=int, default=5)
    parser.add_argument("--eps-clip", type=float, default=0.2)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--init-rand-steps", type=int, default=0)
    parser.add_argument("--test-init-rand-steps", type=int, default=10)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--test-interval", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--vecnorm-reward", action="store_true",
                        help="live VecNormalize reward filter (the "
                             "rebuilt vendored vec-env stack) before the "
                             "MC-return update")
    return parser


def main(argv=None) -> SimplePPOSelfPlayTrainer:
    args = build_parser().parse_args(argv)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = SimplePPOSelfPlayTrainer(
            env_cfg=EnvConfig(board_size=args.board_size,
                              num_disk_as_reward=True),
            ppo_cfg=SimplePPOConfig(
                lr=args.lr, gamma=args.gamma, k_epochs=args.k_epochs,
                eps_clip=args.eps_clip, batch_size=args.batch_size),
            run_cfg=SimpleSelfPlayConfig(
                num_envs=args.num_envs, num_steps=args.num_steps,
                init_rand_steps=args.init_rand_steps,
                test_init_rand_steps=args.test_init_rand_steps,
                num_test_games=args.num_test_games,
                test_interval=args.test_interval, seed=args.seed,
                vecnorm_reward=args.vecnorm_reward),
            log_fn=logger.log if logger else None, device=args.device)
        if args.load:
            trainer.load(args.load)
        print(f"device: {trainer.device}; {precision}", flush=True)
        trainer.train(args.num_updates, log_every=args.log_every,
                      checkpoint_path=args.checkpoint or None)
        print("final eval:", trainer.evaluate(), flush=True)
    finally:
        if logger:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
