"""A2C self-play training CLI — the port of ``cli/a2c_train.py`` (the
vendored ``--algo a2c`` path, dead in the reference's Othello fork,
working here with masked actions): every JAX flag plus ``--device``.  The
net computes in float32 with TF32 off (``utils.device.use_float32``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.a2c_train --num-updates 2000
    python -m gymothelloenv_tpu_torch.cli.a2c_train --num-envs 1024 \
        --num-steps 16 --use-gae --num-updates 8000
    python -m gymothelloenv_tpu_torch.cli.a2c_train --device cpu \
        --num-envs 16 --num-steps 5 --num-updates 2 --num-test-games 4
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.a2c import A2CConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.a2c_trainer import A2CSelfPlayTrainer
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.a2c_train")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, net and update "
                             "(cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--num-steps", type=int, default=5,
                        help="rollout length (arguments.py default 5)")
    parser.add_argument("--num-updates", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=7e-4)
    parser.add_argument("--entropy-coef", type=float, default=0.01)
    parser.add_argument("--use-gae", action="store_true")
    parser.add_argument("--test-interval", type=int, default=500)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=50)
    return parser


def main(argv=None) -> A2CSelfPlayTrainer:
    args = build_parser().parse_args(argv)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = A2CSelfPlayTrainer(
            a2c_cfg=A2CConfig(lr=args.lr, entropy_coef=args.entropy_coef,
                              use_gae=args.use_gae),
            env_cfg=EnvConfig(board_size=args.board_size,
                              num_disk_as_reward=True),
            run_cfg=SelfPlayConfig(
                num_envs=args.num_envs, num_steps=args.num_steps,
                test_interval=args.test_interval,
                num_test_games=args.num_test_games, seed=args.seed),
            log_fn=logger.log if logger else None, device=args.device)
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
