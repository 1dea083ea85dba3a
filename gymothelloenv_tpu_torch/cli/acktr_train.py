"""ACKTR self-play training CLI — the port of ``cli/acktr_train.py``
(K-FAC natural-gradient actor-critic; the vendored ``--algo acktr`` path,
unrunnable in the reference's masked-model fork): every JAX flag plus
``--device``.  The towers compute in float32 with TF32 off
(``utils.device.use_float32``).  Checkpoints are the JAX CLI's files.

Usage:
    python -m gymothelloenv_tpu_torch.cli.acktr_train --num-updates 2000
    python -m gymothelloenv_tpu_torch.cli.acktr_train --net conv \
        --num-envs 1024 --num-steps 16 --num-updates 600 \
        --entropy-coef 0.05 --kl-clip 0.001 --test-interval 100 \
        --save-interval 200 --checkpoint 'runs/acktr_{step}.msgpack' \
        --seed 32
    python -m gymothelloenv_tpu_torch.cli.acktr_train --device cpu \
        --num-envs 16 --num-steps 5 --num-updates 2 --num-test-games 4
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.kfac import ACKTRConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.acktr_trainer import ACKTRSelfPlayTrainer
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.acktr_train")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, towers and update "
                             "(cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--num-steps", type=int, default=5)
    parser.add_argument("--num-updates", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=0.25)
    parser.add_argument("--kl-clip", type=float, default=0.001)
    parser.add_argument("--entropy-coef", type=float, default=0.01,
                        help="entropy bonus (raise to keep self-play "
                             "exploratory: at 0.01 the entropy collapses)")
    parser.add_argument("--damping", type=float, default=1e-2)
    parser.add_argument("--checkpoint", type=str, default="",
                        help="msgpack path; may contain {step}")
    parser.add_argument("--save-interval", type=int, default=1000)
    parser.add_argument("--test-interval", type=int, default=500)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--net", choices=("mlp", "conv"), default="mlp",
                        help="actor-critic towers: tanh-MLP (MLPBase) or "
                             "CNNBase-shaped conv with KFC factors")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=50)
    return parser


def main(argv=None) -> ACKTRSelfPlayTrainer:
    args = build_parser().parse_args(argv)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = ACKTRSelfPlayTrainer(
            acktr_cfg=ACKTRConfig(lr=args.lr, kl_clip=args.kl_clip,
                                  entropy_coef=args.entropy_coef,
                                  damping=args.damping),
            env_cfg=EnvConfig(board_size=args.board_size,
                              num_disk_as_reward=True),
            run_cfg=SelfPlayConfig(
                num_envs=args.num_envs, num_steps=args.num_steps,
                test_interval=args.test_interval,
                num_test_games=args.num_test_games,
                save_interval=args.save_interval, seed=args.seed),
            log_fn=logger.log if logger else None, net=args.net,
            device=args.device)
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
