"""GAIL training CLI — the port of ``cli/gail_train.py``: adversarial
imitation of a scripted expert (the vendored main.py ``--gail`` path,
dead in the reference, working here), every JAX flag plus ``--device``.
The net computes in float32 with TF32 off (``utils.device.use_float32``).

Usage:
    python -m gymothelloenv_tpu_torch.scripts.make_expert_dataset \
        --games 256 --out runs/expert_maximin2_256.npz
    python -m gymothelloenv_tpu_torch.cli.gail_train \
        --expert runs/expert_maximin2_256.npz --num-trajectories 256 \
        --bc-updates 2000 --num-updates 3000 --seed 41
    python -m gymothelloenv_tpu_torch.cli.gail_train --device cpu \
        --expert runs/expert.npz --num-envs 8 --num-steps 8 \
        --num-updates 2 --num-test-games 4 --bc-updates 2
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.gail_trainer import (GAILPPOTrainer,
                                                        GAILRunConfig)
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.gail_train")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, nets and updates "
                             "(cuda or cpu)")
    parser.add_argument("--expert", type=str, required=True,
                        help="expert npz/h5 (scripts.make_expert_dataset)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--num-steps", type=int, default=64)
    parser.add_argument("--num-updates", type=int, default=500)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--gail-epoch", type=int, default=5)
    parser.add_argument("--gail-batch-size", type=int, default=128)
    parser.add_argument("--num-trajectories", type=int, default=4)
    parser.add_argument("--bc-updates", type=int, default=0,
                        help="behaviour-cloning pretrain steps on the "
                             "expert before adversarial training "
                             "(0 = off)")
    parser.add_argument("--subsample-frequency", type=int, default=4)
    parser.add_argument("--test-interval", type=int, default=100)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=10)
    return parser


def main(argv=None) -> GAILPPOTrainer:
    args = build_parser().parse_args(argv)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = GAILPPOTrainer(
            expert_path=args.expert,
            gail_run=GAILRunConfig(
                gail_epoch=args.gail_epoch,
                gail_batch_size=args.gail_batch_size,
                num_trajectories=args.num_trajectories,
                subsample_frequency=args.subsample_frequency),
            env_cfg=EnvConfig(board_size=args.board_size,
                              num_disk_as_reward=True),
            ppo_cfg=PPOConfig(lr=args.lr, num_updates=args.num_updates),
            run_cfg=SelfPlayConfig(
                num_envs=args.num_envs, num_steps=args.num_steps,
                test_interval=args.test_interval,
                num_test_games=args.num_test_games, seed=args.seed),
            log_fn=logger.log if logger else None, device=args.device)
        print(f"device: {trainer.device}; {precision}; expert rows: "
              f"{len(trainer.expert)}", flush=True)
        if args.bc_updates:
            trainer.bc_warmstart(args.bc_updates)
            print("BC warm-start eval:", trainer.evaluate(), flush=True)
        trainer.train(args.num_updates, log_every=args.log_every,
                      checkpoint_path=args.checkpoint or None)
        print("final eval:", trainer.evaluate(), flush=True)
    finally:
        if logger:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
