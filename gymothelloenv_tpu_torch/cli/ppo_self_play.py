"""PPO self-play training CLI — the port of ``cli/ppo_self_play.py`` for
the flags of the feed-forward self-play path (mirror or opponent pool,
checkpoints, chained updates), plus ``--device``.  A flag of the JAX CLI
that is not ported yet is an argparse error.  The net computes in float32
with TF32 off (``utils.device.use_float32``), and the first printed line
says so.  Checkpoints are the JAX CLI's files (flax msgpack), so
``--load`` resumes a run of either.

Usage:
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --num-updates 1000 \
        --num-envs 1024 --lr 2.5e-4 --entropy-coef 0.01 \
        --checkpoint data/selfplay/ppo_{step}.msgpack
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --device cpu \
        --num-envs 16 --num-steps 8 --num-updates 2 --hidden-size 32
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.ppo_self_play")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, net and update "
                             "(cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8, choices=[8],
                        help="the port's bitboard engine is 8x8 only")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--num-steps", type=int, default=64)
    parser.add_argument("--num-updates", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--clip-param", type=float, default=0.1)
    parser.add_argument("--entropy-coef", type=float, default=0.0)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--gae-lambda", type=float, default=0.95)
    parser.add_argument("--ppo-epochs", type=int, default=4)
    parser.add_argument("--num-mini-batch", type=int, default=4)
    parser.add_argument("--no-linear-lr-decay", action="store_true")
    parser.add_argument("--test-init-rand-steps", type=int, default=10)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--test-interval", type=int, default=100)
    parser.add_argument("--save-interval", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="",
                        help="save path; a {step} placeholder keeps one "
                             "file per save-interval snapshot")
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--reset-opt", action="store_true",
                        help="with --load: restore params only and "
                             "reinitialize optimizer + update counter "
                             "(fine-tune under a new schedule/objective)")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--hidden-size", type=int, default=512,
                        help="fc width (512 = reference parity)")
    parser.add_argument("--width-mult", type=int, default=1,
                        help="trunk channel multiplier (1 = parity "
                             "32/64/64)")
    parser.add_argument("--opponent-pool", type=int, default=0,
                        help=">0 plays the non-learning colour with a "
                             "random snapshot from the last K pool entries "
                             "(0 = mirror self-play)")
    parser.add_argument("--pool-interval", type=int, default=250,
                        help="updates between pool snapshots")
    parser.add_argument("--pool-anchor", "--pool-anchors", action="append",
                        default=[], metavar="CKPT", dest="pool_anchor",
                        help="checkpoint mixed for good into the opponent "
                             "pool (repeatable; the training net's "
                             "architecture; needs --opponent-pool > 0)")
    parser.add_argument("--chain-updates", type=int, default=1,
                        help="updates per training iteration: eval/save "
                             "cadence quantizes to K and the run length "
                             "rounds UP to a multiple of K")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    env_cfg = EnvConfig(board_size=args.board_size, num_disk_as_reward=True)
    ppo_cfg = PPOConfig(
        lr=args.lr, clip_param=args.clip_param,
        entropy_coef=args.entropy_coef, gamma=args.gamma,
        gae_lambda=args.gae_lambda, ppo_epochs=args.ppo_epochs,
        num_mini_batch=args.num_mini_batch,
        use_linear_lr_decay=not args.no_linear_lr_decay,
        num_updates=args.num_updates)
    run_cfg = SelfPlayConfig(
        num_envs=args.num_envs, num_steps=args.num_steps,
        test_init_rand_steps=args.test_init_rand_steps,
        num_test_games=args.num_test_games,
        test_interval=args.test_interval,
        save_interval=args.save_interval, seed=args.seed,
        hidden_size=args.hidden_size, width_mult=args.width_mult,
        opponent_pool=args.opponent_pool, pool_interval=args.pool_interval,
        pool_anchors=tuple(args.pool_anchor),
        chain_updates=args.chain_updates)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = PPOSelfPlayTrainer(
            env_cfg=env_cfg, ppo_cfg=ppo_cfg, run_cfg=run_cfg,
            log_fn=logger.log if logger else None, device=args.device)
        print(f"device: {trainer.device}; {precision}", flush=True)
        if args.load and args.reset_opt:
            trainer.load_params_only(args.load)
            print(f"warm-started params from {args.load} (fresh optimizer)",
                  flush=True)
        elif args.load:
            trainer.load(args.load)
            print(f"resumed from {args.load} at update "
                  f"{trainer.update_count}", flush=True)
        trainer.train(args.num_updates, log_every=args.log_every,
                      checkpoint_path=args.checkpoint or None)
        print("final eval:", trainer.evaluate(), flush=True)
    finally:
        if logger:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
