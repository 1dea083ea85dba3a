"""PPO self-play training CLI — the port of ``cli/ppo_self_play.py``:
mirror or opponent-pool self-play, checkpoints, chained updates, random
openings, lookahead collection and distillation, recurrent (GRU),
frame-stacked and time-limited PPO and ``--bf16``, on any
``--board-size`` (8 on the bitboard engine, other sizes on planes, the
lookahead flags too), plus ``--device``.  The net
computes in float32 with TF32 off (``utils.device.use_float32``), or with
``--bf16`` in bfloat16 with float32 parameters and TF32 still off for the
float32 parts; the first printed line says which.  Checkpoints are the
JAX CLI's files (flax msgpack), so ``--load`` resumes a run of either.

Usage:
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --num-updates 1000 \
        --num-envs 1024 --lr 2.5e-4 --entropy-coef 0.01 \
        --checkpoint data/selfplay/ppo_{step}.msgpack
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --num-updates 1000 \
        --num-envs 512 --width-mult 2 --hidden-size 1024 \
        --lookahead-collect --lookahead-tau 1.0 --lookahead-mix 0.25 \
        --init-rand-steps 10 --ppo-epochs 2 --lr 5e-5 --no-linear-lr-decay
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --recurrent \
        --width-mult 2 --num-envs 1024 --num-steps 32 --lr 2.5e-4 \
        --entropy-coef 0.01 --checkpoint data/selfplay/ppo_rec_{step}.msgpack
    python -m gymothelloenv_tpu_torch.cli.ppo_self_play --board-size 6 \
        --width-mult 2 --hidden-size 1024 --num-envs 1024
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
    parser.add_argument("--board-size", type=int, default=8,
                        help="board side; 8 runs the bitboard engine, "
                             "other sizes the plane engine")
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
    parser.add_argument("--init-rand-steps", type=int, default=0,
                        help="random opening plies of each training game "
                             "(2 x U{0..K//2})")
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
    parser.add_argument("--recurrent", action="store_true",
                        help="GRU-recurrent policy (model.py:230-285 "
                             "rebuilt; hidden state threaded through "
                             "collection, env-subset minibatches — "
                             "num-envs must divide by num-mini-batch)")
    parser.add_argument("--frame-stack", type=int, default=1,
                        help="stack the last K observations over "
                             "channels (VecPyTorchFrameStack, vendored "
                             "envs.py:210-250); 1 = off.  Rides the "
                             "recurrent machinery — num-envs must "
                             "divide by num-mini-batch")
    parser.add_argument("--max-episode-plies", type=int, default=0,
                        help="truncate episodes after this many "
                             "protagonist decisions with proper-time-"
                             "limit GAE (TimeLimitMask + storage.py "
                             "bad_masks semantics); 0 = off")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 net compute (params stay fp32)")
    parser.add_argument("--lookahead-collect", action="store_true",
                        help="search-bootstrapped training: the "
                             "protagonist ACTS with the 1-ply value "
                             "lookahead while the update trains the raw "
                             "net (pair with --distill for approximate "
                             "policy iteration)")
    parser.add_argument("--lookahead-mix", type=float, default=1.0,
                        help="fraction of updates whose collection uses "
                             "the lookahead override (deterministic "
                             "interleave; 0.5 alternates plain and "
                             "search-guided collection)")
    parser.add_argument("--lookahead-tau", type=float, default=0.0,
                        help="softmax temperature over child values for "
                             "--lookahead-collect (0 = argmax; value "
                             "scale is disk diffs, +-64)")
    parser.add_argument("--distill", action="store_true",
                        help="cross-entropy-to-taken-action update "
                             "instead of the clipped surrogate (for "
                             "--lookahead-collect distillation)")
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
        num_updates=args.num_updates, distill=args.distill)
    run_cfg = SelfPlayConfig(
        num_envs=args.num_envs, num_steps=args.num_steps,
        init_rand_steps=args.init_rand_steps,
        test_init_rand_steps=args.test_init_rand_steps,
        num_test_games=args.num_test_games,
        test_interval=args.test_interval,
        save_interval=args.save_interval, seed=args.seed,
        hidden_size=args.hidden_size, width_mult=args.width_mult,
        opponent_pool=args.opponent_pool, pool_interval=args.pool_interval,
        pool_anchors=tuple(args.pool_anchor),
        chain_updates=args.chain_updates,
        lookahead_collect=args.lookahead_collect,
        lookahead_tau=args.lookahead_tau,
        lookahead_mix=args.lookahead_mix, recurrent=args.recurrent,
        frame_stack=args.frame_stack,
        max_episode_plies=args.max_episode_plies, bf16=args.bf16)
    precision = use_float32()
    if args.bf16:
        precision = ("bfloat16 net compute, float32 parameters; TF32 off "
                     "for matmul and cuDNN in the float32 parts")
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
