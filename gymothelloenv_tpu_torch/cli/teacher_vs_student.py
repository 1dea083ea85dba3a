"""Teacher-vs-student training CLI — the port of
``cli/teacher_vs_student.py`` (``ppo_run_teacher_vs_student.py`` and the
single-process ``run_teacher_vs_student.py``): every JAX flag plus
``--device``.  Both nets compute in float32 with TF32 off
(``utils.device.use_float32``).  Checkpoints are the JAX CLI's pairs of
files (``<path>.teacher`` and ``<path>.student``, flax msgpack), so
``--load`` resumes a run of either, and ``--teacher-load`` warm-starts the
teacher from a self-play checkpoint of either.

Usage:
    python -m gymothelloenv_tpu_torch.cli.teacher_vs_student \
        --num-chunks 2000 --teacher-load data/selfplay/ppo.msgpack
    python -m gymothelloenv_tpu_torch.cli.teacher_vs_student \
        --num-envs 1024 --num-steps 32 --lr 2.5e-4 --entropy-coef 0.01 \
        --width-mult 2 --hidden-size 1024 \
        --teacher-load data/selfplay/ppo_wide2_4k.msgpack --num-chunks 200
    python -m gymothelloenv_tpu_torch.cli.teacher_vs_student --device cpu \
        --num-envs 8 --num-steps 4 --num-chunks 2 --hidden-size 32 \
        --num-test-games 4
"""

from __future__ import annotations

import argparse

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.teacher_student import (
    TeacherStudentConfig, TeacherStudentTrainer)
from gymothelloenv_tpu_torch.utils.device import use_float32
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.teacher_vs_student")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the games, nets and updates "
                             "(cuda or cpu)")
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=128)
    parser.add_argument("--num-steps", type=int, default=32)
    parser.add_argument("--num-chunks", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--clip-param", type=float, default=0.1)
    parser.add_argument("--entropy-coef", type=float, default=None,
                        help="override PPOConfig.entropy_coef")
    parser.add_argument("--hidden-size", type=int, default=512)
    parser.add_argument("--width-mult", type=int, default=1,
                        help="trunk channel multiplier (2 matches the "
                             "wide2 self-play checkpoints for "
                             "--teacher-load warm starts)")
    parser.add_argument("--save-interval", type=int, default=200,
                        help="chunks between --checkpoint saves ({step} "
                             "in the path keeps snapshots)")
    parser.add_argument("--no-train-teacher", action="store_true")
    parser.add_argument("--teacher-load", type=str, default="",
                        help="self-play checkpoint to warm-start the "
                             "teacher")
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--init-rand-steps", type=int, default=0)
    parser.add_argument("--num-test-games", type=int, default=200)
    parser.add_argument("--test-interval", type=int, default=10)
    parser.add_argument("--teacher-test-interval", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--log-dir", type=str, default="")
    parser.add_argument("--log-every", type=int, default=10)
    return parser


def main(argv=None) -> TeacherStudentTrainer:
    args = build_parser().parse_args(argv)
    env_cfg = EnvConfig(board_size=args.board_size, num_disk_as_reward=True)
    ppo_kw = dict(lr=args.lr, clip_param=args.clip_param,
                  num_updates=args.num_chunks)
    if args.entropy_coef is not None:
        ppo_kw["entropy_coef"] = args.entropy_coef
    run_cfg = TeacherStudentConfig(
        num_envs=args.num_envs, num_steps=args.num_steps,
        train_teacher=not args.no_train_teacher,
        init_rand_steps=args.init_rand_steps,
        num_test_games=args.num_test_games,
        test_interval=args.test_interval,
        teacher_test_interval=args.teacher_test_interval, seed=args.seed,
        save_interval=args.save_interval,
        hidden_size=args.hidden_size, width_mult=args.width_mult)
    precision = use_float32()
    logger = MetricsLogger(args.log_dir) if args.log_dir else None
    try:
        trainer = TeacherStudentTrainer(
            env_cfg=env_cfg, ppo_cfg=PPOConfig(**ppo_kw), run_cfg=run_cfg,
            log_fn=logger.log if logger else None, device=args.device)
        print(f"device: {trainer.device}; {precision}", flush=True)
        if args.teacher_load:
            trainer.load_teacher(args.teacher_load)
            print(f"teacher warm-started from {args.teacher_load}",
                  flush=True)
        if args.load:
            trainer.load(args.load)
            print(f"resumed from {args.load} at chunk "
                  f"{trainer.chunk_count}", flush=True)
        trainer.train(args.num_chunks, log_every=args.log_every,
                      checkpoint_path=args.checkpoint or None)
        print("final student eval:", trainer.evaluate_student(), flush=True)
    finally:
        if logger:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
