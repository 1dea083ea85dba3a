"""The training-strength checks of the port's teacher-vs-student and DQN
trainers against the JAX runs they rebuild, each evaluation held to JAX's
figure by the ladder's two-proportion test at 1% (``scripts/ladder.py``).

- ``--family ts``: JAX job 52's first recipe
  (``data/queue/done/52_ts_strength.job``: ``--num-envs 1024 --num-steps
  32 --lr 2.5e-4 --entropy-coef 0.01 --width-mult 2 --hidden-size 1024
  --teacher-load data/selfplay/ppo_wide2_4k.msgpack --num-chunks 1500
  --test-interval 100 --teacher-test-interval 500 --seed 5``), the
  learning rate decaying over its 1500 chunks, cut at chunk ``--chunks``
  (200); the student's evaluation there (200 games against each of
  random and greedy, half as each colour) against JAX's chunk-200 line,
  ``win avg(greedy)=0.65 win avg(rand)=0.82``
  (``data/logs/queue/52_ts_strength.log:14``).
- ``--family dqn``: JAX job 60 in full (``data/queue/done/
  60_dqn_after.job``: ``--num-envs 1024 --chunk-plies 512 --num-chunks 60
  --batch-size 4096 --train-interval 512 --prioritized 1 --double 1
  --dueling 1 --n-step 3 --initial-replay-size 0 --seed 4``), then its
  final evaluation (200 games against each, epsilon 0.05) against JAX's
  ``{'greedy': 0.81, 'rand': 0.81}`` (``data/logs/queue/
  60_dqn_after.log``, last lines).

    python -m gymothelloenv_tpu_torch.scripts.family_strength --family ts
        [--chunks 200] [--seed 5] [--num-envs 1024] [--device cuda]
    python -m gymothelloenv_tpu_torch.scripts.family_strength --family dqn
        [--chunks 60] [--seed 4] [--num-envs 1024] [--device cuda]

Prints the trainer's lines, then one JSON line an opponent: wins of
games, JAX's, z, p, whether p is at or above ``ladder.ALPHA``, and the
training wall seconds.  Seeded JAX and torch streams never agree, so the
check is statistical.  On a card it first prints the card's name and power
limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.scripts.ladder import ALPHA, two_proportion
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from gymothelloenv_tpu_torch.train.teacher_student import (
    TeacherStudentConfig, TeacherStudentTrainer)

TEACHER = "data/selfplay/ppo_wide2_4k.msgpack"
TEST_GAMES = 200
# JAX's win rates over TEST_GAMES games an opponent.
JAX = {"ts": {"greedy": 0.65, "rand": 0.82},
       "dqn": {"greedy": 0.81, "rand": 0.81}}
SOURCE = {"ts": "data/logs/queue/52_ts_strength.log:14 (chunk 200)",
          "dqn": "data/logs/queue/60_dqn_after.log (final eval)"}


def _ts(args, log):
    """Job 52's recipe to chunk ``args.chunks``; the student's last
    evaluation."""
    trainer = TeacherStudentTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        ppo_cfg=PPOConfig(lr=2.5e-4, clip_param=0.1, entropy_coef=0.01,
                          num_updates=1500),
        run_cfg=TeacherStudentConfig(
            num_envs=args.num_envs, num_steps=32, test_interval=100,
            teacher_test_interval=500, save_interval=250, seed=args.seed,
            num_test_games=TEST_GAMES, hidden_size=1024, width_mult=2),
        log_fn=log, device=args.device)
    trainer.load_teacher(TEACHER)
    trainer.train(args.chunks, log_every=25)
    return trainer.win_avg


def _dqn(args, log):
    """Job 60 for ``args.chunks`` chunks; the final evaluation."""
    trainer = DQNTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        dqn_cfg=DQNConfig(n_step=3, double=True, dueling=True,
                          initial_replay_size=0, batch_size=4096,
                          train_interval=512),
        rb_cfg=ReplayConfig(capacity=1_000_000, prioritized=True),
        run_cfg=DQNRunConfig(num_envs=args.num_envs, chunk_plies=512,
                             test_interval=1_000_000, seed=args.seed,
                             num_test_games=TEST_GAMES),
        log_fn=log, device=args.device)
    trainer.train(args.chunks, log_every=10)
    return trainer.evaluate()


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.family_strength")
    parser.add_argument("--family", choices=("ts", "dqn"), required=True)
    parser.add_argument("--chunks", type=int, default=None,
                        help="ts: 200 (the cut), dqn: 60 (the whole job)")
    parser.add_argument("--seed", type=int, default=None,
                        help="the JAX job's: 5 (ts), 4 (dqn)")
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.chunks is None:
        args.chunks = 200 if args.family == "ts" else 60
    if args.seed is None:
        args.seed = 5 if args.family == "ts" else 4
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
              flush=True)

    def log(step, metrics):
        text = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
        print(f"[chunk {step}] {text}", flush=True)

    t0 = time.time()
    rates = (_ts if args.family == "ts" else _dqn)(args, log)
    seconds = time.time() - t0
    rows = []
    for opp, jax_rate in JAX[args.family].items():
        wins = round(rates[opp] * TEST_GAMES)
        jax_wins = round(jax_rate * TEST_GAMES)
        z, p = two_proportion(wins, TEST_GAMES, jax_wins, TEST_GAMES)
        rows.append(dict(family=args.family, seed=args.seed,
                         chunks=args.chunks, num_envs=args.num_envs,
                         opponent=opp, wins=wins, games=TEST_GAMES,
                         win_rate=wins / TEST_GAMES, jax_wins=jax_wins,
                         jax_games=TEST_GAMES, source=SOURCE[args.family],
                         z=z, p=p, agrees=p >= ALPHA,
                         seconds=seconds))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
