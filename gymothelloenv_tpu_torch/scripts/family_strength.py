"""The training-strength checks of the port's teacher-vs-student, DQN,
Rainbow, A2C and ACKTR trainers against the JAX runs they rebuild, each
evaluation held to JAX's figure by the ladder's two-proportion test at 1%
(``scripts/ladder.py``).

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
- ``--family rainbow``: JAX job 07 (``data/queue/done/
  07_rainbow_pool.job``: ``--num-envs 1024 --num-chunks 600 --batch-size
  4096 --train-interval 512 --opponent-pool 8 --pool-interval 50
  --test-interval 25 --num-test-games 200 --seed 21``), cut at chunk
  ``--chunks`` (300); its evaluations at chunks 200, 225, 250, 275 and
  300 pooled (1000 games against each) against JAX's same five,
  651/1000 vs greedy and 757/1000 vs random
  (``data/logs/queue/07_rainbow_pool.log``).
- ``--family acktr``: JAX job 08b's first run (``data/queue/done/
  08b_acktr_confirm.job``: ``--net conv --num-envs 1024 --num-steps 16
  --num-updates 600 --entropy-coef 0.05 --kl-clip 0.001 --test-interval
  100 --seed 32``), cut at update ``--chunks`` (400); its evaluations at
  updates 200, 300 and 400 pooled (600 games against each) against
  JAX's, 491/600 vs greedy and 498/600 vs random
  (``data/logs/queue/08b_acktr_confirm.log``).
- ``--family a2c``: RESULTS.md's A2C run (its table of round-2 per-trainer
  runs: 8000 updates, N 1024, T 16, lr 7e-4, entropy 0.01, GAE), then its
  final evaluation (200 games against each) against JAX's 78.5% vs
  greedy and 75.5% vs random.  That run's job file and log
  (``data/logs/queue/10_a2c.log``) are not in the repo, so its seed is
  not known; the CLI's default, 0, is used.

Readings before a cut are taken by training to each reading and
evaluating there (no evaluation in between).

    python -m gymothelloenv_tpu_torch.scripts.family_strength --family ts
        [--chunks 200] [--seed 5] [--num-envs 1024] [--device cuda]
    python -m gymothelloenv_tpu_torch.scripts.family_strength --family dqn
        [--chunks 60] [--seed 4] [--num-envs 1024] [--device cuda]
    python -m gymothelloenv_tpu_torch.scripts.family_strength \
        --family rainbow|acktr|a2c [--chunks N] [--seed S]

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

from gymothelloenv_tpu_torch.agents.a2c import A2CConfig
from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
from gymothelloenv_tpu_torch.agents.kfac import ACKTRConfig
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.scripts.ladder import ALPHA, two_proportion
from gymothelloenv_tpu_torch.train.a2c_trainer import A2CSelfPlayTrainer
from gymothelloenv_tpu_torch.train.acktr_trainer import ACKTRSelfPlayTrainer
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.train.teacher_student import (
    TeacherStudentConfig, TeacherStudentTrainer)

TEACHER = "data/selfplay/ppo_wide2_4k.msgpack"
TEST_GAMES = 200
NEVER = 10 ** 9    # a test interval no run reaches
# JAX's wins and games an opponent.
JAX = {"ts": {"greedy": (130, 200), "rand": (164, 200)},
       "dqn": {"greedy": (162, 200), "rand": (162, 200)},
       "rainbow": {"greedy": (651, 1000), "rand": (757, 1000)},
       "acktr": {"greedy": (491, 600), "rand": (498, 600)},
       "a2c": {"greedy": (157, 200), "rand": (151, 200)}}
SOURCE = {"ts": "data/logs/queue/52_ts_strength.log:14 (chunk 200)",
          "dqn": "data/logs/queue/60_dqn_after.log (final eval)",
          "rainbow": "data/logs/queue/07_rainbow_pool.log (chunks 200-300)",
          "acktr": "data/logs/queue/08b_acktr_confirm.log (updates 200, "
                   "300, 400)",
          "a2c": "RESULTS.md, round-2 per-trainer runs, A2C row (final "
                 "eval; the job file and log are not in the repo)"}
# Defaults an argument: (chunks or updates, seed).
DEFAULTS = {"ts": (200, 5), "dqn": (60, 4), "rainbow": (300, 21),
            "acktr": (400, 32), "a2c": (8000, 0)}
READINGS = {"rainbow": (200, 225, 250, 275, 300), "acktr": (200, 300, 400)}


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


def _pooled(trainer, readings, log) -> dict:
    """Train to each reading, evaluate there; the wins summed over the
    readings, ``{opp: (wins, games)}``."""
    out = {"greedy": [0, 0], "rand": [0, 0]}
    done = 0
    for at in readings:
        trainer.train(at - done, log_every=25)
        done = at
        rates = trainer.evaluate()
        log(at, {f"win%({k})": v for k, v in rates.items()})
        for opp, rate in rates.items():
            out[opp][0] += round(rate * TEST_GAMES)
            out[opp][1] += TEST_GAMES
    return {k: tuple(v) for k, v in out.items()}


def _readings(family, cut):
    """The JAX run's readings up to ``cut``; a shorter rehearsal reads at
    its last chunk or update."""
    return [c for c in READINGS[family] if c <= cut] or [cut]


def _rainbow(args, log):
    """Job 07 to ``args.chunks``, evaluated at its readings."""
    trainer = RainbowTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        rainbow_cfg=RainbowConfig(batch_size=4096, train_interval=512),
        rb_cfg=ReplayConfig(capacity=1_000_000, prioritized=True),
        run_cfg=DQNRunConfig(num_envs=args.num_envs, opponent_pool=8,
                             pool_interval=50, test_interval=NEVER,
                             num_test_games=TEST_GAMES, seed=args.seed),
        log_fn=log, device=args.device)
    return _pooled(trainer, _readings("rainbow", args.chunks), log)


def _acktr(args, log):
    """Job 08b's first run to update ``args.chunks``, evaluated at its
    readings."""
    trainer = ACKTRSelfPlayTrainer(
        acktr_cfg=ACKTRConfig(kl_clip=0.001, entropy_coef=0.05),
        env_cfg=EnvConfig(num_disk_as_reward=True),
        run_cfg=SelfPlayConfig(num_envs=args.num_envs, num_steps=16,
                               test_interval=NEVER,
                               num_test_games=TEST_GAMES, seed=args.seed),
        log_fn=log, net="conv", device=args.device)
    return _pooled(trainer, _readings("acktr", args.chunks), log)


def _a2c(args, log):
    """RESULTS.md's A2C run for ``args.chunks`` updates; the final
    evaluation."""
    trainer = A2CSelfPlayTrainer(
        a2c_cfg=A2CConfig(lr=7e-4, entropy_coef=0.01, use_gae=True),
        env_cfg=EnvConfig(num_disk_as_reward=True),
        run_cfg=SelfPlayConfig(num_envs=args.num_envs, num_steps=16,
                               test_interval=1000,
                               num_test_games=TEST_GAMES, seed=args.seed),
        log_fn=log, device=args.device)
    trainer.train(args.chunks, log_every=250)
    return trainer.evaluate()


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.family_strength")
    parser.add_argument("--family", choices=tuple(JAX), required=True)
    parser.add_argument("--chunks", type=int, default=None,
                        help="chunks or updates: ts 200 (the cut), dqn 60 "
                             "(the whole job), rainbow 300 (the cut), "
                             "acktr 400 (the cut), a2c 8000 (the run)")
    parser.add_argument("--seed", type=int, default=None,
                        help="the JAX job's: 5 (ts), 4 (dqn), 21 "
                             "(rainbow), 32 (acktr); a2c: 0")
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    chunks, seed = DEFAULTS[args.family]
    args.chunks = chunks if args.chunks is None else args.chunks
    args.seed = seed if args.seed is None else args.seed
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
    run = {"ts": _ts, "dqn": _dqn, "rainbow": _rainbow, "acktr": _acktr,
           "a2c": _a2c}[args.family]
    counts = run(args, log)
    seconds = time.time() - t0
    rows = []
    for opp, (jax_wins, jax_games) in JAX[args.family].items():
        if isinstance(counts[opp], tuple):
            wins, games = counts[opp]
        else:                  # one evaluation's win rate
            wins, games = round(counts[opp] * TEST_GAMES), TEST_GAMES
        z, p = two_proportion(wins, games, jax_wins, jax_games)
        rows.append(dict(family=args.family, seed=args.seed,
                         chunks=args.chunks, num_envs=args.num_envs,
                         opponent=opp, wins=wins, games=games,
                         win_rate=wins / games, jax_wins=jax_wins,
                         jax_games=jax_games, source=SOURCE[args.family],
                         z=z, p=p, agrees=p >= ALPHA,
                         seconds=seconds))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
