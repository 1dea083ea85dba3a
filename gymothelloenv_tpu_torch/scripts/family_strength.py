"""The training-strength checks of the port's teacher-vs-student, DQN,
Rainbow, A2C, ACKTR and GAIL trainers against the JAX runs they rebuild
(and a reading of simple PPO, which has no JAX record), each
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

- ``--family gail``: JAX job 12's first run (``data/queue/done/
  12_gail_clean.job``: ``--expert data/expert_maximin2_256_clean.npz
  --num-trajectories 256 --bc-updates 2000 --num-updates 3000 --seed
  41``, N 256, T 64, lr 1e-5) on an expert file the port's script makes
  first (``scripts/make_expert_dataset.py --games 256``: maximin-2,
  openings unrecorded, seed 0, written to ``--expert``; JAX's file held
  3449 rows at subsample 4).  Two readings of ``GAIL_GAMES`` games
  against each opponent: after the BC warm-start, against JAX's
  ``BC warm-start eval: {'greedy': 0.48, 'rand': 0.575}``, and after
  the 3000 updates, against its ``final eval: {'greedy': 0.45, 'rand':
  0.555}`` (``data/logs/queue/12_gail_clean.log``, each 200 games).
- ``--family gail_only``: job 12's second run, the same without BC,
  against its ``final eval: {'greedy': 0.44, 'rand': 0.55}``.
- ``--family simple_ppo``: ``cli/run_self_play.py`` at its defaults (N
  64, T 32) for ``--chunks`` updates (40), then ``GAIL_GAMES`` games
  against each opponent.  The JAX package has no strength record of
  simple PPO, so its rows carry no test.  The run is short because the
  reference algorithm diverges at these defaults: JAX's CLI on the CPU
  reaches a NaN loss at updates 55-111 (seeds 0-2), the port's near
  update 50, and a NaN policy then loses every game.

Readings before a cut are taken by training to each reading and
evaluating there (no evaluation in between).

    python -m gymothelloenv_tpu_torch.scripts.family_strength --family ts
        [--chunks 200] [--seed 5] [--num-envs 1024] [--device cuda]
    python -m gymothelloenv_tpu_torch.scripts.family_strength --family dqn
        [--chunks 60] [--seed 4] [--num-envs 1024] [--device cuda]
    python -m gymothelloenv_tpu_torch.scripts.family_strength \
        --family rainbow|acktr|a2c [--chunks N] [--seed S]
    python -m gymothelloenv_tpu_torch.scripts.family_strength \
        --family gail|gail_only|simple_ppo [--chunks N] [--expert PATH]

Prints the trainer's lines, then one JSON line an opponent and reading:
wins of games, JAX's, z, p, whether p is at or above ``ladder.ALPHA``,
and the training wall seconds.  Seeded JAX and torch streams never
agree, so the check is statistical.  On a card it first prints the card's name and power
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
from gymothelloenv_tpu_torch.agents.simple_ppo import SimplePPOConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.scripts.ladder import ALPHA, two_proportion
from gymothelloenv_tpu_torch.train.a2c_trainer import A2CSelfPlayTrainer
from gymothelloenv_tpu_torch.train.acktr_trainer import ACKTRSelfPlayTrainer
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from gymothelloenv_tpu_torch.train.gail_trainer import (GAILPPOTrainer,
                                                        GAILRunConfig)
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.train.simple_ppo_trainer import (
    SimplePPOSelfPlayTrainer, SimpleSelfPlayConfig)
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
       "a2c": {"greedy": (157, 200), "rand": (151, 200)},
       "gail": {"greedy": (90, 200), "rand": (111, 200)},
       "gail_only": {"greedy": (88, 200), "rand": (110, 200)},
       "simple_ppo": {"greedy": None, "rand": None}}
# JAX's BC warm-start reading of job 12's first run.
JAX_BC = {"greedy": (96, 200), "rand": (115, 200)}
SOURCE = {"ts": "data/logs/queue/52_ts_strength.log:14 (chunk 200)",
          "dqn": "data/logs/queue/60_dqn_after.log (final eval)",
          "rainbow": "data/logs/queue/07_rainbow_pool.log (chunks 200-300)",
          "acktr": "data/logs/queue/08b_acktr_confirm.log (updates 200, "
                   "300, 400)",
          "a2c": "RESULTS.md, round-2 per-trainer runs, A2C row (final "
                 "eval; the job file and log are not in the repo)",
          "gail": "data/logs/queue/12_gail_clean.log, first run (BC "
                  "warm-start eval and final eval)",
          "gail_only": "data/logs/queue/12_gail_clean.log, second run "
                       "(final eval)",
          "simple_ppo": "no JAX record"}
# Defaults an argument: (chunks or updates, seed).
DEFAULTS = {"ts": (200, 5), "dqn": (60, 4), "rainbow": (300, 21),
            "acktr": (400, 32), "a2c": (8000, 0), "gail": (3000, 41),
            "gail_only": (3000, 41), "simple_ppo": (40, 0)}
GAIL_GAMES = 1000       # games an opponent of a GAIL or simple-PPO reading
EXPERT = "runs/expert_maximin2_256.npz"
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


def _make_expert(args) -> None:
    """JAX's expert file for job 12, unless ``args.expert`` exists: 256
    maximin-2 games, openings unrecorded, seed 0."""
    import os

    from gymothelloenv_tpu_torch.scripts import make_expert_dataset
    if os.path.exists(args.expert):
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.expert)), exist_ok=True)
    make_expert_dataset.main(["--games", "256",
                              "--search-depth", "2", "--seed", "0",
                              "--device", args.device, "--out",
                              args.expert])


def _gail(args, log, bc_updates=None):
    """Job 12's run (``args.bc_updates`` BC steps, then ``args.chunks``
    GAIL updates); ``{"bc": counts, "final": counts}`` (``"bc"`` only with
    BC)."""
    bc_updates = args.bc_updates if bc_updates is None else bc_updates
    _make_expert(args)
    trainer = GAILPPOTrainer(
        expert_path=args.expert,
        gail_run=GAILRunConfig(num_trajectories=256, subsample_frequency=4),
        env_cfg=EnvConfig(num_disk_as_reward=True),
        ppo_cfg=PPOConfig(lr=1e-5, num_updates=args.chunks),
        run_cfg=SelfPlayConfig(num_envs=args.num_envs, num_steps=64,
                               test_interval=NEVER,
                               num_test_games=GAIL_GAMES, seed=args.seed),
        log_fn=log, device=args.device)
    print(f"expert rows: {len(trainer.expert)} (JAX's file: 3449)",
          flush=True)
    out = {}
    if bc_updates:
        trainer.bc_warmstart(bc_updates, log_every=200)
        out["bc"] = _counts(trainer.evaluate())
    trainer.train(args.chunks, log_every=200)
    out["final"] = _counts(trainer.evaluate())
    return out


def _simple_ppo(args, log):
    """``cli/run_self_play.py``'s defaults for ``args.chunks`` updates."""
    trainer = SimplePPOSelfPlayTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        ppo_cfg=SimplePPOConfig(),
        run_cfg=SimpleSelfPlayConfig(num_envs=args.num_envs,
                                     test_interval=NEVER,
                                     num_test_games=GAIL_GAMES,
                                     seed=args.seed),
        log_fn=log, device=args.device)
    trainer.train(args.chunks, log_every=100)
    return {"final": _counts(trainer.evaluate())}


def _counts(rates: dict) -> dict:
    """Win rates over ``GAIL_GAMES`` -> ``{opp: (wins, games)}``."""
    return {k: (round(v * GAIL_GAMES), GAIL_GAMES) for k, v in rates.items()}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.family_strength")
    parser.add_argument("--family", choices=tuple(JAX), required=True)
    parser.add_argument("--chunks", type=int, default=None,
                        help="chunks or updates: ts 200 (the cut), dqn 60 "
                             "(the whole job), rainbow 300 (the cut), "
                             "acktr 400 (the cut), a2c 8000 (the run), "
                             "gail/gail_only 3000 (the run), simple_ppo "
                             "40")
    parser.add_argument("--seed", type=int, default=None,
                        help="the JAX job's: 5 (ts), 4 (dqn), 21 "
                             "(rainbow), 32 (acktr), 41 (gail, "
                             "gail_only); a2c, simple_ppo: 0")
    parser.add_argument("--num-envs", type=int, default=None,
                        help="1024; gail/gail_only 256, simple_ppo 64")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--expert", type=str, default=EXPERT,
                        help="gail/gail_only: the expert npz, made first "
                             "with JAX's recipe when missing")
    parser.add_argument("--bc-updates", type=int, default=2000,
                        help="gail: the BC warm-start's steps (job 12's "
                             "2000)")
    args = parser.parse_args(argv)
    if args.num_envs is None:
        args.num_envs = {"gail": 256, "gail_only": 256,
                         "simple_ppo": 64}.get(args.family, 1024)
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
           "a2c": _a2c, "gail": _gail,
           "gail_only": lambda a, lg: _gail(a, lg, bc_updates=0),
           "simple_ppo": _simple_ppo}[args.family]
    counts = run(args, log)
    seconds = time.time() - t0
    readings = counts if "final" in counts else {"final": counts}
    rows = []
    for reading, got in readings.items():
        want = JAX_BC if reading == "bc" else JAX[args.family]
        for opp, jax_count in want.items():
            if isinstance(got[opp], tuple):
                wins, games = got[opp]
            else:                  # one evaluation's win rate
                wins, games = round(got[opp] * TEST_GAMES), TEST_GAMES
            row = dict(family=args.family, reading=reading, seed=args.seed,
                       chunks=args.chunks, num_envs=args.num_envs,
                       opponent=opp, wins=wins, games=games,
                       win_rate=wins / games, source=SOURCE[args.family],
                       seconds=seconds)
            if jax_count is not None:
                z, p = two_proportion(wins, games, *jax_count)
                row.update(jax_wins=jax_count[0], jax_games=jax_count[1],
                           z=z, p=p, agrees=p >= ALPHA)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
