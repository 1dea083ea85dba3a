"""The training-strength check of the port's flagship trainer: RESULTS.md's
fast-schedule recipe (``data/queue/done/02_ppo_fast4096.job``: ``--num-envs
4096 --ppo-epochs 2 --lr 2.5e-4 --entropy-coef 0.01 --bf16
--chain-updates 20 --save-interval 500 --test-interval 1000
--num-test-games 200``, the learning rate decaying linearly over 4000
updates) trained to update ``--updates`` with ``{step}`` snapshots, then
the last snapshot against maximin-2 with ``cli/eval_checkpoint.py``, held
to JAX's step-500 figure, 271/14/115 of 400
(``data/logs/queue/03_eval_fast4096.log:2``), by the ladder's
two-proportion test at 1% (``scripts/ladder.py``).

    python -m gymothelloenv_tpu_torch.scripts.strength_check [--seed 11]
        [--updates 500] [--games 400] [--out chiprun_out/strength]
        [--num-envs 4096] [--device cuda]

Prints the trainer's lines, the evaluation's line, then one JSON line:
the seed, the snapshot, W/D/L, the training and evaluation wall seconds,
z, p and whether p is at or above ``ladder.ALPHA``.  Seeded JAX and torch
streams never agree, so the check is statistical.  On a card it first
prints the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import eval_checkpoint
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.scripts.ladder import ALPHA, two_proportion
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)

# JAX's step-500 snapshot vs maximin-2 (wins, games) and the schedule's
# length in the job that made it.
JAX_WINS, JAX_GAMES = 271, 400
SCHEDULE_UPDATES = 4000


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.strength_check")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--updates", type=int, default=500)
    parser.add_argument("--games", type=int, default=400)
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--out", type=str, default="chiprun_out/strength")
    parser.add_argument("--eval-seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"fast{args.num_envs}_s{args.seed}_"
                                  "{step}.msgpack")
    ppo_cfg = PPOConfig(lr=2.5e-4, entropy_coef=0.01, ppo_epochs=2,
                        num_updates=SCHEDULE_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=args.num_envs, seed=args.seed,
                             bf16=True, chain_updates=20,
                             save_interval=500, test_interval=1000,
                             num_test_games=200)
    t0 = time.time()
    trainer = PPOSelfPlayTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True), ppo_cfg=ppo_cfg,
        run_cfg=run_cfg, device=args.device)
    trainer.train(args.updates, checkpoint_path=path)
    train_seconds = time.time() - t0
    snapshot = path.format(step=trainer.update_count)
    t0 = time.time()
    wins, draws, losses = eval_checkpoint.main([
        "--load", snapshot, "--opponent", "maximin-2", "--games",
        str(args.games), "--seed", str(args.eval_seed), "--device",
        args.device])
    games = wins + draws + losses
    z, p = two_proportion(wins, games, JAX_WINS, JAX_GAMES)
    row = dict(seed=args.seed, snapshot=snapshot,
               updates=trainer.update_count, num_envs=args.num_envs,
               wins=wins, draws=draws, losses=losses,
               win_rate=wins / games, train_seconds=train_seconds,
               eval_seconds=time.time() - t0, jax_wins=JAX_WINS,
               jax_games=JAX_GAMES, z=z, p=p, agrees=p >= ALPHA)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
