"""Full PPO train-step throughput against the game batch N — the port of
``scripts/bench_batch_scaling.py``.

For each N, a trainer at the default recipe (bfloat16 net unless
``--f32``, ``--epochs`` x ``--mini-batch`` minibatches, T
``--num-steps``) takes two warm-up steps, then ``REPS`` (10) steps
timed together, ended by a device synchronisation.  One JSON line a
configuration:

    {"num_envs": N, "bf16": ..., "epochs": ..., "mini_batch": ...,
     "ms_per_step": ..., "trans_per_sec": ...}

Usage: python -m gymothelloenv_tpu_torch.scripts.bench_batch_scaling
       [--f32] [--epochs=4] [--mini-batch=4] [--num-steps=64]
       [--device=cuda] [N ...]
"""

from __future__ import annotations

import json
import sys
import time

from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup
from gymothelloenv_tpu_torch.utils.profiling import force_sync

REPS = 10
SIZES = (4096, 8192, 16384)


def main(argv=None) -> list:
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (
        PPOSelfPlayTrainer, SelfPlayConfig)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    bf16 = "--f32" not in argv
    epochs = int(flag(argv, "epochs", "4"))
    mini_batch = int(flag(argv, "mini-batch", "4"))
    num_steps = int(flag(argv, "num-steps", "64"))
    sizes = [int(a) for a in positional(argv)] or list(SIZES)
    rows = []
    for num_envs in sizes:
        run_cfg = SelfPlayConfig(num_envs=num_envs, num_steps=num_steps,
                                 bf16=bf16, test_interval=10 ** 9)
        tr = PPOSelfPlayTrainer(
            ppo_cfg=PPOConfig(num_updates=10_000, ppo_epochs=epochs,
                              num_mini_batch=mini_batch),
            run_cfg=run_cfg, log_fn=lambda *a: None, device=dev)
        tr.ensure_initialized()
        for _ in range(2):
            force_sync(tr._collect_and_update(None))
        t0 = time.perf_counter()
        for _ in range(REPS):
            m = tr._collect_and_update(None)
        force_sync(m)
        dt = (time.perf_counter() - t0) / REPS
        trans = num_steps * num_envs
        rows.append({"num_envs": num_envs, "bf16": bf16, "epochs": epochs,
                     "mini_batch": mini_batch,
                     "ms_per_step": round(dt * 1e3, 2),
                     "trans_per_sec": round(trans / dt)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
