"""Recurrent-PPO throughput breakdown — the port of
``scripts/profile_recurrent.py``.

Times, per (T, N, num_mini_batch): the recurrent collector alone
(``collect_rollout_recurrent``) and the recurrent update
(``ppo_update_recurrent``: every minibatch replays the GRU over all T
steps), with the implied full-step transitions/s.  JAX compared two
replays of the update, the whole net inside the scan ("monolithic") and
the batched trunk with only the core in the scan ("split"); the port has
the same two (``split_fns=None`` and ``make_split_fns(net)``), and its
trainer takes the split one for a GRU net, so both are timed under JAX's
names.  Each timing is the mean of ``REPS`` (5) calls after 2 warm-up
calls, each call ended by a device synchronisation.  One JSON line a
measurement.

Usage: python -m gymothelloenv_tpu_torch.scripts.profile_recurrent [T] [N]
       [--device=cuda]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from gymothelloenv_tpu_torch.scripts.tool import positional, setup
from gymothelloenv_tpu_torch.utils.profiling import force_sync

H = 512
MINI_BATCHES = (4, 2, 1)
REPS = 5


def time_calls(fn):
    """Seconds a call of ``fn``: 2 warm-up calls, then the mean of
    ``REPS``, each synchronised."""
    for _ in range(2):
        force_sync(fn())
    t0 = time.perf_counter()
    for _ in range(REPS):
        force_sync(fn())
    return (time.perf_counter() - t0) / REPS


def main(argv=None) -> list:
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig,
                                                    make_optimizer,
                                                    ppo_update_recurrent)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (make_network,
                                                           make_split_fns)
    from gymothelloenv_tpu_torch.train.self_play import (
        Draws, collect_rollout_recurrent, selfplay_init_recurrent)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    pos = positional(argv)
    T = int(pos[0]) if pos else 32
    N = int(pos[1]) if len(pos) > 1 else 1024

    env_cfg = EnvConfig(num_disk_as_reward=True)
    net = make_network(env_cfg, H, seed=0, device=dev, recurrent=True)
    draws = Draws(torch.Generator(dev).manual_seed(1))
    sp = selfplay_init_recurrent(net, env_cfg, N, H, draws)
    rows = []

    def collect():
        return collect_rollout_recurrent(net, sp, env_cfg, T, draws)

    dt_collect = time_calls(collect)
    rows.append({"what": "collect_recurrent", "T": T, "N": N,
                 "sec": round(dt_collect, 4),
                 "trans_per_sec": round(T * N / dt_collect)})
    print(json.dumps(rows[-1]), flush=True)

    _, rollout, h0, masks, boot = collect()
    for mb in MINI_BATCHES:
        cfg = PPOConfig(num_mini_batch=mb, num_updates=10)
        optimizer = make_optimizer(cfg, net.parameters())
        perms = [torch.randperm(N, generator=torch.Generator().manual_seed(
            2 + e)) for e in range(cfg.ppo_epochs)]
        for name, split_fns in (("monolithic", None),
                                ("split", make_split_fns(net))):
            def update():
                return ppo_update_recurrent(
                    net, optimizer, rollout, h0, masks, boot, cfg, perms,
                    split_fns=split_fns)["value_loss"]
            dt = time_calls(update)
            full = dt + dt_collect
            rows.append({"what": f"update_recurrent_{name}", "T": T,
                         "N": N, "mini_batch": mb, "sec": round(dt, 4),
                         "full_step_sec": round(full, 4),
                         "full_step_trans_per_sec": round(T * N / full)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
