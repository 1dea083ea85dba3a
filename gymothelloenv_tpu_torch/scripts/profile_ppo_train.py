"""Where the PPO self-play train step spends its time — the port of
``scripts/profile_ppo_train.py``.

Per N (256, 1024 and 4096 by default, or the N given): the collector
alone on the bit engine and on the plane engine forced on 8x8
(``force_plane``), the update alone, and the full step of a fresh
trainer (``PPOSelfPlayTrainer.train``) in float32 and with ``--bf16``'s
net, at the trainer's default recipe (default net, T ``--num-steps``,
64).  Each timing is the mean of ``profile_recurrent.REPS`` (5) calls
after 2 warm-up calls, each call ended by a device synchronisation.
Prints one JSON line a configuration under JAX's keys.

Usage: python -m gymothelloenv_tpu_torch.scripts.profile_ppo_train [N ...]
       [--num-steps=64] [--device=cuda]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from gymothelloenv_tpu_torch.scripts import profile_recurrent
from gymothelloenv_tpu_torch.scripts.profile_recurrent import time_calls
from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup
from gymothelloenv_tpu_torch.utils.profiling import force_sync

SIZES = (256, 1024, 4096)


def main(argv=None) -> list:
    from gymothelloenv_tpu_torch.agents.ppo import ppo_update
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.train.ppo_trainer import (
        PPOSelfPlayTrainer, SelfPlayConfig)
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         collect_rollout,
                                                         selfplay_init)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    sizes = [int(a) for a in positional(argv)] or list(SIZES)
    num_steps = int(flag(argv, "num-steps", "64"))
    rows = []
    for num_envs in sizes:
        run_cfg = SelfPlayConfig(num_envs=num_envs, num_steps=num_steps,
                                 test_interval=10 ** 9)
        tr = PPOSelfPlayTrainer(run_cfg=run_cfg, log_fn=lambda *a: None,
                                device=dev)
        T, N = run_cfg.num_steps, run_cfg.num_envs
        dt_ab, last = {}, {}
        for force_plane in (False, True):
            draws = Draws(torch.Generator(dev).manual_seed(7))
            sp = selfplay_init(tr.net, tr.env_cfg, N, draws,
                               force_plane=force_plane)

            def run_collect(sp=sp, draws=draws, fp=force_plane):
                last["out"] = collect_rollout(tr.net, sp, tr.env_cfg, T,
                                              draws, force_plane=fp)
                return last["out"][1].reward

            dt_ab[force_plane] = time_calls(run_collect)
        _, rollout, boot = last["out"]
        words = draw_words(torch.Generator().manual_seed(1),
                           tr.ppo_cfg.ppo_epochs)

        def run_update():
            return ppo_update(tr.net, tr.optimizer, rollout, boot, words,
                              tr.ppo_cfg)["value_loss"]

        dt_update = time_calls(run_update)
        dt_fulls = {}
        for bf16 in (False, True):
            tr2 = PPOSelfPlayTrainer(
                run_cfg=SelfPlayConfig(num_envs=num_envs,
                                       num_steps=num_steps,
                                       test_interval=10 ** 9,
                                       save_interval=10 ** 9, bf16=bf16),
                log_fn=lambda *a: None, device=dev)
            tr2.train(2, log_every=10 ** 9)       # warm-up
            iters = profile_recurrent.REPS
            t0 = time.perf_counter()
            tr2.train(iters, log_every=10 ** 9)
            force_sync(list(tr2.net.parameters()))
            dt_fulls[bf16] = (time.perf_counter() - t0) / iters
        steps = T * N
        rows.append({
            "num_envs": num_envs,
            "collect_bit_s": round(dt_ab[False], 5),
            "collect_plane_s": round(dt_ab[True], 5),
            "update_s": round(dt_update, 5),
            "full_s": round(dt_fulls[False], 5),
            "full_bf16_s": round(dt_fulls[True], 5),
            "collect_steps_per_s": round(steps / dt_ab[False]),
            "full_steps_per_s": round(steps / dt_fulls[False]),
            "full_bf16_steps_per_s": round(steps / dt_fulls[True]),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
