"""Trace the full PPO train step (rollout collection and update) and print
the top kernels by device time — the port of ``scripts/trace_train_step.
py``, the collection-side companion of ``trace_update.py`` (whose
``capture``/``summarize`` it reuses).

The step is ``PPOSelfPlayTrainer``'s own (one collection of ``num_steps``
slots and one ``ppo_update``), at the default net, N games, disk-count
rewards; one warm-up step, then one traced.  Besides the table it prints
the ply kernel's launches in the traced step: the wrapper's count
(``ops/step.bit_step.launches``, one a batched ply) and the runs of
``bit_step_kernel`` in the trace, which must agree.

Usage: python -m gymothelloenv_tpu_torch.scripts.trace_train_step [N]
       [--bf16] [--device=cuda]
"""

from __future__ import annotations

import sys
import tempfile

from gymothelloenv_tpu_torch.scripts.tool import positional, setup
from gymothelloenv_tpu_torch.scripts.trace_update import capture, summarize
from gymothelloenv_tpu_torch.utils.profiling import (B1_KERNEL,
                                                     kernel_launches)


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops import step
    from gymothelloenv_tpu_torch.train.ppo_trainer import (
        PPOSelfPlayTrainer, SelfPlayConfig)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    bf16 = "--bf16" in argv
    pos = positional(argv)
    N = int(pos[0]) if pos else 4096

    trainer = PPOSelfPlayTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        ppo_cfg=PPOConfig(num_updates=10),
        run_cfg=SelfPlayConfig(num_envs=N, bf16=bf16),
        log_fn=lambda step, m: None, device=dev)
    trainer.ensure_initialized()
    launches = []

    def step_once():
        before = step.bit_step.launches
        metrics = trainer._collect_and_update(None)
        launches.append(step.bit_step.launches - before)
        return metrics["value_loss"]

    trace_dir = tempfile.mkdtemp(prefix="torchtrace_full_")
    _, wall = capture(step_once, (), trace_dir)
    print("trace dir:", trace_dir, flush=True)
    print(f"train step N={N} T={trainer.run_cfg.num_steps} bf16={bf16}: "
          f"wall {wall:.4f} s; B1 launches {launches[-1]}", flush=True)
    ops = summarize(trace_dir)
    return dict(trace_dir=trace_dir, wall_s=wall, ops=ops,
                b1_launches=launches[-1],
                b1_traced=kernel_launches(ops, B1_KERNEL))


if __name__ == "__main__":
    main()
