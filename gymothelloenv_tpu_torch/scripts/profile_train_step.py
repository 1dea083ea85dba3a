"""Where one PPO self-play training update spends its time on the card.

Usage: python -m gymothelloenv_tpu_torch.scripts.profile_train_step \
    [num_envs] [num_steps]

Builds ``PPOSelfPlayTrainer`` at wide2 (width_mult 2, hidden 1024) with
the tuned recipe (lr 2.5e-4, entropy 0.01, 4 epochs x 4 minibatches),
runs one warm-up update, then traces one collection and one
``ppo_update`` with ``torch.profiler`` (``utils/profiling.traced_call``,
the kernels read from the written trace by ``summarize_trace``).  For
each phase it prints the wall seconds, the summed device time of its
kernels, the device's idle share (1 - device time / wall time, an upper
bound on idleness where kernels overlap), the kernel launches, and the
kernels with the most device time; for the collection also the kernels
a slot (launches over ``num_steps``) and the launches of the ply kernel
(``ops/step.py``: ``bit_step`` and ``reset_where``).  Float32 with TF32
off, as the trainer sets it.
"""

from __future__ import annotations

import sys
import tempfile

import torch

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig, ppo_update
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import step
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.self_play import collect_rollout
from gymothelloenv_tpu_torch.utils.device import describe, use_float32
from gymothelloenv_tpu_torch.utils.profiling import (report,
                                                     summarize_trace,
                                                     traced_call)


def _traced(name: str, fn) -> dict:
    """``fn()`` traced in a fresh directory and reported as ``name``."""
    with tempfile.TemporaryDirectory(prefix="torchtrace_") as trace_dir:
        _, wall = traced_call(fn, trace_dir)
        return report(name, summarize_trace(trace_dir), wall)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    num_envs = int(argv[0]) if len(argv) > 0 else 1024
    num_steps = int(argv[1]) if len(argv) > 1 else 64
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step traces the card; no CUDA "
                         "device is available")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {describe(dev)}; {use_float32()}; "
          f"N={num_envs}, T={num_steps}, wide2", flush=True)
    ppo_cfg = PPOConfig(lr=2.5e-4, entropy_coef=0.01, num_updates=2)
    trainer = PPOSelfPlayTrainer(
        EnvConfig(num_disk_as_reward=True), ppo_cfg,
        SelfPlayConfig(num_envs=num_envs, num_steps=num_steps,
                       hidden_size=1024, width_mult=2),
        log_fn=lambda step, m: None, device=dev)
    trainer.train(1)                       # warm-up: cuDNN, allocator
    results, rollout = {}, {}
    ply0 = (step.bit_step.launches, step.reset_where.launches)

    def collect():
        trainer.sp_state, rollout["roll"], rollout["boot"] = \
            collect_rollout(trainer.net, trainer.sp_state, trainer.env_cfg,
                            num_steps, trainer.draws)
    collect = results["collect"] = _traced("collect", collect)
    collect["ply_launches"] = (step.bit_step.launches - ply0[0],
                               step.reset_where.launches - ply0[1])
    print(f"[collect] {collect['launches'] / num_steps:.1f} kernels a slot "
          f"({num_steps} slots); the ply kernel: "
          f"{collect['ply_launches'][0]} bit_step and "
          f"{collect['ply_launches'][1]} reset_where launches", flush=True)
    words = draw_words(trainer.shuffle_generator, ppo_cfg.ppo_epochs)
    results["update"] = _traced("update", lambda: ppo_update(
        trainer.net, trainer.optimizer, rollout["roll"], rollout["boot"],
        words, ppo_cfg))
    return results


if __name__ == "__main__":
    main()
