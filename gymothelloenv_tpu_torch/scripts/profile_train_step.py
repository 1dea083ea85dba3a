"""Where one PPO self-play training update spends its time on the card.

Usage: python -m gymothelloenv_tpu_torch.scripts.profile_train_step \
    [num_envs] [num_steps]

Builds ``PPOSelfPlayTrainer`` at wide2 (width_mult 2, hidden 1024) with
the tuned recipe (lr 2.5e-4, entropy 0.01, 4 epochs x 4 minibatches),
runs one warm-up update, then traces one collection and one
``ppo_update`` with ``torch.profiler`` (CPU and CUDA activities).  For
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
import time

import torch
from torch.profiler import ProfilerActivity, profile

from gymothelloenv_tpu_torch.agents.ppo import PPOConfig, ppo_update
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import step
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.self_play import collect_rollout
from gymothelloenv_tpu_torch.utils.device import use_float32


def device_us(event) -> float:
    """A profiler event's own device time in us (0 without one)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _report(name: str, prof, wall_s: float, top: int = 8) -> dict:
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        # Kernels folded into the operators that launched them: an
        # operator's self device time is its own kernels' time.
        events = [e for e in averages if device_us(e) > 0]
    device_s = sum(device_us(e) for e in events) / 1e6
    launches = sum(e.count for e in events)
    idle = 1.0 - device_s / wall_s if wall_s > 0 else float("nan")
    print(f"[{name}] wall {wall_s:.4f} s, device {device_s:.4f} s in "
          f"{launches} kernels, device idle share {100 * idle:.1f}%",
          flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        print(f"[{name}]   {device_us(e) / 1e3:9.3f} ms  x{e.count:6d}  "
              f"{e.key[:90]}", flush=True)
    return dict(wall_s=wall_s, device_s=device_s, launches=launches,
                idle_share=idle)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    num_envs = int(argv[0]) if len(argv) > 0 else 1024
    num_steps = int(argv[1]) if len(argv) > 1 else 64
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step traces the card; no CUDA "
                         "device is available")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {torch.cuda.get_device_name(dev)}; {use_float32()}; "
          f"N={num_envs}, T={num_steps}, wide2", flush=True)
    ppo_cfg = PPOConfig(lr=2.5e-4, entropy_coef=0.01, num_updates=2)
    trainer = PPOSelfPlayTrainer(
        EnvConfig(num_disk_as_reward=True), ppo_cfg,
        SelfPlayConfig(num_envs=num_envs, num_steps=num_steps,
                       hidden_size=1024, width_mult=2),
        log_fn=lambda step, m: None, device=dev)
    trainer.train(1)                       # warm-up: cuDNN, allocator
    results = {}
    ply0 = (step.bit_step.launches, step.reset_where.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer.sp_state, rollout, boot = collect_rollout(
            trainer.net, trainer.sp_state, trainer.env_cfg, num_steps,
            trainer.draws)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    collect = results["collect"] = _report("collect", prof, wall)
    collect["ply_launches"] = (step.bit_step.launches - ply0[0],
                               step.reset_where.launches - ply0[1])
    print(f"[collect] {collect['launches'] / num_steps:.1f} kernels a slot "
          f"({num_steps} slots); the ply kernel: "
          f"{collect['ply_launches'][0]} bit_step and "
          f"{collect['ply_launches'][1]} reset_where launches", flush=True)
    words = draw_words(trainer.shuffle_generator, ppo_cfg.ppo_epochs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ppo_update(trainer.net, trainer.optimizer, rollout, boot, words,
                   ppo_cfg)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    results["update"] = _report("update", prof, wall)
    return results


if __name__ == "__main__":
    main()
