"""Weak scaling of the sharded PPO train step — the port of
``scripts/bench_scaling.py``.

The step is ``parallel/dp.make_sharded_train_step``'s (one collection of
``num-steps`` slots on this rank's games and one ``ppo_update`` of the
global batch) at the default net, ``per-device-envs`` games a rank, timed
over ``reps`` chained steps after one warm-up, ended by a device
synchronisation.  World 1 runs on rank 0 alone before any process group
exists (its mesh has no group, so its collectives are the identity);
then, under ``torchrun --nproc-per-node W``, every rank joins the group
(``parallel/multihost.initialize`` over ``--backend``) and the step runs
on the world-W mesh with W times the games.  Rank 0 prints a line a
world and the weak-scaling efficiency, rate(W) / (W rate(1)).  Without
``torchrun`` (a world of 1) it prints JAX's "single device only" line.
Ranks sharing one card (``--backend gloo``, ``--device cuda:0``) measure
the mechanics, not the speed of separate cards.

Usage:
    python -m gymothelloenv_tpu_torch.scripts.bench_scaling \
        [per-device-envs] [num-steps] [--backend=nccl] [--device=cuda]
    torchrun --standalone --nproc-per-node 2 -m \
        gymothelloenv_tpu_torch.scripts.bench_scaling 128 16
"""

from __future__ import annotations

import os
import sys
import time

import torch

from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup
from gymothelloenv_tpu_torch.utils.device import resolve_device
from gymothelloenv_tpu_torch.utils.profiling import force_sync


def measure(mesh, per_device_envs: int, num_steps: int,
            reps: int = 5) -> float:
    """Transitions a second of the sharded step on ``mesh``; rank 0
    prints the world's line."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.parallel.dp import make_sharded_train_step
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         ShardedDraws,
                                                         selfplay_init)
    env_cfg = EnvConfig(num_disk_as_reward=True)
    ppo_cfg = PPOConfig(num_updates=100)
    train_step, place_params, place_sp = make_sharded_train_step(
        mesh, env_cfg, ppo_cfg, num_steps)
    num_envs = per_device_envs * mesh.world
    net = make_network(env_cfg, seed=0, device=mesh.device)
    gen = torch.Generator(mesh.device).manual_seed(0)
    sp = place_sp(selfplay_init(net, env_cfg, num_envs, Draws(gen),
                                device=mesh.device))
    net, opt = place_params(net)
    draws = ShardedDraws(Draws(gen), mesh, num_envs)
    words = torch.Generator().manual_seed(1)
    state = {"sp": sp}

    def step():
        state["sp"], metrics = train_step(
            net, opt, state["sp"], draws,
            draw_words(words, ppo_cfg.ppo_epochs))
        return metrics

    force_sync(step())
    t0 = time.perf_counter()
    for _ in range(reps):
        m = step()
    force_sync(m)
    dt = (time.perf_counter() - t0) / reps
    rate = num_envs * num_steps / dt
    if mesh.process_rank == 0:
        print(f"{mesh.world} device(s): {num_envs} envs x {num_steps} "
              f"slots -> {dt * 1e3:8.1f} ms/update, {rate / 1e3:8.1f}K "
              f"transitions/s", flush=True)
    return rate


def main(argv=None) -> dict:
    import torch.distributed as dist
    from gymothelloenv_tpu_torch.parallel import multihost
    from gymothelloenv_tpu_torch.parallel.sharding import make_mesh

    argv = sys.argv[1:] if argv is None else argv
    backend = flag(argv, "backend", "nccl")
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = (setup(argv) if rank == 0
           else resolve_device(flag(argv, "device", "cuda")))
    pos = positional(argv)
    per_device = int(pos[0]) if pos else 128
    num_steps = int(pos[1]) if len(pos) > 1 else 16
    out = {}
    if rank == 0:
        out[1] = measure(make_mesh(backend=backend, device=dev), per_device,
                         num_steps)
    if world == 1:
        print("single device only; scaling efficiency n/a", flush=True)
        return out
    multihost.initialize(backend=backend)
    try:
        device = None if backend == "nccl" else dev
        out[world] = measure(make_mesh(backend=backend, device=device),
                             per_device, num_steps)
        if rank == 0:
            eff = out[world] / (out[1] * world)
            print(f"weak-scaling efficiency 1 -> {world} devices: "
                  f"{eff:.1%}", flush=True)
            out["efficiency"] = eff
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
