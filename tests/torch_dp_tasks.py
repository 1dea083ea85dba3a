"""The spawned ranks' tasks of ``tests/test_torch_dp_offpolicy.py`` and
``tests/test_torch_replay_shards.py`` (``parallel.dryrun.spawn`` runs them
by name in new processes).  They import the port alone, not JAX, so that a
rank starts in a few seconds; what they compare against comes from the
test modules, through the spawn's arguments."""

import os
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents import dqn as dqn_mod
from gymothelloenv_tpu_torch.agents import replay as rp
from gymothelloenv_tpu_torch.agents.replay import FIELDS
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    load_flax_params)
from gymothelloenv_tpu_torch.parallel import (dp, dryrun, make_mesh,
                                              replay_shards, sharding)
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.dqn_trainer import DQNTrainer
from gymothelloenv_tpu_torch.train.ppo_trainer import make_network

WORLD = 2
# tests/test_torch_replay_shards.py: S rings of PER rows, sampled in
# ROUNDS batches of BATCH slots; priority_a A_EXACT makes the refresh
# exact on both sides.
S, PER, BATCH, ROUNDS = 2, 64, 256, 150
CAP = 128
A_EXACT = 1.0
OFF = {"families": list(dryrun.OFF_POLICY), "updates": 2, "size": {}}
ON = {"families": list(dryrun.ON_POLICY), "updates": 1, "size": {}}
TP = {"size": {}}


def _port_dqn_injected(mesh, rec) -> dict:
    """The port's DQN trainer on ``mesh`` from JAX's params, with JAX's
    global draws sliced to this rank's games and JAX's sampled rows."""
    tr = DQNTrainer(*rec["port_cfgs"], log_fn=lambda *a: None, mesh=mesh)
    load_flax_params(tr.agent.net, rec["params0"])
    load_flax_params(tr.agent.target, rec["params0"])

    def ts(xs, dtype=None):
        return [torch.from_numpy(np.asarray(x, dtype=dtype)) for x in xs]
    tr.draws = sp.ShardedDraws(sp.InjectedDraws(
        colors=ts(rec["colors"]), uniforms=ts(rec["uniforms"]),
        rand_left=ts(rec["rand_left"]),
        legal_index=ts(rec["legal_index"]),
        replay_uniforms=ts(rec["replay_uniforms"])), mesh,
        tr.run_cfg.num_envs)
    taken = iter(ts(rec["idx"], np.int64))
    real = dqn_mod.replay_sample_idx
    dqn_mod.replay_sample_idx = lambda rb, cfg, u: next(taken)
    try:
        tr.train_chunk()
    finally:
        dqn_mod.replay_sample_idx = real
    size = int(tr.replay.size)
    return {"tree": flax_tree(tr.agent.net), "size": size,
            "write_pos": int(tr.replay.write_pos), "t": tr.agent.t,
            "rows": {f: getattr(tr.replay, f)[:size].clone()
                     for f in FIELDS}}


def _tp_checks(mesh) -> dict:
    """``TPPolicyNet`` against the whole net on one input: the forward,
    and the gradients of one loss, gathered over the model axis."""
    torch.manual_seed(0)
    net = make_network(EnvConfig(), 32, seed=3, device="cpu")
    x = torch.rand(6, 4, 8, 8)
    tp_net = dp.TPPolicyNet(net, mesh)
    outs = []
    for model in (net, tp_net):
        model.zero_grad()
        logits, value = model(x)
        ((logits * torch.arange(64.0)).sum() + value.square().sum()
         ).backward()
        outs.append((logits.detach(), value.detach()))
    split = sharding.policy_param_shardings(mesh, tp_net)
    whole = dict(net.named_parameters())
    grads = {}
    for name, p in tp_net.named_parameters():
        g = p.grad
        if split[name] is not None:
            parts = [torch.empty_like(g) for _ in range(mesh.model_parallel)]
            torch.distributed.all_gather(parts, g, group=mesh.model_group)
            g = torch.cat(parts, dim=split[name])
        grads[name] = (g - whole[name].grad).abs().max()
    sums = torch.tensor([float(mesh.model_rank + 1)])
    data = sums.clone()
    sharding.all_reduce_sum([sums], mesh, group="model")
    sharding.all_reduce_sum([data], mesh)
    return {"forward": max(float((a - b).abs().max()) for a, b in
                           zip(outs[0], outs[1])),
            "grads": max(float(g) for g in grads.values()),
            "model_sum": float(sums), "data_sum": float(data),
            "place": (mesh.rank, mesh.world, mesh.model_rank,
                      mesh.model_parallel)}


def offpolicy_cluster_task(mesh, device, args) -> dict:
    """One rank of ``tests/test_torch_dp_offpolicy.py``'s cluster; the
    JAX recording (``args["jax"]``), which the test module makes while
    the ranks start, is read last."""
    model = make_mesh(WORLD, model_parallel=2, backend=mesh.backend,
                      device=mesh.device)
    out = {
        "off": {1: dryrun.families_task(mesh, device, OFF),
                2: dryrun.families_task(model, device, OFF)},
        "on_model": dryrun.families_task(model, device,
                                         dict(ON, expert=args["expert"])),
        "pershard": dryrun.pershard_task(mesh, device, OFF),
        "tp": dryrun.tp_task(model, device, TP),
        "tp_checks": _tp_checks(model),
        "uniform": uniform_dqn(model, device),
    }
    out["jax_dqn"] = _port_dqn_injected(mesh, torch.load(
        _wait_for(args["jax"]), weights_only=False))
    return out


def _wait_for(path: str, timeout_s: float = 200.0) -> str:
    """``path`` once it exists (its writer renames it into place)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.1)
    return path


def uniform_dqn(mesh, device) -> dict:
    """Two chunks of the dryrun's DQN on a uniform ring (JAX's
    ``test_dqn_sharded_parity`` runs it on a model axis of 2): the
    state, as ``dryrun.state_of`` gives it."""
    tr = dryrun.build_off_policy("dqn", mesh, device, prioritized=False)
    for _ in range(2):
        tr.train_chunk()
    return dryrun.state_of("dqn", tr)


def _priorities() -> np.ndarray:
    """Heavy-tailed priorities (S, PER): the shards' totals differ."""
    return np.exp(np.random.default_rng(0).standard_normal(
        (S, PER))).astype(np.float32)


def _errors() -> np.ndarray:
    return np.abs(np.sin(np.arange(BATCH, dtype=np.float32)))


def _port_ring(shard: int, a: float = 0.6):
    """Shard ``shard``'s ring: ids ``shard * PER + [0, PER)``."""
    cfg = rp.ReplayConfig(capacity=CAP, prioritized=True, priority_a=a)
    rb = rp.replay_init(cfg, "cpu")
    z = torch.zeros((PER, 8, 8), dtype=torch.int8)
    t = torch.zeros(PER, dtype=torch.int8)
    ids = torch.arange(shard * PER, (shard + 1) * PER, dtype=torch.int32)
    rp.replay_insert(rb, cfg, z, t, ids, torch.zeros(PER), z, t,
                     torch.zeros(PER, dtype=torch.bool),
                     torch.ones(PER, dtype=torch.bool))
    rb.priority[:PER] = torch.from_numpy(_priorities()[shard])
    return rb, cfg


def shards_cluster_task(mesh, device, args) -> dict:
    """One rank: its ring, ROUNDS sharded samples from one seeded
    generator (the same on both ranks), then the refresh on JAX's
    indices and owners at both ``priority_a``."""
    rb, cfg = _port_ring(mesh.rank)
    draws = sp.Draws(torch.Generator().manual_seed(11))
    ids, owned = [], []
    for _ in range(ROUNDS):
        rows, _, own = replay_shards.sharded_sample(rb, cfg, BATCH, draws,
                                                    mesh)
        ids.append(rows[2].clone())
        owned.append(own.clone())
    out = {"ids": torch.stack(ids), "owned": torch.stack(owned)}
    for a in (0.6, A_EXACT):
        rb, cfg = _port_ring(mesh.rank, a)
        rec = args[str(a)]
        replay_shards.sharded_update_priorities(
            rb, cfg, torch.tensor(rec["idx"][mesh.rank]),
            torch.tensor(rec["owned"][mesh.rank]),
            torch.from_numpy(_errors()))
        out[str(a)] = {"priority": rb.priority.clone(),
                       "max_priority": rb.max_priority.clone(),
                       "size": int(replay_shards.global_size(rb, mesh))}
    return out
