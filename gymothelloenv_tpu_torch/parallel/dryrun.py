"""The 1-vs-N parallel gate — the port of ``__graft_entry__.py``'s
``dryrun_multichip``: each family runs whole train steps at world 1 (in
this process) and at world N (N spawned ranks of a ``torch.distributed``
group) from the same seed; the ranks' params must be equal to each other
(replicated) and equal the world-1 params to JAX's tolerance
(``sharding.assert_tree_allclose``, rtol 5e-3, atol 1e-5), all finite.

Families (``FAMILIES``): plain, time-limited and recurrent PPO, A2C,
ACKTR, GAIL and teacher-student PPO (``ON_POLICY``), and DQN with PER
and Rainbow on the replicated replay (``OFF_POLICY``, whose state also
holds the replay's rows and priorities), at a small size, each on the
N x 1 mesh and the first N/m x m one the world allows (m in 2, 4); the
per-shard replay of both off-policy families, whose ring union must equal
the world-1 replicated ring after one chunk of ``PERSHARD_PLIES``
(``replay_shards.assert_ring_union_equal``); and PPO through
``parallel.dp.make_sharded_train_step`` on every mesh the world allows
(N x 1, N/2 x 2, N/4 x 4), its wide layers split over the model axis.
The ranks are processes started
here (``spawn``: ``python -m gymothelloenv_tpu_torch.parallel.dryrun
worker ...``), meeting at a ``file://`` rendezvous in their own
directory, each with a time limit: a rank that fails or outlives it fails
the gate, with its stderr.  ``spawn`` runs any ``module:function`` task
``fn(mesh, device, args) -> result`` on every rank and returns the ranks'
results (through ``torch.save`` files); ``rollout_task`` is
``ops.rollout.rollout_chunk_sharded`` on each rank's slice of one global
rollout state.

Usage:
    python -m gymothelloenv_tpu_torch.parallel.dryrun --world 2 \
        --backend gloo --device cpu
    python -m gymothelloenv_tpu_torch.parallel.dryrun --world 2 \
        --backend gloo --device cuda:0      # two ranks on one card
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.replay import ring_rows
from gymothelloenv_tpu_torch.parallel.sharding import (assert_tree_allclose,
                                                       make_mesh,
                                                       shard_batch_tree)
from gymothelloenv_tpu_torch.utils.device import resolve_device

ON_POLICY = ("ppo", "ppo_time_limited", "ppo_recurrent", "a2c", "acktr",
             "gail", "teacher_student")
OFF_POLICY = ("dqn", "rainbow")
FAMILIES = ON_POLICY + OFF_POLICY
# The per-shard gate's chunk (JAX's 12: shorter chunks leave the n-step
# FIFOs unfilled, so nothing would reach the rings).
PERSHARD_PLIES = 12
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Size:
    """A family's size: global games, slots an update, the net's fc width
    and trunk multiplier."""
    num_envs: int = 16
    num_steps: int = 8
    hidden_size: int = 32
    width_mult: int = 1


SMALL = Size()
# Teacher-student slots an update: enough for the first games to end.
TS_SLOTS = 32
# Adam's eps of the PPO optimizer (PPO, GAIL's policy, teacher-student):
# at PPOConfig's default 1e-5 a near-zero gradient entry steps by a good
# part of lr with a rounding-decided sign, and two GAIL or teacher-student
# updates no longer hold a world-N run to world 1 (the port's card-vs-CPU
# checks run at 1e-3 for that reason).
ADAM_EPS = 1e-3


def _run_cfg(size: Size, **kw):
    from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
    base = dict(num_envs=size.num_envs, num_steps=size.num_steps,
                hidden_size=size.hidden_size, width_mult=size.width_mult,
                num_test_games=4, test_interval=10 ** 9, seed=5)
    base.update(kw)
    return SelfPlayConfig(**base)


def write_expert(path: str, seed: int = 0, board_size: int = 8) -> str:
    """A small expert npz (``agents.gail.ExpertDataset``'s layout) of
    random planes and actions, enough to drive the discriminator."""
    rng = np.random.default_rng(seed)
    k, t, d = 6, 40, 4 * board_size * board_size
    np.savez(path, states=(rng.random((k, t, d)) < 0.3).astype(np.float32),
             actions=rng.integers(0, board_size ** 2, (k, t)),
             lengths=np.full(k, t, np.int64))
    return path


def build_off_policy(family: str, mesh, device, size: Size = SMALL,
                     pershard: bool = False, chunk_plies: int | None = None,
                     prioritized: bool = True):
    """JAX's ``_dryrun_dqn`` trainer: DQN with PER, double, dueling and
    2-step returns, or Rainbow at 11 atoms, a 1024-row ring, a minibatch
    of ``2 * num_envs`` and updates from the first transition;
    ``pershard``: the per-shard replay; ``prioritized=False``: a uniform
    ring (JAX's ``test_dqn_sharded_parity`` case on a model axis)."""
    from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
    from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
    from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                           DQNTrainer)
    from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
    n = size.num_envs
    run = DQNRunConfig(num_envs=n, chunk_plies=chunk_plies or size.num_steps,
                       init_rand_steps=2, seed=3, num_test_games=4,
                       test_interval=10 ** 9,
                       replay_sharding="per-shard" if pershard
                       else "replicated")
    rb = ReplayConfig(capacity=1024, prioritized=prioritized)
    env = EnvConfig(num_disk_as_reward=True)
    kw = dict(log_fn=lambda *a: None, mesh=mesh,
              device=None if mesh is not None else device)
    if family == "rainbow":
        return RainbowTrainer(env, RainbowConfig(
            batch_size=2 * n, initial_replay_size=1, n_step=2,
            num_atoms=11), rb, run, **kw)
    if family == "dqn":
        return DQNTrainer(env, DQNConfig(
            batch_size=2 * n, initial_replay_size=1, n_step=2, double=True,
            dueling=True), rb, run, **kw)
    raise ValueError(f"unknown off-policy family {family!r}; one of "
                     f"{OFF_POLICY}")


def build(family: str, mesh, device, size: Size = SMALL,
          expert: str | None = None):
    """The family's trainer on ``mesh`` (``None``: no mesh)."""
    if family in OFF_POLICY:
        return build_off_policy(family, mesh, device, size)
    from gymothelloenv_tpu_torch.agents.a2c import A2CConfig
    from gymothelloenv_tpu_torch.agents.kfac import ACKTRConfig
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train import teacher_student as ts
    from gymothelloenv_tpu_torch.train.a2c_trainer import A2CSelfPlayTrainer
    from gymothelloenv_tpu_torch.train.acktr_trainer import (
        ACKTRSelfPlayTrainer)
    from gymothelloenv_tpu_torch.train.gail_trainer import (GAILPPOTrainer,
                                                            GAILRunConfig)
    from gymothelloenv_tpu_torch.train.ppo_trainer import PPOSelfPlayTrainer
    env = EnvConfig(num_disk_as_reward=True)
    ppo = PPOConfig(lr=3e-4, entropy_coef=0.01, num_updates=10,
                    adam_eps=ADAM_EPS)
    kw = dict(log_fn=lambda *a: None, mesh=mesh,
              device=None if mesh is not None else device)
    if family == "ppo":
        return PPOSelfPlayTrainer(env, ppo, _run_cfg(size), **kw)
    if family == "ppo_time_limited":
        return PPOSelfPlayTrainer(env, ppo, _run_cfg(
            size, max_episode_plies=6), **kw)
    if family == "ppo_recurrent":
        return PPOSelfPlayTrainer(env, ppo, _run_cfg(size, recurrent=True),
                                  **kw)
    if family == "a2c":
        return A2CSelfPlayTrainer(A2CConfig(use_gae=True), env,
                                  _run_cfg(size, num_steps=5), **kw)
    if family == "acktr":
        return ACKTRSelfPlayTrainer(ACKTRConfig(t_inv=2), env,
                                    _run_cfg(size, num_steps=5), **kw)
    if family == "gail":
        return GAILPPOTrainer(
            expert_path=expert,
            gail_run=GAILRunConfig(gail_epoch=2, gail_batch_size=16,
                                   num_trajectories=3,
                                   subsample_frequency=2),
            env_cfg=env, ppo_cfg=ppo, run_cfg=_run_cfg(size), **kw)
    if family == "teacher_student":
        trainer = ts.TeacherStudentTrainer(
            env, ppo, ts.TeacherStudentConfig(
                num_envs=size.num_envs, num_steps=TS_SLOTS,
                hidden_size=size.hidden_size, width_mult=size.width_mult,
                num_test_games=4, test_interval=10 ** 9,
                teacher_test_interval=10 ** 9, save_interval=10 ** 9,
                seed=5), **kw)
        # Pay the teacher a fixed improvement (0.5) at each game's end,
        # with slots enough for games to end: with no evaluation, or no
        # game over, its rewards would all be 0, its advantages value noise
        # scaled up by a near-zero std, and the update would amplify any
        # rounding difference.
        trainer.win_avg = {"rand": 0.25, "greedy": 0.25}
        return trainer
    raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").clone()


def state_of(family: str, trainer) -> dict:
    """The family's trained state, CPU tensors by name: the params (both
    nets for teacher-student, the discriminator for GAIL), for ACKTR its
    Kronecker factors and momenta (not the eigenvectors, whose signs and
    rotations in near-degenerate eigenspaces are arbitrary), and for DQN
    and Rainbow the replay's packed rows (as int16) and priorities."""
    if family in OFF_POLICY:
        out = {f"net.{k}": _cpu(v)
               for k, v in trainer.agent.net.state_dict().items()}
        out["replay.rows"] = _cpu(ring_rows(trainer.replay)).to(torch.int16)
        out["replay.priority"] = _cpu(trainer.replay.priority[:-1])
        return out
    if family == "teacher_student":
        nets = {"teacher": trainer.net_t, "student": trainer.net_s}
    else:
        nets = {"net": trainer.net}
    out = {f"{n}.{k}": _cpu(v) for n, net in nets.items()
           for k, v in net.state_dict().items()}
    if family == "gail":
        out.update({f"disc.{k}": _cpu(v) for k, v in
                    trainer.gail_state.net.state_dict().items()})
    if family == "acktr":
        for name in ("kfac_actor", "kfac_critic"):
            for i, ls in enumerate(getattr(trainer.net, name).layers):
                for k in ("m_aa", "m_gg", "momentum"):
                    out[f"{name}.{i}.{k}"] = _cpu(getattr(ls, k))
    return out


def train_family(family: str, mesh, device, updates: int = 2,
                 size: Size = SMALL, expert: str | None = None) -> dict:
    """``updates`` train steps of the family (chunks for DQN and
    Rainbow); returns ``{"state", "metrics" (each step's, floats),
    "bit_step_launches" (the ply kernel's, on the card)}``."""
    from gymothelloenv_tpu_torch.ops.step import bit_step
    trainer = build(family, mesh, device, size, expert)
    launches = bit_step.launches
    metrics = []
    for _ in range(updates):
        if family in OFF_POLICY:
            m = trainer.train_chunk()
            trainer.chunk_count += 1
        elif family == "teacher_student":
            m = trainer.train_step()
            trainer.chunk_count += 1
        else:
            trainer.ensure_initialized()
            m = trainer._do_update()
            trainer.update_count += 1
        metrics.append({k: float(v) for k, v in m.items()
                        if not k.endswith("_seconds")})
    return {"state": state_of(family, trainer), "metrics": metrics,
            "bit_step_launches": bit_step.launches - launches}


def families_task(mesh, device, args: dict) -> dict:
    """``spawn`` task: ``train_family`` for each of ``args["families"]``."""
    size = Size(**args.get("size", {}))
    return {f: train_family(f, mesh, device, args.get("updates", 2), size,
                            args.get("expert"))
            for f in args["families"]}


def ring_of(trainer) -> dict:
    """A DQN or Rainbow trainer's ring: its packed rows (CPU) and live
    size, and ``t``."""
    return {"rows": _cpu(ring_rows(trainer.replay)),
            "size": int(trainer.replay.size), "t": int(trainer.agent.t)}


def pershard_task(mesh, device, args: dict) -> dict:
    """``spawn`` task: each of ``args["families"]`` (DQN, Rainbow) on the
    per-shard replay, one chunk of ``args.get("chunk_plies",
    PERSHARD_PLIES)`` plies, then a second that samples and trains
    through it; returns per family this rank's ring after the first
    chunk (``ring_of``), whether every param is finite after the second,
    and how many live priorities the updates moved off the insert-time
    maximum."""
    size = Size(**args.get("size", {}))
    out = {}
    for fam in args["families"]:
        tr = build_off_policy(fam, mesh, device, size, pershard=True,
                              chunk_plies=args.get("chunk_plies",
                                                   PERSHARD_PLIES))
        tr.train_chunk()
        ring = ring_of(tr)
        tr.train_chunk()
        rb = tr.replay
        live = rb.priority[:int(rb.size)]
        out[fam] = dict(ring=ring, finite=all(
            bool(torch.isfinite(p).all()) for p in tr.agent.net.parameters()),
            moved=int((live != rb.max_priority).sum()),
            model_rank=mesh.model_rank)
    return out


def replicated_ring(family: str, device, size: Size = SMALL,
                    chunk_plies: int = PERSHARD_PLIES) -> dict:
    """The per-shard gate's reference: one chunk of ``family`` at world 1
    on the replicated replay (``ring_of``)."""
    tr = build_off_policy(family, None, device, size,
                          chunk_plies=chunk_plies)
    tr.train_chunk()
    return ring_of(tr)


def check_pershard(name: str, ref: dict, ranks: list) -> None:
    """JAX's ``_check_pershard_rings``: the same ``t``, the union of the
    data shards' rings (``ranks``: each rank's ``pershard_task`` result
    for the family, in rank order; a data index's model ranks hold the
    same ring, so model index 0's stand for it) equal to the replicated
    ring, every param finite."""
    from gymothelloenv_tpu_torch.parallel.replay_shards import (
        assert_ring_union_equal)
    for r in ranks:
        assert r["ring"]["t"] == ref["t"] > 0, (name, r["ring"]["t"],
                                               ref["t"])
        assert r["finite"], name
    shards = [r["ring"] for r in ranks if r["model_rank"] == 0]
    assert_ring_union_equal(ref["rows"], ref["size"],
                            [r["rows"] for r in shards],
                            [r["size"] for r in shards], name=name)


def tp_task(mesh, device, args: dict) -> dict:
    """``spawn`` task: ``args.get("steps", 1)`` steps of
    ``parallel.dp.make_sharded_train_step`` (JAX's ``_dryrun_ppo``) on
    ``mesh``: the family's PPO net at ``args["size"]``, seeded, its games
    from a global ``selfplay_init`` placed on the mesh, the collector's
    draws sharded from one seeded generator, each step's shuffle words
    from another.  Returns the whole net's state (CPU), every clip's
    gradient norm and the steps' metrics."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.parallel.dp import (full_state_dict,
                                                     make_sharded_train_step)
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         ShardedDraws,
                                                         selfplay_init)
    size = Size(**args.get("size", {}))
    env = EnvConfig(num_disk_as_reward=True)
    ppo = PPOConfig(lr=3e-4, entropy_coef=0.01, num_updates=10,
                    adam_eps=ADAM_EPS,
                    max_grad_norm=args.get("max_grad_norm", 0.5))
    dev = mesh.device if mesh is not None else torch.device(device)
    train_step, place_params, place_sp = make_sharded_train_step(
        mesh, env, ppo, size.num_steps)
    net = make_network(env, size.hidden_size, size.width_mult, seed=5,
                       device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    sp = place_sp(selfplay_init(net, env, size.num_envs, Draws(gen),
                                device=dev))
    net, opt = place_params(net)
    draws = ShardedDraws(Draws(gen), mesh, size.num_envs)
    words = torch.Generator().manual_seed(7)
    norms, metrics = [], []
    step = opt.step

    def counted():
        step()
        norms.append(float(opt.last_norm))
    opt.step = counted
    for _ in range(args.get("steps", 1)):
        sp, m = train_step(net, opt, sp, draws,
                           draw_words(words, ppo.ppo_epochs))
        metrics.append({k: float(v) for k, v in m.items()})
    state = {f"net.{k}": _cpu(v)
             for k, v in full_state_dict(net, mesh).items()}
    return {"state": state, "norms": norms, "metrics": metrics}


def tp_init_state(device, size: Size = SMALL) -> dict:
    """``tp_task``'s net before its steps, CPU tensors by name."""
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    net = make_network(EnvConfig(num_disk_as_reward=True), size.hidden_size,
                       size.width_mult, seed=5, device=device)
    return {f"net.{k}": _cpu(v) for k, v in net.state_dict().items()}


def gate_task(mesh, device, args: dict) -> dict:
    """``spawn`` task of ``dryrun_multichip``: for each model axis ``m``
    of ``args["meshes"]`` (every rank makes the N/m x m mesh), the
    families (``families_task``) where ``m`` is in
    ``args["family_meshes"]``, the per-shard runs (``pershard_task``)
    likewise, and ``tp_task`` everywhere."""
    out = {}
    for m in args["meshes"]:
        here = mesh if m == 1 else make_mesh(
            n_devices=mesh.world, model_parallel=m, backend=mesh.backend,
            device=mesh.device)
        res = {"tp": tp_task(here, device, args["tp"])}
        if m in args["family_meshes"]:
            res["families"] = families_task(here, device, args["families"])
            if args.get("pershard"):
                res["pershard"] = pershard_task(here, device,
                                                args["pershard"])
        out[m] = res
    return out


def cluster_task(mesh, device, args: dict) -> dict:
    """``spawn`` task: ``families_task`` for each entry of
    ``args["runs"]`` (``{name: families_task args}``) and, with
    ``args["rollout"]``, ``rollout_task``."""
    out = {name: families_task(mesh, device, run)
           for name, run in args.get("runs", {}).items()}
    if args.get("rollout"):
        out["rollout"] = rollout_task(mesh, device, args["rollout"])
    return out


def rollout_init_state(num_games: int, seed: int, plies: int, device):
    """A global K1 state ``plies`` random plies from the opening (the
    plain version, so every rank builds the same one)."""
    from gymothelloenv_tpu_torch.ops import rollout as ro
    state, _ = ro.rollout_chunk_plain(ro.rollout_init(num_games, "cpu"),
                                      seed, plies)
    return ro.RolloutState(**{f.name: getattr(state, f.name).to(device)
                              for f in dataclasses.fields(state)})


def rollout_task(mesh, device, args: dict) -> dict:
    """``spawn`` task: ``rollout_chunk_sharded`` on this rank's slice of
    one global state (``rollout_init_state``); returns the rank's new
    state, the global episode count, the K1 launches and the chunk's
    ms (card only, ``utils.timing.call_ms`` of one chunk after a warm-up
    chunk)."""
    from gymothelloenv_tpu_torch.ops import rollout as ro
    from gymothelloenv_tpu_torch.utils.timing import call_ms
    n, steps, seed = args["num_games"], args["num_steps"], args["seed"]
    state = shard_batch_tree(mesh, rollout_init_state(n, seed + 1, 20,
                                                      device),
                             batch_size=n)
    ms = None
    if torch.device(device).type == "cuda":
        ms = call_ms(lambda: ro.rollout_chunk_sharded(state, seed, steps,
                                                      mesh), 1)
    ro.rollout_chunk.launches = 0
    new, episodes = ro.rollout_chunk_sharded(state, seed, steps, mesh)
    return {"state": {f.name: _cpu(getattr(new, f.name))
                      for f in dataclasses.fields(new)},
            "episodes": int(episodes), "launches": ro.rollout_chunk.launches,
            "ms": ms}


# --- processes --------------------------------------------------------------

def _resolve(task: str):
    module, name = task.split(":")
    return getattr(importlib.import_module(module), name)


def spawn(world: int, task: str, args: dict, backend: str = "gloo",
          device=None, out_dir: str | None = None,
          timeout_s: float = 300.0, env: dict | None = None) -> list:
    """Run ``task`` (``"module:function"``) on ``world`` new processes,
    ranks of one ``backend`` group meeting at a ``file://`` rendezvous in
    ``out_dir`` (a new temporary directory by default), each on
    ``device`` (``None``: the current card, raising without one; several
    gloo ranks may share one card; ``"cpu"`` for CPU ranks).  Returns the
    ranks' results in rank order.  A rank that exits non-zero, or a
    cluster that outlives ``timeout_s``, raises ``RuntimeError`` with the
    ranks' stderr; every process is stopped first."""
    device = str(resolve_device(device))
    own = out_dir is None
    out_dir = out_dir or tempfile.mkdtemp(prefix="dryrun_")
    os.makedirs(out_dir, exist_ok=True)
    args_path = os.path.join(out_dir, "args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    rendezvous = os.path.join(out_dir, "rendezvous")
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gymothelloenv_tpu_torch.parallel.dryrun",
             "worker", "--rank", str(rank), "--world", str(world),
             "--backend", backend, "--device", device, "--init",
             f"file://{rendezvous}", "--task", task, "--args", args_path,
             "--out", os.path.join(out_dir, f"rank{rank}.pt"),
             "--timeout", str(timeout_s)],
            stdout=log, stderr=subprocess.STDOUT, env=child_env))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{task} on {world} ranks outlived "
                                   f"{timeout_s:.0f} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad:
            raise RuntimeError(f"{task}: rank(s) {bad} exited with "
                               f"{[procs[r].returncode for r in bad]}")
    except RuntimeError as err:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {rank} ---\n{log.read()[-3000:]}")
        raise RuntimeError(f"{err}\n" + "\n".join(tails)) from None
    finally:
        for log in logs:
            log.close()
    results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    if own:
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
    return results


def worker_main(argv) -> int:
    """One rank: join the group, build the mesh, run the task, save its
    result, leave the group."""
    p = argparse.ArgumentParser(prog="dryrun worker")
    for flag in ("--rank", "--world"):
        p.add_argument(flag, type=int, required=True)
    for flag in ("--backend", "--device", "--init", "--task", "--args",
                 "--out"):
        p.add_argument(flag, required=True)
    p.add_argument("--timeout", type=float, default=300.0)
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(a.device))
    import torch.distributed as dist
    dist.init_process_group(a.backend, init_method=a.init,
                            world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=a.timeout))
    try:
        mesh = make_mesh(n_devices=a.world, backend=a.backend,
                         device=a.device)
        with open(a.args) as f:
            args = json.load(f)
        result = _resolve(a.task)(mesh, a.device, args)
        torch.save(result, a.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


# --- the gate ---------------------------------------------------------------

def check_replicated(results: list, key: str = "state") -> None:
    """Every rank's ``key`` tree equals rank 0's bit for bit."""
    for rank, res in enumerate(results[1:], start=1):
        for name, t in results[0][key].items():
            if not torch.equal(t, res[key][name]):
                raise AssertionError(f"rank {rank}'s {name} is not rank 0's")


def mesh_shapes(world: int) -> list:
    """The model axes of JAX's gate at ``world`` ranks: 1, and 2 and 4
    where they divide the world (the N/m x m meshes; m = N too, a 1 x N
    mesh, which JAX's gate, needing N > m, leaves out)."""
    return [1] + [m for m in (2, 4) if world % m == 0 and world >= m]


def dryrun_multichip(families=FAMILIES, world: int = 2,
                     backend: str = "gloo", device=None,
                     updates: int = 2, size: Size = SMALL,
                     timeout_s: float = 300.0, out=print) -> dict:
    """The gate (JAX ``dryrun_multichip``): world 1 here, world ``world``
    spawned (one cluster for everything), each on ``device`` (``None``:
    the current card, raising without one; ``"cpu"`` runs the gate on the
    CPU).  Each of ``families`` on the N x 1 mesh and the first N/m x m
    one (``mesh_shapes``), the ranks replicated and equal to world 1; the
    per-shard replay of the off-policy families among them on the same
    meshes, against the world-1 replicated ring; PPO through
    ``make_sharded_train_step`` on every mesh.  Raises
    ``AssertionError`` on a divergence, a non-replicated rank, a ring
    union that differs or a non-finite value.  Returns per run the
    largest absolute difference and the largest parameter change."""
    device = resolve_device(device)
    shapes = mesh_shapes(world)
    family_shapes = shapes[:2]
    off = [f for f in families if f in OFF_POLICY]
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        expert = write_expert(os.path.join(tmp, "expert.npz"))
        fam_args = {"families": list(families), "updates": updates,
                    "size": dataclasses.asdict(size), "expert": expert}
        tp_args = {"size": dataclasses.asdict(size)}
        args = {"meshes": shapes, "family_meshes": family_shapes,
                "families": fam_args, "tp": tp_args,
                "pershard": {"families": off,
                             "size": dataclasses.asdict(size)}
                if off else None}
        ranks = spawn(world, "gymothelloenv_tpu_torch.parallel.dryrun:"
                      "gate_task", args, backend, device,
                      os.path.join(tmp, "cluster"), timeout_s)
        one_mesh = make_mesh(backend=backend, device=device)
        one = families_task(one_mesh, device, fam_args)
        one_tp = tp_task(one_mesh, device, tp_args)
        rings = {f: replicated_ring(f, device, size) for f in off}
        init = {f: state_of(f, build(f, None, device, size, expert))
                for f in families}
    report = {}

    def compare(name, runs, want, init_state):
        check_replicated(runs)
        got = runs[0]["state"]
        assert_tree_allclose(want, got, name=name, require_finite=True)
        diff = max(float((got[k].double() - want[k].double()).abs().max())
                   for k in want)
        moved = max(float((want[k].double() - init_state[k].double())
                          .abs().max()) for k in init_state
                    if k in want and want[k].is_floating_point())
        report[name] = {"max_abs_diff": diff, "max_param_change": moved}
        out(f"[dryrun] {name}: world {world} = world 1, max abs diff "
            f"{diff:.3e} (largest change {moved:.3e}), ranks replicated")

    tp_init = tp_init_state(device, size)
    for m in shapes:
        shape = f"{world // m}x{m}"
        compare(f"ppo_tp[{shape}]", [r[m]["tp"] for r in ranks],
                one_tp["state"], tp_init)
        if m not in family_shapes:
            continue
        for fam in families:
            compare(f"{fam}[{shape}]", [r[m]["families"][fam]
                                        for r in ranks],
                    one[fam]["state"], init[fam])
        for fam in off:
            name = f"{fam}+per-shard[{shape}]"
            check_pershard(name, rings[fam],
                           [r[m]["pershard"][fam] for r in ranks])
            report[name] = {"rows": rings[fam]["size"]}
            out(f"[dryrun] {name}: ring union = the replicated ring "
                f"({rings[fam]['size']} rows), params finite")
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "worker":
        return worker_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.parallel.dryrun")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--updates", type=int, default=2)
    a = p.parse_args(argv)
    dryrun_multichip(a.families.split(","), a.world, a.backend, a.device,
                     a.updates, timeout_s=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
