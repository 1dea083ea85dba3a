"""The 1-vs-N data-parallel gate — the port of ``__graft_entry__.py``'s
``dryrun_multichip`` for the on-policy families: each family runs whole
train steps at world 1 (in this process) and at world N (N spawned ranks
of a ``torch.distributed`` group) from the same seed; the ranks' params
must be equal to each other (replicated) and equal the world-1 params to
JAX's tolerance (``sharding.assert_tree_allclose``, rtol 5e-3, atol
1e-5), all finite.

Families: plain, time-limited and recurrent PPO, A2C, ACKTR, GAIL and
teacher-student PPO, at a small size.  The ranks are processes started
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

from gymothelloenv_tpu_torch.parallel.sharding import (assert_tree_allclose,
                                                       make_mesh,
                                                       shard_batch_tree)
from gymothelloenv_tpu_torch.utils.device import resolve_device

FAMILIES = ("ppo", "ppo_time_limited", "ppo_recurrent", "a2c", "acktr",
            "gail", "teacher_student")
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


def build(family: str, mesh, device, size: Size = SMALL,
          expert: str | None = None):
    """The family's trainer on ``mesh`` (``None``: no mesh)."""
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
    nets for teacher-student, the discriminator for GAIL) and for ACKTR
    its Kronecker factors and momenta (not the eigenvectors, whose signs
    and rotations in near-degenerate eigenspaces are arbitrary)."""
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
    """``updates`` train steps of the family; returns ``{"state",
    "metrics" (each step's, floats), "bit_step_launches" (the ply
    kernel's, on the card)}``."""
    from gymothelloenv_tpu_torch.ops.step import bit_step
    trainer = build(family, mesh, device, size, expert)
    launches = bit_step.launches
    metrics = []
    for _ in range(updates):
        if family == "teacher_student":
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


def dryrun_multichip(families=FAMILIES, world: int = 2,
                     backend: str = "gloo", device=None,
                     updates: int = 2, size: Size = SMALL,
                     timeout_s: float = 300.0, out=print) -> dict:
    """The gate for each of ``families``: world 1 here, world ``world``
    spawned (one cluster for all families), each on ``device`` (``None``:
    the current card, raising without one; ``"cpu"`` runs the gate on the
    CPU); raises ``AssertionError`` on a divergence, a non-replicated rank
    or a non-finite value.  Returns per family the largest absolute
    difference and the largest parameter change."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        expert = write_expert(os.path.join(tmp, "expert.npz"))
        args = {"families": list(families), "updates": updates,
                "size": dataclasses.asdict(size), "expert": expert}
        ranks = spawn(world, "gymothelloenv_tpu_torch.parallel.dryrun:"
                      "families_task", args, backend, device,
                      os.path.join(tmp, "cluster"), timeout_s)
        one = families_task(make_mesh(backend=backend, device=device),
                            device, args)
        init = {f: state_of(f, build(f, None, device, size, expert))
                for f in families}
    report = {}
    for fam in families:
        check_replicated([r[fam] for r in ranks])
        got, want = ranks[0][fam]["state"], one[fam]["state"]
        assert_tree_allclose(want, got, name=fam, require_finite=True)
        diff = max(float((got[k] - want[k]).abs().max()) for k in want)
        moved = max(float((want[k] - init[fam][k]).abs().max())
                    for k in want)
        report[fam] = {"max_abs_diff": diff, "max_param_change": moved}
        out(f"[dryrun] {fam}: world {world} = world 1, max abs diff "
            f"{diff:.3e} (largest change {moved:.3e}), {world} ranks "
            "replicated")
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
    p.add_argument("--updates", type=int, default=2)
    a = p.parse_args(argv)
    dryrun_multichip(a.families.split(","), a.world, a.backend, a.device,
                     a.updates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
