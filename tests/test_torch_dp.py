"""The port's data-parallel training (``parallel/``, the ``mesh=`` of the
on-policy trainers, ``ops.rollout.rollout_chunk_sharded``) on the CPU.

One gloo cluster of two ranks is spawned for the module (as JAX's
``tests/test_multihost.py`` shares ``cluster_outs``), through
``parallel.dryrun.spawn`` with a ``file://`` rendezvous in a temporary
directory and a time limit.  Each rank runs ``_cluster_task`` below:

  * two updates of every family of ``parallel.dryrun.ON_POLICY`` (plain,
    time-limited and recurrent PPO, A2C, ACKTR, GAIL, teacher-student);
    world 2 must equal world 1 (run here) to JAX's gate, rtol 5e-3 and
    atol 1e-5 (``assert_tree_allclose``), and tighter, each leaf within
    1e-3 of the family's largest parameter change; the ranks' states
    equal rank 0's broadcast bit for bit;
  * PPO from JAX's initial params with JAX's collector draws and shuffle
    words injected (recorded from JAX's trainer on ``make_mesh(2)`` over
    the suite's virtual CPU devices, ``io_callback`` in program order):
    the port's world-2 params equal JAX's to rtol 5e-3, atol 1e-5 (Adam
    at eps 1e-3 on both sides, as the port's other whole-update
    comparisons, for the reason their docstrings give);
  * ``rollout_chunk_sharded``: each rank's state equals
    ``rollout_chunk_plain`` on its slice at ``seed + rank * 7919``, one
    K1 call a rank, the episode count the sum;
  * the trainer's ``train`` with a checkpoint path: rank 0 alone logs
    and writes, and its checkpoint equals a world-1 run's;
  * the collectives' helpers (``assemble_global``, ``all_reduce_mean``,
    ``host_batch_slice``) and ``make_mesh``'s refusal of another backend.

The guards of the multi-device off-policy paths and of the model axis
refuse what JAX's refuse, with JAX's messages
(``test_mesh_guards_refuse_as_jax``); the paths themselves are
``tests/test_torch_dp_offpolicy.py``'s and
``tests/test_torch_replay_shards.py``'s."""

import contextlib
import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.parallel import make_mesh as jax_make_mesh
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import dqn_train, rainbow_train
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    load_flax_params)
from gymothelloenv_tpu_torch.ops import rollout as ro
from gymothelloenv_tpu_torch.parallel import (assemble_global,
                                              assert_tree_allclose,
                                              host_batch_slice, initialize,
                                              make_mesh, replicated,
                                              shard_batch_axes,
                                              shard_batch_tree)
from gymothelloenv_tpu_torch.parallel import dryrun, multihost, sharding
from gymothelloenv_tpu_torch.train import ppo_trainer as ptrainer
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
ROLLOUT = dict(num_games=64, num_steps=40, seed=3)
JN, JT = 16, 8                    # the JAX comparison's games and slots
KEYS = (0, 1)                     # its updates' shuffle keys
JAX_PPO = dict(lr=3e-4, adam_eps=1e-3, num_updates=10)
TRAIN = dict(num_envs=16, num_steps=4, hidden_size=16, num_test_games=4,
             test_interval=2, save_interval=10 ** 6, seed=9)


def _jax_cfgs():
    run = dict(num_envs=JN, num_steps=JT, hidden_size=32, num_test_games=4,
               test_interval=10 ** 6, seed=7)
    return jppo_trainer.SelfPlayConfig(**run), SelfPlayConfig(**run)


def _jax_record():
    """JAX's PPO trainer on ``make_mesh(2)`` through two updates with
    every collector draw recorded: ``(initial params, draws, words, final
    params, metrics)``."""
    uniforms, resets = [], []
    real_sample, real_reset = jdist.MaskedCategorical.sample, jsp.reset_done

    def sample(self, key):
        u = 1.0 - jax.random.uniform(key, self.logits.shape[:-1])
        io_callback(lambda u: uniforms.append(np.array(u)), None, u,
                    ordered=True)
        return real_sample(self, key)

    def reset_done(*args, **kwargs):
        out = real_reset(*args, **kwargs)
        io_callback(lambda pc: resets.append(np.array(pc)), None, out[2],
                    ordered=True)
        return out
    jdist.MaskedCategorical.sample = sample
    jsp.reset_done = reset_done
    try:
        jrun, _ = _jax_cfgs()
        tr = jppo_trainer.PPOSelfPlayTrainer(
            JaxEnvConfig(num_disk_as_reward=True),
            JaxPPOConfig(**JAX_PPO), jrun, log_fn=lambda *a: None,
            mesh=jax_make_mesh(WORLD))
        params0 = jax.tree.map(np.array, tr.params)
        tr.ensure_initialized()
        jax.effects_barrier()
        colors0 = np.array(tr.sp_state.pcolor)
        metrics = []
        for k in KEYS:
            metrics.append({n: float(v) for n, v in
                            tr._do_update(jax.random.PRNGKey(k)).items()})
            jax.effects_barrier()
    finally:
        jdist.MaskedCategorical.sample = real_sample
        jsp.reset_done = real_reset
    words = [np.stack([np.asarray(jax.random.bits(k, (4,), np.uint32))
                       for k in jax.random.split(jax.random.PRNGKey(key),
                                                 4)]).astype(np.int64)
             for key in KEYS]
    return dict(params0=params0, colors=[colors0] + resets,
                uniforms=uniforms, words=words,
                params=jax.tree.map(np.array, tr.params), metrics=metrics)


def _port_ppo_injected(mesh, device, rec) -> dict:
    """The port's PPO trainer on ``mesh`` from JAX's params, with JAX's
    global draws sliced to this rank's games."""
    _, run = _jax_cfgs()
    tr = PPOSelfPlayTrainer(EnvConfig(num_disk_as_reward=True),
                            PPOConfig(**JAX_PPO), run,
                            log_fn=lambda *a: None, mesh=mesh)
    load_flax_params(tr.net, rec["params0"])
    tr.draws = sp.ShardedDraws(sp.InjectedDraws(
        colors=[torch.from_numpy(c) for c in rec["colors"]],
        uniforms=[torch.from_numpy(u) for u in rec["uniforms"]]),
        mesh, JN)
    words = iter(rec["words"])
    metrics = []
    draw_words = ptrainer.draw_words
    ptrainer.draw_words = lambda g, rows: torch.from_numpy(next(words))
    try:
        tr.ensure_initialized()
        for _ in KEYS:
            metrics.append({k: float(v) for k, v in tr._do_update().items()})
    finally:
        ptrainer.draw_words = draw_words
    return {"tree": flax_tree(tr.net), "metrics": metrics,
            "pcolor": tr.sp_state.pcolor.clone()}


def _rollout_counted(mesh, device, args) -> dict:
    """``dryrun.rollout_task`` with the K1 wrapper's calls counted."""
    calls = []
    real = ro.rollout_chunk

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    ro.rollout_chunk = counted
    try:
        out = dryrun.rollout_task(mesh, device, args)
    finally:
        ro.rollout_chunk = real
    out["calls"] = len(calls)
    return out


def _train_with_checkpoint(mesh, device, path) -> dict:
    """Two updates of ``train`` with a checkpoint and an evaluation; what
    this rank logged."""
    logged = []
    tr = PPOSelfPlayTrainer(EnvConfig(num_disk_as_reward=True),
                            PPOConfig(lr=3e-4, num_updates=4),
                            SelfPlayConfig(**TRAIN),
                            log_fn=lambda s, m: logged.append((s, m)),
                            mesh=mesh, device=None if mesh else device)
    tr.train(2, log_every=1, checkpoint_path=path)
    return {"logged": logged}


def _cluster_task(mesh, device, args) -> dict:
    out = {"families": dryrun.families_task(mesh, device, args["families"])}
    out["replicated"] = {
        fam: all(torch.equal(t, replicated(t, mesh))
                 for t in res["state"].values())
        for fam, res in out["families"].items()}
    out["rollout"] = _rollout_counted(mesh, device, ROLLOUT)
    out["jax_ppo"] = _port_ppo_injected(mesh, device, torch.load(
        args["jax"], weights_only=False))
    out["train"] = _train_with_checkpoint(mesh, device, args["checkpoint"])
    ranks = torch.full((2, 3), float(mesh.rank))
    out["gathered"] = assemble_global(mesh, ranks)
    out["mean"] = sharding.all_reduce_mean([torch.tensor([mesh.rank * 4.0,
                                                          1.0])], mesh)[0]
    out["slice"] = host_batch_slice(64)
    out["slice_mesh"] = host_batch_slice(64, mesh)
    try:
        make_mesh(backend="nccl", device="cuda:0")
        out["nccl_refused"] = ""
    except ValueError as err:
        out["nccl_refused"] = str(err)
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The jax recording, then one world-2 gloo cluster on the CPU."""
    tmp = tmp_path_factory.mktemp("dp")
    rec = _jax_record()
    torch.save(rec, tmp / "jax.pt")
    expert = dryrun.write_expert(str(tmp / "expert.npz"))
    fam_args = {"families": list(dryrun.ON_POLICY), "updates": 2,
                "size": {}, "expert": expert}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, env.get("PYTHONPATH", "")])
    ranks = dryrun.spawn(
        WORLD, "test_torch_dp:_cluster_task",
        {"families": fam_args, "jax": str(tmp / "jax.pt"),
         "checkpoint": str(tmp / "ck_{step}.msgpack")},
        backend="gloo", device="cpu", out_dir=str(tmp / "cluster"),
        timeout_s=240, env=env)
    return dict(ranks=ranks, rec=rec, fam_args=fam_args, tmp=tmp)


@pytest.fixture(scope="module")
def world1(cluster):
    """Each family's two updates at world 1 (a mesh without a group)."""
    return dryrun.families_task(make_mesh(backend="gloo", device="cpu"),
                                "cpu", cluster["fam_args"])


@pytest.mark.parametrize("family", dryrun.ON_POLICY)
def test_world2_equals_world1(cluster, world1, family):
    got = cluster["ranks"][0]["families"][family]
    want = world1[family]
    assert_tree_allclose(want["state"], got["state"], name=family,
                         require_finite=True)
    init = dryrun.state_of(family, dryrun.build(
        family, None, "cpu", expert=cluster["fam_args"]["expert"]))
    moved = max(float((want["state"][k] - init[k]).abs().max())
                for k in init)
    assert moved > 1e-3
    for k in want["state"]:
        diff = float((got["state"][k] - want["state"][k]).abs().max())
        assert diff <= 1e-3 * moved, (k, diff, moved)
    for m_got, m_want in zip(got["metrics"], want["metrics"]):
        assert set(m_got) == set(m_want)
        for k in m_want:
            assert m_got[k] == pytest.approx(m_want[k], rel=1e-3,
                                             abs=1e-5), k


@pytest.fixture(scope="module")
def no_mesh(cluster):
    """Each family's two updates without a mesh (``mesh=None``)."""
    return dryrun.families_task(None, "cpu", cluster["fam_args"])


@pytest.mark.parametrize("family", dryrun.ON_POLICY)
def test_world1_mesh_equals_no_mesh(cluster, world1, no_mesh, family):
    """The mesh path at world 1 computes ``mesh=None``'s update: its
    moments and means are the same function in another arithmetic
    (float64 advantage moments, sums over a given count), so the two
    agree to the last bits, each leaf within 1e-5 of the family's
    largest change."""
    got, want = world1[family]["state"], no_mesh[family]["state"]
    init = dryrun.state_of(family, dryrun.build(
        family, None, "cpu", expert=cluster["fam_args"]["expert"]))
    moved = max(float((want[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-3
    for k in want:
        diff = float((got[k] - want[k]).abs().max())
        assert diff <= 1e-5 * moved, (k, diff, moved)


def test_ranks_stay_replicated(cluster):
    for rank in cluster["ranks"]:
        assert all(rank["replicated"].values()), rank["replicated"]
    dryrun.check_replicated([r["families"]["ppo"] for r in
                             cluster["ranks"]])


def test_ppo_world2_equals_jax_mesh2(cluster):
    rec = cluster["rec"]
    got = [r["jax_ppo"] for r in cluster["ranks"]]
    np.testing.assert_array_equal(
        torch.cat([g["pcolor"] for g in got]).numpy(),
        np.asarray(rec["colors"][-1]))
    assert_tree_allclose(rec["params"], got[0]["tree"], name="ppo vs jax",
                         require_finite=True)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(rec["params"]), jax.tree.leaves(rec["params0"])))
    assert moved > 1e-3
    for m_got, m_want in zip(got[0]["metrics"], rec["metrics"]):
        for k in ("value_loss", "action_loss", "entropy", "episodes"):
            assert m_got[k] == pytest.approx(m_want[k], rel=1e-3,
                                             abs=1e-5), k


def test_rollout_chunk_sharded_equals_slices(cluster):
    n = ROLLOUT["num_games"]
    state = dryrun.rollout_init_state(n, ROLLOUT["seed"] + 1, 20, "cpu")
    total = 0
    for rank, res in enumerate(cluster["ranks"]):
        out = res["rollout"]
        assert out["calls"] == 1
        mine = ro.RolloutState(**{k: v[rank * n // 2:(rank + 1) * n // 2]
                                  for k, v in dataclasses.asdict(
                                      state).items()})
        want, eps = ro.rollout_chunk_plain(
            mine, ROLLOUT["seed"] + rank * ro.RANK_SEED_STRIDE,
            ROLLOUT["num_steps"])
        for k in ("cur", "opp", "legal"):
            assert torch.equal(out["state"][k], getattr(want, k)), k
        total += int(eps)
    assert total > 0
    assert [r["rollout"]["episodes"] for r in cluster["ranks"]] == \
        [total] * WORLD


def test_rank0_alone_logs_and_checkpoints(cluster, tmp_path):
    r0, r1 = (r["train"]["logged"] for r in cluster["ranks"])
    assert r1 == [] and [s for s, _ in r0] == [1, 2, 2]
    assert "win%(rand)" in r0[-1][1]
    ck = str(cluster["tmp"] / "ck_2.msgpack")
    assert os.path.exists(ck)
    ref = _train_with_checkpoint(None, "cpu", str(tmp_path / "c_{step}"))
    step, params, opt, _ = load_checkpoint(ck)
    wstep, wparams, wopt, _ = load_checkpoint(str(tmp_path / "c_2"))
    assert step == wstep == 2
    assert_tree_allclose(wparams, params, name="checkpoint params")
    assert_tree_allclose(wopt["1"]["0"]["mu"], opt["1"]["0"]["mu"],
                         rtol=5e-3, atol=1e-6, name="adam mu")
    # The world-1 run's own log: the same steps and evaluation.
    assert [s for s, _ in ref["logged"]] == [1, 2, 2]
    assert r0[-1][1] == ref["logged"][-1][1]


def test_collective_helpers(cluster):
    r0, r1 = cluster["ranks"]
    want = torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2)
    assert torch.equal(r0["gathered"], want)
    assert torch.equal(r1["gathered"], want)
    assert torch.equal(r0["mean"], torch.tensor([2.0, 1.0]))
    assert (r0["slice"], r1["slice"]) == ((32, 0), (32, 32))
    assert r1["slice_mesh"] == (32, 32)
    assert "runs 'gloo', not the 'nccl'" in r0["nccl_refused"]


def test_sharding_of_trees_without_a_group():
    mesh = sharding.DataMesh(rank=1, world=2, device=torch.device("cpu"),
                             backend="gloo")
    tree = {"a": torch.arange(8), "b": [torch.zeros(3, 8), torch.ones(())],
            "c": torch.arange(4)}
    got = shard_batch_tree(mesh, tree, axis=0, batch_size=8)
    assert torch.equal(got["a"], torch.arange(4, 8))
    assert got["b"][0].shape == (3, 8) and got["c"].shape == (4,)
    got = shard_batch_axes(mesh, tree, (8,))
    assert got["b"][0].shape == (3, 4) and torch.equal(got["a"],
                                                       torch.arange(4, 8))
    assert mesh.shard(8) == (4, 4)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(7)
    with pytest.raises(AssertionError, match="non-finite"):
        assert_tree_allclose({"x": torch.ones(2)},
                             {"x": torch.tensor([1.0, float("nan")])},
                             require_finite=True)
    with pytest.raises(AssertionError, match="1-vs-N divergence"):
        assert_tree_allclose([torch.ones(2)], [torch.ones(2) * 1.01])


def test_make_mesh_and_initialize_without_a_group():
    assert initialize(backend="gloo") is False     # one process: no-op
    mesh = make_mesh(backend="gloo", device="cpu")
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)
    t = torch.tensor([3.0])
    assert torch.equal(replicated(t, mesh), t)
    assert multihost.make_pod_mesh(backend="gloo", device="cpu") == mesh
    with pytest.raises(ValueError, match="backend must be"):
        make_mesh(backend="mpi")
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="nccl ranks run on a card"):
        make_mesh(backend="nccl", device="cpu")


def test_trainers_check_the_mesh():
    mesh = make_mesh(backend="gloo", device="cpu")
    run = SelfPlayConfig(num_envs=6, num_steps=2, hidden_size=8)
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        PPOSelfPlayTrainer(run_cfg=run, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        PPOSelfPlayTrainer(run_cfg=run, mesh=mesh, device="cuda")
    two = dataclasses.replace(mesh, world=2)
    with pytest.raises(ValueError, match="does not split over 4"):
        PPOSelfPlayTrainer(run_cfg=run, mesh=dataclasses.replace(
            mesh, world=4))
    tr = PPOSelfPlayTrainer(run_cfg=run, mesh=mesh)
    assert tr.device == torch.device("cpu") and tr.local_envs == 6
    assert two.shard(6) == (3, 0)


def _guard_cases():
    """The guards of JAX's multi-device off-policy paths, each as ``(JAX
    call, port call)``; both must raise the same exception and message
    (a usage error: ``SystemExit`` and the parser's message)."""
    from gymothelloenv_tpu.agents.replay import ReplayConfig as JRB
    from gymothelloenv_tpu.cli import dqn_train as jdqn_cli
    from gymothelloenv_tpu.cli import rainbow_train as jrainbow_cli
    from gymothelloenv_tpu.train import dqn_trainer as jdqn
    from gymothelloenv_tpu.train import rainbow_trainer as jrainbow
    from gymothelloenv_tpu_torch.agents.replay import ReplayConfig

    per = dict(replay_sharding="per-shard", num_envs=8)

    def trainers(run=per, cap=1024, batch=None, mesh=True, rainbow=False,
                 shards=2):
        port_mesh = dataclasses.replace(
            make_mesh(backend="gloo", device="cpu"), world=shards)
        jcls = jrainbow.RainbowTrainer if rainbow else jdqn.DQNTrainer
        cls = RainbowTrainer if rainbow else DQNTrainer
        algo = {} if batch is None else {
            ("rainbow_cfg" if rainbow else "dqn_cfg"): _algo_cfg(rainbow,
                                                                 batch)}
        jalgo = {} if batch is None else {
            ("rainbow_cfg" if rainbow else "dqn_cfg"): _algo_cfg(
                rainbow, batch, jax_side=True)}
        return (lambda: jcls(run_cfg=jdqn.DQNRunConfig(**run),
                             rb_cfg=JRB(capacity=cap), **jalgo,
                             mesh=jax_make_mesh(shards) if mesh else None),
                lambda: cls(run_cfg=DQNRunConfig(**run),
                            rb_cfg=ReplayConfig(capacity=cap), **algo,
                            mesh=port_mesh if mesh else None, device="cpu"))

    argv = ["--num-envs", "8", "--chunk-plies", "8", "--num-chunks", "1",
            "--replay-size", "4096", "--replay-sharding", "per-shard"]
    return {
        "pershard_without_mesh": trainers(mesh=False),
        "rainbow_pershard_without_mesh": trainers(mesh=False, rainbow=True),
        "capacity": trainers(cap=1023),
        "batch_size": trainers(batch=15),
        "2*num_envs": trainers(run=dict(per, num_envs=3), shards=4),
        "cli_dqn_pershard": (lambda: jdqn_cli.main(argv),
                             lambda: dqn_train.main(argv + ["--device",
                                                            "cpu"])),
        "cli_rainbow_pershard": (lambda: jrainbow_cli.main(argv),
                                 lambda: rainbow_train.main(
                                     argv + ["--device", "cpu"])),
        "model_parallel": (lambda: jax_make_mesh(1, model_parallel=2),
                           lambda: make_mesh(backend="gloo", device="cpu",
                                             model_parallel=2)),
    }


def _algo_cfg(rainbow, batch, jax_side=False):
    if jax_side:
        from gymothelloenv_tpu.agents.dqn import DQNConfig as JDQN
        from gymothelloenv_tpu.agents.rainbow import RainbowConfig as JRC
        return (JRC if rainbow else JDQN)(batch_size=batch)
    from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
    from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
    return (RainbowConfig if rainbow else DQNConfig)(batch_size=batch)


GUARDS = ("pershard_without_mesh", "rainbow_pershard_without_mesh",
          "capacity", "batch_size", "2*num_envs", "cli_dqn_pershard",
          "cli_rainbow_pershard", "model_parallel")


@pytest.mark.parametrize("case", GUARDS)
def test_mesh_guards_refuse_as_jax(case):
    """Per-shard replay without a mesh, a capacity, batch or
    ``2 * num_envs`` that the data shards do not divide, per-shard on
    either CLI without ``--data-parallel``, and a world that
    ``model_parallel`` does not divide: the port refuses each as JAX
    does, with JAX's exception and message (the trainers on a data axis
    of 2, or 4 for ``2 * num_envs``: JAX's ``make_mesh`` over the suite's
    virtual devices, the port's a ``DataMesh`` of that world that never
    reaches a collective)."""
    jax_call, port_call = _guard_cases()[case]
    errors = []
    for call in (jax_call, port_call):
        with contextlib.redirect_stderr(io.StringIO()) as err, \
                contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises((ValueError, SystemExit)) as info:
            call()
        msg = (err.getvalue().strip().splitlines()[-1]
               if info.type is SystemExit else str(info.value))
        errors.append((info.type, msg.split(": error: ")[-1]))
    assert errors[0] == errors[1], errors
    assert errors[1][1]


def test_gate_defaults_to_the_card(monkeypatch):
    """``spawn`` and ``dryrun_multichip`` without a device run on the
    card, so without one they raise before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(dryrun.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.spawn(2, "gymothelloenv_tpu_torch.parallel.dryrun:"
                     "families_task", {"families": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(("ppo",))
    assert not started


@pytest.mark.parametrize("kind", ["draws", "injected"])
def test_sharded_legal_index_is_the_global_draw_sliced(kind):
    """``ShardedDraws.legal_index`` on rank 1 of 2 equals the world-1
    draw on the global counts, sliced to rank 1's games, through the one
    ``legal_draw``/``legal_pick`` interface of both kinds of draws."""
    n, rows = 6, 2
    counts = torch.tensor([[3, 0, 5, 1, 7, 2], [4, 4, 1, 9, 0, 6]])
    index = torch.arange(rows * n).reshape(rows, n) % counts.clamp(min=1)

    def inner():
        if kind == "draws":
            return sp.Draws(torch.Generator().manual_seed(4))
        return sp.InjectedDraws((), (), legal_index=[index.reshape(-1)])
    want = inner().legal_index(counts.reshape(-1)).reshape(rows, n)
    mesh = dataclasses.replace(make_mesh(backend="gloo", device="cpu"),
                               rank=1, world=2)
    got = sp.ShardedDraws(inner(), mesh, n).legal_index(
        counts[:, 3:].reshape(-1))
    assert torch.equal(got, want[:, 3:].reshape(-1))
    assert bool((got < counts[:, 3:].reshape(-1).clamp(min=1)).all())


def test_global_helpers_without_a_group():
    """``global_mean``, ``global_sums`` and ``is_main`` with no mesh and
    on a world-1 mesh; a world-2 rank's mean divides its sum by both
    ranks' rows."""
    mesh = make_mesh(backend="gloo", device="cpu")
    x = torch.tensor([1.0, 2.0, 6.0])
    assert float(sharding.global_mean(x, None)) == 3.0
    assert float(sharding.global_mean(x, mesh)) == 3.0
    two = dataclasses.replace(mesh, world=2)
    assert float(sharding.global_mean(x, two)) == 1.5
    a, b = torch.tensor(3), torch.tensor(2.5)
    assert sharding.global_sums([a, b], None) == [a, b]
    got = sharding.global_sums([a, b], mesh)
    assert [float(v) for v in got] == [3.0, 2.5]
    assert got[0].dtype == torch.float32
    assert sharding.is_main(None) and sharding.is_main(mesh)
    assert not sharding.is_main(dataclasses.replace(mesh, rank=1))
