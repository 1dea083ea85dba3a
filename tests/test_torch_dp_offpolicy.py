"""The rest of the port's multi-device training on the CPU: DQN and Rainbow
under a mesh (``train/dqn_trainer.py``, ``agents/dqn.py``,
``agents/rainbow.py``), the per-shard replay's trainer path
(``parallel/replay_shards.py``), the model axis of ``parallel/sharding.py``
and the tensor-parallel step of ``parallel/dp.py``.

One gloo cluster of two CPU ranks is spawned for the module
(``parallel.dryrun.spawn``).  Each rank runs
``torch_dp_tasks.offpolicy_cluster_task`` on the 2 x 1 mesh and on the
1 x 2 one (``make_mesh(model_parallel=2)``):

  * two chunks of DQN (PER, double, dueling, 2-step) and of Rainbow
    (``parallel.dryrun.OFF_POLICY``) on both meshes: world 2 equals world 1
    (run here) to JAX's gate, rtol 5e-3 and atol 1e-5, and each leaf
    within 1e-3 of the run's largest parameter change; the replicated
    replays (rows and priorities) are bit-equal on every rank and equal
    world 1's rows exactly; the world-1 mesh path equals ``mesh=None``
    (each leaf within 1e-5 of the largest change, the rows exactly);
  * one update of every on-policy family (``parallel.dryrun.ON_POLICY``)
    on the 1 x 2 mesh, whose model ranks play the same games: world 1's
    update to the same tolerances; and DQN on a uniform ring there (JAX's
    ``test_dqn_sharded_parity`` case);
  * both per-shard variants, one chunk of 12 plies: the union of the
    rings equals the world-1 replicated ring exactly, then a second chunk
    trains on it, finite, moving priorities;
  * DQN on the 2 x 1 mesh from JAX's initial params with the draws and
    sampled rows of JAX's ``DQNTrainer(mesh=make_mesh(2))`` chunk injected
    (recorded by ``io_callback`` as ``tests/test_torch_dqn_trainer.py``
    records them, over the suite's virtual CPU devices): the replay's
    rows, write position and size and ``t`` exactly, the params to rtol
    5e-3 and atol 1e-5;
  * ``make_sharded_train_step`` on the 1 x 2 mesh, the wide layers split
    over the model axis, one step at the dryrun's size with the clip
    active (a minibatch's gradient norm above ``max_grad_norm`` 0.5):
    world 1's params to rtol 5e-3 and atol 1e-5 and every clip's norm to
    rtol 1e-5; ``TPPolicyNet``'s forward and its gathered gradients equal
    the whole net's to 1e-6;
  * the groups of a model axis: a model-axis sum adds both ranks; a
    data-axis one (of a data axis of 1) leaves model index 0's value on
    both, as every data-axis reduction does on a model axis so that
    replicated state stays bit-equal.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import dqn as jdqn
from gymothelloenv_tpu.agents import replay as jreplay
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.parallel import make_mesh as jax_make_mesh
from gymothelloenv_tpu.parallel import policy_param_shardings as jax_tp
from gymothelloenv_tpu.train.ppo_trainer import make_network as jax_network
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel import dp, dryrun, make_mesh, sharding
from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
from test_torch_dqn_trainer import (FIELDS, PLIES, _configs, _legal_rank,
                                    _rank, _Recording, _reset_draws)
from torch_dp_tasks import OFF, ON, TP, WORLD, uniform_dqn
from torch_port_helpers import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
# JAX's chunk: self-play on PER, 2-step returns, the plain net.
JAX_CFG = (None, 2, False)


def _jax_record():
    """One chunk of JAX's DQN trainer on ``make_mesh(2)`` with its draws
    and sampled rows recorded."""
    moves, real = [], JaxBitEngine.random_legal
    real_sample = jdqn.replay_sample_idx

    def random_legal(self, keys, state):
        a = real(self, keys, state)
        io_callback(lambda w0, w1, a: moves.append(
            (np.stack([w0, w1], -1), np.array(a))), None,
            state.legal[0], state.legal[1], a, ordered=True)
        return a

    def sample_idx(rb, cfg, key, batch):
        idx = real_sample(rb, cfg, key, batch)
        io_callback(lambda u, i: tr.updates.append(
            (np.array(u), np.array(i))), None,
            jax.random.uniform(key, (batch,)), idx, ordered=True)
        return idx
    JaxBitEngine.random_legal = random_legal
    jdqn.replay_sample_idx = sample_idx
    try:
        jcfgs, _ = _configs(*JAX_CFG, per=True)
        tr = _Recording(*jcfgs, log_fn=lambda *a: None,
                        mesh=jax_make_mesh(WORLD))
        tr.acts, tr.updates = [], []
        tr.ensure_initialized()
        params0 = jax.tree.map(np.array, tr.agent.params)
        roll0 = jax.tree.map(np.array, tr.roll)
        tr.agent, tr.replay, tr.roll, _ = tr._train_chunk(
            tr.agent, tr.replay, tr.roll, jax.random.PRNGKey(17))
        jax.effects_barrier()
    finally:
        JaxBitEngine.random_legal = real
        jdqn.replay_sample_idx = real_sample
    assert len(tr.acts) == len(moves) == PLIES
    colors, rand_left = _reset_draws(jnp.asarray(roll0.env_keys))
    legal_index = []
    for (lg, _, a), (w, m) in zip(tr.acts, moves):
        legal_index += [_rank(lg, a), _legal_rank(w, m)]
    size = int(tr.replay.size)
    rows = jreplay.replay_gather(tr.replay, jnp.arange(size))
    return dict(
        params0=params0, params=jax.tree.map(np.array, tr.agent.params),
        rows={f: np.asarray(r) for f, r in zip(FIELDS, rows)},
        size=size, write_pos=int(tr.replay.write_pos), t=int(tr.agent.t),
        colors=[roll0.pcolor] + colors, rand_left=[roll0.rand_left]
        + rand_left, uniforms=[u for _, u, _ in tr.acts],
        legal_index=[t.numpy() for t in legal_index],
        replay_uniforms=[u for u, _ in tr.updates],
        idx=[i for _, i in tr.updates])


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One world-2 gloo cluster on the CPU and, meanwhile in this
    process, the JAX recording (renamed into place for the ranks, which
    read it last) and the world-1 runs (``_world1``)."""
    tmp = tmp_path_factory.mktemp("dp_off")
    expert = dryrun.write_expert(str(tmp / "expert.npz"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, env.get("PYTHONPATH", "")])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            dryrun.spawn, WORLD, "torch_dp_tasks:offpolicy_cluster_task",
            {"jax": str(tmp / "jax.pt"), "expert": expert},
            backend="gloo", device="cpu", out_dir=str(tmp / "cluster"),
            timeout_s=240, env=env)
        rec = _jax_record()
        rec["port_cfgs"] = _configs(*JAX_CFG, per=True)[1]
        torch.save(rec, tmp / "jax.pt.part")
        os.replace(tmp / "jax.pt.part", tmp / "jax.pt")
        one = _world1(expert)
        ranks = ranks.result()
    return dict(ranks=ranks, rec=rec, expert=expert, world1=one)


def _world1(expert) -> dict:
    """World 1 (a mesh without a group) and ``mesh=None``: the off-policy
    chunks, the on-policy updates, the per-shard references, the TP
    step."""
    one = make_mesh(backend="gloo", device="cpu")
    return {"off": dryrun.families_task(one, "cpu", OFF),
            "off_none": dryrun.families_task(None, "cpu", OFF),
            "on": dryrun.families_task(one, "cpu", dict(ON, expert=expert)),
            "rings": {f: dryrun.replicated_ring(f, "cpu")
                      for f in dryrun.OFF_POLICY},
            "tp": dryrun.tp_task(one, "cpu", TP),
            "uniform": uniform_dqn(None, "cpu")}


@pytest.fixture(scope="module")
def world1(cluster):
    return cluster["world1"]


def _init(family, expert=None):
    return dryrun.state_of(family, dryrun.build(family, None, "cpu",
                                                expert=expert))


def _held(want, got, init, rel):
    """JAX's gate, and each float leaf within ``rel`` of the largest
    parameter change; the replay rows exactly."""
    sharding.assert_tree_allclose(want, got, require_finite=True)
    moved = max(float((want[k] - init[k]).abs().max()) for k in init
                if init[k].is_floating_point())
    assert moved > 1e-3
    for k in want:
        if not want[k].is_floating_point():
            assert torch.equal(got[k], want[k]), k
            continue
        diff = float((got[k] - want[k]).abs().max())
        assert diff <= rel * moved, (k, diff, moved)


@pytest.mark.parametrize("model_parallel", [1, 2])
@pytest.mark.parametrize("family", dryrun.OFF_POLICY)
def test_offpolicy_world2_equals_world1(cluster, world1, family,
                                        model_parallel):
    runs = [r["off"][model_parallel][family] for r in cluster["ranks"]]
    dryrun.check_replicated(runs)          # replays bit-equal on every rank
    want = world1["off"][family]
    _held(want["state"], runs[0]["state"], _init(family), 1e-3)
    for m_got, m_want in zip(runs[0]["metrics"], want["metrics"]):
        for k in m_want:
            assert m_got[k] == pytest.approx(m_want[k], rel=1e-3,
                                             abs=1e-5), k
    assert want["metrics"][-1]["transitions"] > 0


def test_uniform_dqn_model_axis_equals_world1(cluster, world1):
    """JAX's ``test_dqn_sharded_parity`` case (model_parallel 2, a
    uniform ring): two chunks on the 1 x 2 mesh equal ``mesh=None``."""
    runs = [r["uniform"] for r in cluster["ranks"]]
    assert all(torch.equal(runs[0][k], r[k]) for r in runs for k in r)
    init = dryrun.state_of("dqn", dryrun.build_off_policy(
        "dqn", None, "cpu", prioritized=False))
    _held(world1["uniform"], runs[0], init, 1e-3)


@pytest.mark.parametrize("family", dryrun.OFF_POLICY)
def test_offpolicy_world1_mesh_equals_no_mesh(world1, family):
    _held(world1["off_none"][family]["state"],
          world1["off"][family]["state"], _init(family), 1e-5)


@pytest.mark.parametrize("family", dryrun.ON_POLICY)
def test_on_policy_model_axis_equals_world1(cluster, world1, family):
    """On the 1 x 2 mesh both ranks play every game (a data axis of 1)
    with replicated params; the update is world 1's."""
    runs = [r["on_model"][family] for r in cluster["ranks"]]
    dryrun.check_replicated(runs)
    _held(world1["on"][family]["state"], runs[0]["state"],
          _init(family, cluster["expert"]), 1e-3)


@pytest.mark.parametrize("family", dryrun.OFF_POLICY)
def test_pershard_ring_union_equals_replicated(cluster, world1, family):
    ranks = [r["pershard"][family] for r in cluster["ranks"]]
    dryrun.check_pershard(family, world1["rings"][family], ranks)
    assert all(r["moved"] > 0 for r in ranks)
    sizes = [r["ring"]["size"] for r in ranks]
    assert sum(sizes) == world1["rings"][family]["size"] and min(sizes) > 0


def test_dqn_world2_equals_jax_mesh2(cluster):
    rec = cluster["rec"]
    for r in cluster["ranks"]:
        got = r["jax_dqn"]
        assert (got["size"], got["write_pos"], got["t"]) == (
            rec["size"], rec["write_pos"], rec["t"])
        assert rec["size"] > 40
        for f in FIELDS:
            np.testing.assert_array_equal(got["rows"][f].numpy(),
                                          rec["rows"][f], err_msg=f)
        sharding.assert_tree_allclose(rec["params"], got["tree"],
                                      name="dqn vs jax",
                                      require_finite=True)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(rec["params"]), jax.tree.leaves(rec["params0"])))
    assert moved > 1e-3 and len(rec["idx"]) == 128


def test_sharded_train_step_1x2_equals_world1(cluster, world1):
    want = world1["tp"]
    assert max(want["norms"]) > 0.5           # the clip acted
    for r in cluster["ranks"]:
        _held(want["state"], r["tp"]["state"], dryrun.tp_init_state("cpu"),
              1e-3)
        np.testing.assert_allclose(r["tp"]["norms"], want["norms"],
                                   rtol=1e-5)


def test_tp_net_and_model_groups(cluster):
    for rank, r in enumerate(cluster["ranks"]):
        c = r["tp_checks"]
        assert c["forward"] <= 1e-6 and c["grads"] <= 1e-6, c
        # The data axis is 1: its sum leaves model index 0's value, copied
        # to the other model rank.
        assert c["model_sum"] == 3.0 and c["data_sum"] == 1.0
        assert c["place"] == (0, 1, rank, 2)


def test_policy_param_shardings_follow_jax():
    """The port's split (a torch axis per ``PolicyNet`` parameter) is
    JAX's ``_POLICY_TP_RULES`` on flax's transposed kernels, and nothing
    splits on a model axis of 1."""
    jparams = jax.jit(jax_network(EnvConfig()).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)))
    jspecs = {"/".join(str(getattr(p, "key", p)) for p in path): s.spec
              for path, s in jax.tree_util.tree_flatten_with_path(
                  jax_tp(jax_make_mesh(2, model_parallel=2), jparams))[0]}
    net = make_network(EnvConfig(), seed=0, device="cpu")
    two = dataclasses.replace(make_mesh(backend="gloo", device="cpu"),
                              model_parallel=2)
    split = sharding.policy_param_shardings(two, net)
    flax = {"fc": "Dense_0", "value": "Dense_1", "logits": "Dense_2"}
    for name, axis in split.items():
        layer, leaf = name.rsplit(".", 1)
        if layer not in flax:
            assert axis is None, name
            continue
        spec = jspecs[f"params/{flax[layer]}/"
                      f"{'kernel' if leaf == 'weight' else 'bias'}"]
        if leaf == "bias":
            assert (axis == 0) == (tuple(spec) == ("model",)), name
        else:
            want = None if tuple(spec) == () else 1 - list(spec).index(
                "model")
            assert axis == want, name
    assert set(dp.sharded_names(net, two)) == {
        "fc.weight", "fc.bias", "value.weight", "logits.weight"}
    assert not any(sharding.policy_param_shardings(
        make_mesh(backend="gloo", device="cpu"), net).values())
