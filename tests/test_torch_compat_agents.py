"""The port's reference-checkpoint import (``compat/torch_import.py``),
the ``.pth``/``.pt`` branch of ``load_eval_policy`` and the evaluation
CLI, and the reference-API agents (``compat/agents.py``).

The imported nets' forwards equal the live reference-architecture torch
modules of ``tests/test_torch_import.py`` (1e-5) for the four
architectures and JAX's imports of the same files; ``load_eval_policy``
loads a ``.pth`` of each kind (a state_dict, ``util.save``'s dict, a
whole module) with JAX's description and outputs; ``export_policy_net``
inverts ``import_policy_net``.  The agents: PPO's and DQN's acting draws
from the global ``np.random`` in JAX's order (the same actions from the
same params and seed), PPO's update on its stored transitions equals
``simple_ppo_update``'s, checkpoints load both ways with JAX's agents,
and the DQN and Rainbow host loops fill their replay and train."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.compat import agents as jagents
from gymothelloenv_tpu.compat import torch_import as jimport
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu_torch import compat
from gymothelloenv_tpu_torch.cli import eval_checkpoint
from gymothelloenv_tpu_torch.compat import agents, torch_import
from gymothelloenv_tpu_torch.compat.featurize import make_state3, make_state4
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    load_flax_params)
from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.train.ppo_trainer import load_eval_policy
from test_torch_import import (TorchActorCritic, TorchCNNPolicy, TorchDQN,
                               TorchDuelingDQN)
from torch_port_helpers import one_torch_thread  # noqa: F401

ARCHS = (("policy", TorchCNNPolicy, 4), ("dqn", TorchDQN, 3),
         ("dueling_dqn", TorchDuelingDQN, 3),
         ("actor_critic", TorchActorCritic, 4))


def _obs(n, c, seed):
    return np.random.RandomState(seed).randn(n, c, 8, 8).astype(np.float32)


@pytest.mark.parametrize("kind, cls, c", ARCHS, ids=[a[0] for a in ARCHS])
def test_import_forward_equals_reference_module(kind, cls, c):
    torch.manual_seed(len(kind))
    ref = cls()
    got_kind, net = torch_import.detect_and_import(ref.state_dict(),
                                                   device="cpu")
    assert got_kind == kind
    x = torch.from_numpy(_obs(5, c, 1))
    with torch.no_grad():
        want, got = ref(x), net(x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # The same weights as JAX's import, leaf for leaf.
    _, jparams = jimport.detect_and_import(ref.state_dict())
    tree = dict(flax_tree(net)["params"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jparams["params"])[0]:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def _save(tmp_path, kind, cls, layout):
    torch.manual_seed(7)
    ref = cls()
    path = str(tmp_path / f"{kind}_{layout}.pth")
    obj = {"state": ref.state_dict(), "module": ref,
           "util": {"episode": 3, "model_state_dict": ref.state_dict()}}[
        layout]
    torch.save(obj, path)
    return path, ref


@pytest.mark.parametrize("layout", ["state", "util", "module"])
@pytest.mark.parametrize("kind, cls, c", ARCHS, ids=[a[0] for a in ARCHS])
def test_load_eval_policy_pth_equals_jax(tmp_path, kind, cls, c, layout):
    """A ``.pth`` of each kind and layout: JAX's description, and the
    policy's (logits, value) equal JAX's ``imported_apply_fn`` on 4-plane
    inputs (a DQN's Q values times 1e6 as logits, value 0)."""
    path, _ = _save(tmp_path, kind, cls, layout)
    policy, desc = load_eval_policy(path, device="cpu")
    params, apply_fn, jdesc = jppo_trainer.load_eval_policy(path,
                                                            JaxEnvConfig())
    assert desc == jdesc == f"torch checkpoint (architecture: {kind})"
    x = (np.random.RandomState(2).rand(6, 4, 8, 8) < 0.4).astype(
        np.float32)
    x[:, 2] = np.arange(6)[:, None, None] % 2     # the turn plane
    want_logits, want_value, _ = apply_fn(params, jnp.asarray(x))
    with torch.no_grad():
        logits, value = policy(torch.from_numpy(x))
    scale = 1e6 if kind.endswith("dqn") else 1.0
    np.testing.assert_allclose(logits.numpy() / scale,
                               np.asarray(want_logits) / scale, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               rtol=1e-5, atol=1e-5)


def test_eval_checkpoint_cli_plays_a_pth(tmp_path):
    path, _ = _save(tmp_path, "dqn", TorchDQN, "state")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        w, d, l = eval_checkpoint.main(["--load", path, "--opponent",
                                        "rand", "--games", "4",
                                        "--device", "cpu"])
    assert w + d + l == 4
    assert "torch checkpoint (architecture: dqn)" in out.getvalue()
    with pytest.raises(ValueError, match="8x8"):
        load_eval_policy(path, compat.envs.EnvConfig(board_size=6),
                         device="cpu")


def test_export_inverts_import_and_detect_refuses_unknown():
    torch.manual_seed(5)
    src = TorchCNNPolicy()
    net = torch_import.import_policy_net(src, device="cpu")
    sd = torch_import.export_policy_net(net)
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    assert isinstance(net, PolicyNet) and net.fc.out_features == 512
    with pytest.raises(ValueError, match="unrecognized"):
        torch_import.detect_and_import({"mystery.weight": np.zeros((2, 2))})


def _jax_ppo(tmp_path):
    """JAX's compat PPO agent and the port's with its params."""
    jag = jagents.PPO("jppo", 8, update_timestep=64, batch_size=32)
    ag = agents.PPO(str(tmp_path / "ppo"), 8, update_timestep=64,
                    batch_size=32, device="cpu")
    load_flax_params(ag.net, jax.tree.map(np.array, jag.params))
    return jag, ag


def _games(ag, env_mod, feat, seed, rounds=1, kw=None):
    """The agent's actions over ``rounds`` games of a seeded
    ``SimpleOthelloEnv``, the global ``np.random`` seeded first; it learns
    from each transition."""
    env = env_mod.SimpleOthelloEnv(mute=True, **(kw or {}))
    ag.reset(env)
    np.random.seed(seed)
    actions = []
    for _ in range(rounds):
        env.reset()
        done = False
        while not done:
            s = feat(env)
            a = ag.get_action(s)
            actions.append(a)
            _, r, done, _ = env.step(a)
            ag.run(s, a, r, done, feat(env))
    return actions


def test_ppo_agent_acts_as_jax_and_updates(tmp_path, monkeypatch):
    """From the same params the port's PPO draws the same moves from
    ``np.random`` as JAX's until its first update, which runs
    ``simple_ppo_update`` on the 64 stored transitions from the params
    that played them; a checkpoint of either loads into the other."""
    from gymothelloenv_tpu import compat as jcompat
    monkeypatch.chdir(tmp_path)
    jag, ag = _jax_ppo(tmp_path)
    stored = []
    real = agents.simple_ppo_update

    def spy(net, opt, roll, cfg, perms=None, generator=None):
        stored.append((roll, {k: v.clone() for k, v in
                              net.state_dict().items()}))
        return real(net, opt, roll, cfg, perms, generator)
    monkeypatch.setattr(agents, "simple_ppo_update", spy)
    with contextlib.redirect_stdout(io.StringIO()):
        want = _games(jag, jcompat, make_state4, 0, rounds=2)
        before = {k: v.clone() for k, v in ag.net.state_dict().items()}
        got = _games(ag, compat, make_state4, 0, rounds=2,
                     kw={"device": "cpu"})
    # The games agree until the first update (the two sides' updates
    # shuffle with their own streams).
    assert got[:64] == want[:64] and ag.timestep == len(got) > 64
    assert len(stored) == 1 and len(stored[0][0].action) == 64
    assert all(torch.equal(before[k], v) for k, v in stored[0][1].items())
    assert (tmp_path / "ppo_output.txt").exists()
    ag.save(str(tmp_path / "port.msgpack"), episode=2, loss=0.5)
    ep, loss = jag.load(str(tmp_path / "port.msgpack"))
    assert ep == 2 and loss == 0.5
    jag.save(str(tmp_path / "jax.msgpack"), episode=4, loss=0.25)
    assert ag.load(str(tmp_path / "jax.msgpack")) == (4, 0.25)
    assert agents.PPO(str(tmp_path / "p3"), 8, state_channels=3,
                      device="cpu").net.trunk.conv0.in_channels == 3
    for k, v in flax_tree(ag.net)["params"].items():
        assert jax.tree.all(jax.tree.map(
            lambda a, b: np.array_equal(a, np.asarray(b)), v,
            jag.params["params"][k]))


def test_dqn_agent_acts_as_jax(tmp_path, monkeypatch):
    """From JAX's params (no update: the train interval is never reached)
    a game's moves equal JAX's: random from ``np.random`` during the
    warm-up, then greedy over the legal Q values with the epsilon test's
    draw still taken (epsilon 0)."""
    from gymothelloenv_tpu import compat as jcompat
    kw = dict(replay_memory_size=4096, initial_replay_size=20,
              train_interval=10 ** 6, n_step=2, final_epsilon=0.0,
              anealing_steps=1)
    jag = jagents.DQNAgent("jdqn", 8, **kw)
    ag = agents.DQNAgent("dqn", 8, device="cpu", **kw)
    load_flax_params(ag.state.net, jax.tree.map(np.array, jag.state.params))
    monkeypatch.chdir(tmp_path)          # each agent's *_output.txt
    with contextlib.redirect_stdout(io.StringIO()):
        want = _games(jag, jcompat, make_state3, 3)
        got = _games(ag, compat, make_state3, 3, kw={"device": "cpu"})
    assert got == want and ag.t == jag.t > 20


@pytest.mark.parametrize("cls", ["DQNAgent", "Rainbow"])
def test_value_agents_fill_replay_and_train(tmp_path, monkeypatch, cls):
    """The DQN and Rainbow host loops: two games fill the replay with
    every n-step transition, updates run every 4 after the warm-up, the
    test action is legal, and a checkpoint round-trips."""
    monkeypatch.chdir(tmp_path)
    kw = dict(replay_memory_size=4096, initial_replay_size=40,
              train_interval=4, batch_size=16)
    ag = getattr(agents, cls)(str(tmp_path / cls), 8, device="cpu", **kw)
    params = [p.detach().clone() for p in ag.state.net.parameters()]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _games(ag, compat, make_state3, 3, rounds=2, kw={"device": "cpu"})
    assert ag.t == int(ag.replay.size) > 40 and ag.episode == 2
    assert "EPISODE:" in out.getvalue()
    assert any(not torch.equal(a, b)
               for a, b in zip(params, ag.state.net.parameters()))
    env = compat.SimpleOthelloEnv(mute=True, device="cpu")
    env.reset()
    ag.reset(env)
    assert ag.get_test_action(make_state3(env)) in env.possible_moves
    ag.save(str(tmp_path / "a.msgpack"), episode=1, loss=0.1)
    assert ag.load(str(tmp_path / "a.msgpack")) == (1, 0.1)
