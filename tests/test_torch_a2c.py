"""The port's A2C (``agents/a2c.py``, ``train/a2c_trainer.py``,
``cli/a2c_train.py``) against JAX's: ``a2c_returns`` exactly with and
without GAE, one ``a2c_update`` (each parameter's step within 1e-5 of the
leaf's largest; the metrics to rtol 1e-5), the optimizer's state in
optax's tree both ways, one trainer update against JAX's
``A2CSelfPlayTrainer`` with its collector's draws injected, checkpoints
byte for byte both ways, the trainer's refusals with JAX's messages, and
the CLI.

Draw injection for the trainer: JAX's ``MaskedCategorical.sample`` is
patched to record each call's uniforms (``1 - uniform(key)``) and the
collector's ``reset_done`` each reset's colours, by ``io_callback`` in
program order; the port gets them as ``InjectedDraws`` with JAX's initial
params and colours."""

import contextlib
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import a2c as ja2c
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.train import a2c_trainer as ja2c_trainer
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train.ppo_trainer import make_apply_fn
from gymothelloenv_tpu_torch.agents import a2c
from gymothelloenv_tpu_torch.cli import a2c_train
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    load_flax_params,
                                                    policy_net_from_flax,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.a2c_trainer import A2CSelfPlayTrainer
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from test_torch_ppo import (HIDDEN, _flax_params, _jax_rollout,
                            _port_rollout, _rollout, _state)
from torch_port_helpers import one_torch_thread  # noqa: F401

TN, TT = 16, 5      # the trainer test's games and rollout length


@pytest.mark.parametrize("use_gae", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_returns_equal_jax_exactly(use_gae, seed):
    d = _rollout(seed)
    d["reward"] = np.random.RandomState(seed + 9).randn(
        *d["reward"].shape).astype(np.float32)
    boot = np.random.RandomState(seed + 3).randn(
        d["reward"].shape[1]).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        ja2c.a2c_returns, cfg=ja2c.A2CConfig(use_gae=use_gae)))(
        _jax_rollout(d), jnp.asarray(boot)))
    got = a2c.a2c_returns(_port_rollout(d), torch.from_numpy(boot),
                          a2c.A2CConfig(use_gae=use_gae)).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_steps_close(got, want, start, rtol=1e-5):
    """Each parameter's step (``got``'s and ``want``'s state dicts less
    ``start``'s) within ``rtol`` of the leaf's largest, plus one float32
    spacing of the parameter, which each side's ``p + u`` rounds to."""
    for k, w in want.items():
        wd, gd = w - start[k], got[k] - start[k]
        big = float(wd.abs().max())
        assert big > 0, k
        assert bool(((gd - wd).abs() <= rtol * big
                     + 2.0 ** -23 * w.abs()).all()), k


@pytest.mark.parametrize("use_gae", [False, True])
def test_update_equals_jax(use_gae):
    """One full-batch step from the same params and rollout: each
    parameter's step within 1e-5 of the leaf's largest plus one float32
    spacing of the parameter (RMSprop's first step is near-linear in the
    clipped gradient), the metrics to rtol 1e-5; then the optimizer's
    state against optax's."""
    jnet, params = _flax_params(0)
    jcfg = ja2c.A2CConfig(use_gae=use_gae, lr=3e-4)
    cfg = a2c.A2CConfig(use_gae=use_gae, lr=3e-4)
    d = _rollout(2)
    boot = np.random.RandomState(5).randn(d["reward"].shape[1]).astype(
        np.float32)
    jopt = ja2c.make_a2c_optimizer(jcfg)
    new, jstate, jm = jax.jit(functools.partial(
        ja2c.a2c_update, apply_fn=make_apply_fn(jnet), optimizer=jopt,
        cfg=jcfg))(params, jopt.init(params), _jax_rollout(d),
                   jnp.asarray(boot))
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu")
    start = _state(net)
    opt = a2c.make_a2c_optimizer(cfg, net.parameters())
    m = a2c.a2c_update(net, opt, _port_rollout(d), torch.from_numpy(boot),
                       cfg)
    _assert_steps_close(_state(net), _state(policy_net_from_flax(
        jax.tree.map(np.array, new), 1, HIDDEN, device="cpu")), start)
    for k in ("value_loss", "action_loss", "entropy"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    tree = opt.to_optax_state(functools.partial(flax_tree, net))
    jtree = jax.tree.map(np.array, jstate)
    assert tree["0"] == {} and tree["1"]["1"] == tree["1"]["2"] == {}
    nu = dict(flax_leaves(tree["1"]["0"]["nu"]))
    for k, leaf in flax_leaves(jtree[1][0].nu):
        assert np.abs(nu[k] - leaf).max() <= 1e-5 * np.abs(leaf).max(), k
    other = a2c.make_a2c_optimizer(cfg, net.parameters())
    other.load_optax_state(tree, functools.partial(tensors_from_flax, net))
    for a, b in zip(other.rms.nu, opt.rms.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rmsprop"):
        other.load_optax_state({"0": {}, "1": {"0": {"nu": {}}, "1": {},
                                               "2": {"trace": {}}}}, None)


def _run_cfgs(**kw):
    run = dict(num_envs=TN, num_steps=TT, hidden_size=HIDDEN,
               num_test_games=4, seed=7, **kw)
    return jppo_trainer.SelfPlayConfig(**run), SelfPlayConfig(**run)


@functools.cache
def _jax_trainer():
    """JAX's trainer after one update, with every draw of its collector
    recorded: ``(trainer, initial params, initial colours, uniforms,
    reset colours, metrics)``."""
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
        jrun, _ = _run_cfgs()
        tr = ja2c_trainer.A2CSelfPlayTrainer(
            a2c_cfg=ja2c.A2CConfig(use_gae=True),
            env_cfg=JaxEnvConfig(num_disk_as_reward=True), run_cfg=jrun,
            log_fn=lambda *a: None)
        params0 = jax.tree.map(np.array, tr.params)
        tr.ensure_initialized()
        jax.effects_barrier()
        colors0 = np.array(tr.sp_state.pcolor)
        # The initial colours come from the init's key, not a reset.
        metrics = tr._do_update(jax.random.PRNGKey(0))
        jax.effects_barrier()
    finally:
        jdist.MaskedCategorical.sample = real_sample
        jsp.reset_done = real_reset
    return tr, params0, colors0, uniforms, resets, metrics


def test_trainer_update_equals_jax():
    """One update of the trainer (N 16, T 5, GAE) on JAX's params and
    draws: the collector's games and colours equal, every parameter's
    delta within 1e-5 of the leaf's largest, the metrics to rtol 1e-5."""
    jtr, params0, colors0, uniforms, resets, jm = _jax_trainer()
    _, run = _run_cfgs()
    tr = A2CSelfPlayTrainer(a2c.A2CConfig(use_gae=True),
                            EnvConfig(num_disk_as_reward=True), run,
                            log_fn=lambda *a: None, device="cpu")
    load_flax_params(tr.net, params0)
    tr.draws = sp.InjectedDraws(
        colors=[torch.from_numpy(colors0)] + [torch.from_numpy(c)
                                              for c in resets],
        uniforms=[torch.from_numpy(u) for u in uniforms])
    start = _state(tr.net)
    tr.ensure_initialized()
    m = tr._do_update()
    with pytest.raises(StopIteration):      # every recorded draw was used
        tr.draws.uniforms(TN, "cpu")
    assert len(resets) == TT and int(m["episodes"]) == int(jm["episodes"])
    np.testing.assert_array_equal(tr.sp_state.pcolor.numpy(),
                                  np.asarray(jtr.sp_state.pcolor))
    np.testing.assert_array_equal(tr.sp_state.env.turn.numpy(),
                                  np.asarray(jtr.sp_state.env.turn))
    np.testing.assert_array_equal(tr.sp_state.pending.action.numpy(),
                                  np.asarray(jtr.sp_state.pending.action))
    _assert_steps_close(_state(tr.net), _state(policy_net_from_flax(
        jax.tree.map(np.array, jtr.params), 1, HIDDEN, device="cpu")), start)
    for k in ("value_loss", "action_loss", "entropy"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


def test_save_load_bytes_equal_jax_both_ways(tmp_path):
    jtr = _jax_trainer()[0]
    jtr.update_count = 1
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jtr.save(str(jax_path))
    _, run = _run_cfgs()
    tr = A2CSelfPlayTrainer(run_cfg=run, log_fn=lambda *a: None,
                            device="cpu")
    tr.load(str(jax_path))
    assert tr.update_count == 1
    tr.save(str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    tr.train(1, log_every=100)
    tr.save(str(port_path))
    jtr.load(str(port_path))
    assert jtr.update_count == 2
    jtr.save(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()


_REFUSED = (dict(recurrent=True), dict(frame_stack=2),
            dict(max_episode_plies=8))


@pytest.mark.parametrize("field", _REFUSED)
def test_trainer_refuses_what_jax_refuses(field):
    jrun, run = _run_cfgs(**field)
    with pytest.raises(ValueError) as jerr:
        ja2c_trainer.A2CSelfPlayTrainer(run_cfg=jrun)
    with pytest.raises(ValueError) as err:
        A2CSelfPlayTrainer(run_cfg=run, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_mesh_raises_naming_the_roadmap_item():
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        A2CSelfPlayTrainer(mesh=object(), device="cpu")


def test_chain_updates_and_pool_run():
    _, run = _run_cfgs(chain_updates=2, test_interval=10 ** 6)
    tr = A2CSelfPlayTrainer(run_cfg=run, log_fn=lambda *a: None,
                            device="cpu")
    tr.train(3, log_every=100)
    assert tr.update_count == 4
    _, run = _run_cfgs(opponent_pool=2, pool_interval=1,
                       test_interval=10 ** 6)
    tr = A2CSelfPlayTrainer(run_cfg=run, log_fn=lambda *a: None,
                            device="cpu")
    tr.train(3, log_every=100)
    assert len(tr.pool) == 2


def test_cli_runs(tmp_path):
    ckpt = str(tmp_path / "a2c.msgpack")
    argv = ["--device", "cpu", "--num-envs", "16", "--num-steps", "5",
            "--num-updates", "2", "--num-test-games", "4", "--log-every",
            "1", "--use-gae", "--checkpoint", ckpt, "--log-dir",
            str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = a2c_train.main(argv)
    text = out.getvalue()
    assert tr.update_count == 2 and "final eval:" in text
    assert "device: cpu; float32" in text and os.path.exists(ckpt)
    assert tr.a2c_cfg.use_gae and tr.run_cfg.num_steps == 5
    assert os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("family", ["rainbow", "acktr", "a2c"])
def test_family_strength_rehearses_on_the_cpu(family):
    """``scripts/family_strength.py --chunks 1 --num-envs 8 --device cpu``:
    one JSON row an opponent against the JAX run's counts."""
    from gymothelloenv_tpu_torch.scripts import family_strength as fs
    with contextlib.redirect_stdout(io.StringIO()):
        rows = fs.main(["--family", family, "--chunks", "1", "--num-envs",
                        "8", "--device", "cpu"])
    assert [r["opponent"] for r in rows] == ["greedy", "rand"]
    for r in rows:
        assert (r["jax_wins"], r["jax_games"]) == fs.JAX[family][
            r["opponent"]]
        assert r["games"] == fs.TEST_GAMES and 0 <= r["wins"] <= r["games"]
        assert 0.0 <= r["p"] <= 1.0 and r["seed"] == fs.DEFAULTS[family][1]
