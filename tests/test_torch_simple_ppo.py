"""The port's simple PPO (``agents/simple_ppo.py``,
``train/simple_ppo_trainer.py``, ``cli/run_self_play.py``) against JAX's:
``mc_returns`` bit for bit, one ``simple_ppo_update`` from the same
params with JAX's epoch permutations injected (each parameter's delta
within 1e-5 of the leaf's largest), the default optimizer's step on
JAX's gradients against optax adam's, one trainer update against JAX's
``SimplePPOSelfPlayTrainer`` with its collector's draws and permutations
injected (the full-softmax behaviour log-probs, the VecNormalize reward
filter), checkpoints byte for byte both ways with the filter's state,
and the CLI.

The whole-update comparisons run Adam at eps 1e-3 on both sides
(``TEST_EPS``).  At optax's default 1e-8 an entry whose gradient is near
0 steps by up to ``lr * sign(g)``, so XLA's and torch's float32 sums,
which differ by ~1e-7 of a gradient's terms, move single entries by
~lr: measured 8.5e-3 of a leaf's largest delta after one step, 1.1e-3
after the 20 of a full update.  At eps 1e-3 the same update agrees to
8.1e-6.  The default optimizer itself is held to optax on JAX's own
gradients (``test_default_optimizer_steps_equal_optax``).

Draw injection for the trainer: JAX's ``MaskedCategorical.sample`` is
patched to record each call's uniforms and the collector's ``reset_done``
each reset's colours, by ``io_callback`` in program order (as
``tests/test_torch_a2c.py``); the port gets them as ``InjectedDraws``."""

import contextlib
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import simple_ppo as jsp_ppo
from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.models.nets import ActorCriticNet as JaxACNet
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train import simple_ppo_trainer as jtrainer
from gymothelloenv_tpu_torch.agents import simple_ppo
from gymothelloenv_tpu_torch.agents.ppo import Adam
from gymothelloenv_tpu_torch.cli import run_self_play
from gymothelloenv_tpu_torch.models.convert import load_flax_params
from gymothelloenv_tpu_torch.models.nets import ActorCriticNet
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.simple_ppo_trainer import (
    SimplePPOSelfPlayTrainer, SimpleSelfPlayConfig)
from test_torch_a2c import _assert_steps_close
from test_torch_ppo import _jax_rollout, _port_rollout, _rollout, _state
from torch_port_helpers import one_torch_thread  # noqa: F401

TN, TT = 8, 8       # the trainer test's games and rollout length
TEST_EPS = 1e-3     # Adam's eps in the whole-update comparisons


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_returns_equal_jax_bit_for_bit(seed):
    d = _rollout(seed)
    rng = np.random.RandomState(seed + 4)
    reward = rng.randn(*d["reward"].shape).astype(np.float32) * 7
    done = rng.rand(*d["done"].shape) < 0.2
    for gamma in (0.99, 0.95):
        want = np.asarray(jax.jit(jsp_ppo.mc_returns, static_argnums=2)(
            jnp.asarray(reward), jnp.asarray(done), gamma))
        got = simple_ppo.mc_returns(torch.from_numpy(reward),
                                    torch.from_numpy(done), gamma).numpy()
        np.testing.assert_array_equal(got, want)


def _ac_params(seed):
    jnet = JaxACNet(num_actions=64)
    return jnet, jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)))


def _ac_net(params):
    net = ActorCriticNet()
    return load_flax_params(net, params).train()


def _update_inputs():
    """JAX's net and params, and a rollout whose full-softmax behaviour
    log-probs sit near the net's own (so the ratio clip is live)."""
    jnet, params = _ac_params(0)
    d = _rollout(3)
    obs = jnp.asarray(d["obs"].reshape(-1, 4, 8, 8), jnp.float32)
    logits, _ = jnet.apply(params, obs)
    lp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                            d["action"].reshape(-1, 1), 1)
    rng = np.random.RandomState(5)
    d["logp"] = (lp.reshape(d["done"].shape)
                 + rng.randn(*d["done"].shape) * 0.1).astype(np.float32)
    return jnet, params, d


def test_default_optimizer_steps_equal_optax():
    """``make_simple_ppo_optimizer`` (lr 1e-3, betas 0.9/0.999, eps 1e-8)
    against optax ``adam`` on the same gradients, JAX's of the simple-PPO
    loss on two minibatches in turn: each step within 2e-5 of the leaf's
    largest.  torch computes Adam's bias corrections in double, optax in
    float32 (``1 - 0.999`` is 1.3e-5 off in float32), so the steps differ
    by ~6.5e-6 of themselves."""
    jnet, params, d = _update_inputs()
    jcfg = jsp_ppo.SimplePPOConfig()
    cfg = simple_ppo.SimplePPOConfig()
    jopt = jsp_ppo.make_simple_ppo_optimizer(jcfg)
    jstate = jopt.init(params)
    net = _ac_net(params)
    opt = simple_ppo.make_simple_ppo_optimizer(cfg, net.parameters())
    obs = d["obs"].reshape(-1, 4, 8, 8).astype(np.float32)
    flat = {k: d[k].reshape(-1) for k in ("action", "logp", "reward")}
    for rows in (slice(0, 64), slice(64, 128)):
        def loss(p):
            lg, v = jnet.apply(p, jnp.asarray(obs[rows]))
            lp = jax.nn.log_softmax(lg)
            a = jnp.asarray(flat["action"][rows])
            logp = jnp.take_along_axis(lp, a[:, None], 1)[:, 0]
            ratio = jnp.exp(logp - jnp.asarray(flat["logp"][rows]))
            adv = jnp.asarray(flat["reward"][rows]) - jax.lax.stop_gradient(v)
            return (-jnp.minimum(ratio * adv, jnp.clip(ratio, 0.8, 1.2)
                                 * adv) + 0.5 * (v - flat["reward"][rows])
                    ** 2).mean()
        grads = jax.grad(loss)(params)
        upd, jstate = jax.jit(jopt.update)(grads, jstate, params)
        want = _state(_ac_net(jax.tree.map(np.array, upd)))
        start = _state(net)
        for p, g in zip(net.parameters(), _state(_ac_net(
                jax.tree.map(np.array, grads))).values()):
            p.grad = g.clone()
        opt.step()
        params = optax.apply_updates(params, upd)
        for k, w in want.items():
            step = net.state_dict()[k] - start[k]
            big = float(w.abs().max())
            assert big > 0 and float((step - w).abs().max()) <= 2e-5 * big, k


def test_update_equals_jax_with_its_permutations():
    """One ``simple_ppo_update`` (5 epochs x 4 minibatches of 64, lr 1e-3,
    Adam eps ``TEST_EPS``) from the same params and rollout, JAX's epoch
    permutations injected: each delta within 1e-5 of its leaf's largest,
    the loss to rtol 1e-5; the optimizer's count is optax's."""
    jnet, params, d = _update_inputs()
    cfg_kw = dict(batch_size=64)
    jcfg = jsp_ppo.SimplePPOConfig(**cfg_kw)
    cfg = simple_ppo.SimplePPOConfig(**cfg_kw)
    key = jax.random.PRNGKey(9)

    def apply_fn(p, x):
        lg, v = jnet.apply(p, x)
        return lg, v, None
    jopt = optax.adam(jcfg.lr, eps=TEST_EPS)
    new, jstate, jloss = jax.jit(functools.partial(
        jsp_ppo.simple_ppo_update, apply_fn=apply_fn, optimizer=jopt,
        cfg=jcfg))(params, jopt.init(params), _jax_rollout(d), key)
    total = d["reward"].size
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, total)))
             for k in jax.random.split(key, jcfg.k_epochs)]
    net = _ac_net(params)
    start = _state(net)
    opt = Adam(net.parameters(), cfg.lr, eps=TEST_EPS)
    loss = simple_ppo.simple_ppo_update(net, opt, _port_rollout(d), cfg,
                                        perms)
    want = _state(_ac_net(jax.tree.map(np.array, new)))
    _assert_steps_close(_state(net), want, start)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert int(opt.to_optax_state(lambda t: t)["0"]["count"]) == int(
        jstate[0].count) == 20
    with pytest.raises(ValueError, match="5 permutations"):
        simple_ppo.simple_ppo_update(net, opt, _port_rollout(d), cfg,
                                     perms[:2])


def _run_cfgs(**kw):
    run = dict(num_envs=TN, num_steps=TT, num_test_games=4, seed=3,
               test_interval=10 ** 6, **kw)
    return jtrainer.SimpleSelfPlayConfig(**run), SimpleSelfPlayConfig(**run)


@functools.cache
def _jax_trainer():
    """JAX's trainer (vecnorm on) after one update from key 0, with every
    draw of its collector recorded: ``(trainer, initial params, initial
    colours, uniforms, reset colours, metrics, permutations)``."""
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
    real_opt = jtrainer.make_simple_ppo_optimizer
    jdist.MaskedCategorical.sample = sample
    jsp.reset_done = reset_done
    jtrainer.make_simple_ppo_optimizer = lambda cfg: optax.adam(
        cfg.lr, eps=TEST_EPS)
    try:
        jrun, _ = _run_cfgs(vecnorm_reward=True)
        tr = jtrainer.SimplePPOSelfPlayTrainer(
            ppo_cfg=jsp_ppo.SimplePPOConfig(batch_size=16), run_cfg=jrun,
            log_fn=lambda *a: None)
        params0 = jax.tree.map(np.array, tr.params)
        tr.ensure_initialized()
        jax.effects_barrier()
        colors0 = np.array(tr.sp_state.pcolor)
        key = jax.random.PRNGKey(0)
        (tr.params, tr.opt_state, tr.sp_state, tr.vecnorm,
         metrics) = tr._train_step(tr.params, tr.opt_state, tr.sp_state,
                                   tr.vecnorm, key)
        jax.effects_barrier()
    finally:
        jdist.MaskedCategorical.sample = real_sample
        jsp.reset_done = real_reset
        jtrainer.make_simple_ppo_optimizer = real_opt
    perms = [np.asarray(jax.random.permutation(k, TN * TT))
             for k in jax.random.split(key, 5)]
    return tr, params0, colors0, uniforms, resets, metrics, perms


def _port_trainer(**kw):
    """The port's trainer of ``_run_cfgs(**kw)``, Adam at ``TEST_EPS`` as
    JAX's in ``_jax_trainer``."""
    _, run = _run_cfgs(**kw)
    tr = SimplePPOSelfPlayTrainer(
        ppo_cfg=simple_ppo.SimplePPOConfig(batch_size=16), run_cfg=run,
        log_fn=lambda *a: None, device="cpu")
    tr.optimizer = Adam(tr.net.parameters(), tr.ppo_cfg.lr, eps=TEST_EPS)
    return tr


def test_trainer_update_equals_jax():
    """One update (N 8, T 8, batch 16, the reward filter on, Adam eps
    ``TEST_EPS``) on JAX's params, draws and permutations: the games and
    colours equal, the pending full-softmax log-probs to 1e-5, each
    parameter's delta within 1e-4 of the leaf's largest, the filter's
    state to 1e-6, the metrics to rtol 1e-5.  The deltas' bound is 1e-4,
    not 1e-5: at N 8 the update's gradients are small sums of larger
    terms (conv0's deltas reach 1.5e-4 at lr 1e-3), and XLA's and
    torch's summation orders part them by up to 5.0e-5 of a leaf's
    largest delta (measured)."""
    jtr, params0, colors0, uniforms, resets, jm, perms = _jax_trainer()
    tr = _port_trainer(vecnorm_reward=True)
    load_flax_params(tr.net, params0)
    tr.draws = sp.InjectedDraws(
        colors=[torch.from_numpy(colors0)] + [torch.from_numpy(c)
                                              for c in resets],
        uniforms=[torch.from_numpy(u) for u in uniforms])
    start = _state(tr.net)
    tr.ensure_initialized()
    m = tr._do_update([torch.from_numpy(p) for p in perms])
    with pytest.raises(StopIteration):      # every recorded draw was used
        tr.draws.uniforms(TN, "cpu")
    np.testing.assert_array_equal(tr.sp_state.pcolor.numpy(),
                                  np.asarray(jtr.sp_state.pcolor))
    np.testing.assert_array_equal(tr.sp_state.pending.action.numpy(),
                                  np.asarray(jtr.sp_state.pending.action))
    np.testing.assert_allclose(tr.sp_state.pending.logp.numpy(),
                               np.asarray(jtr.sp_state.pending.logp),
                               rtol=1e-5, atol=1e-6)
    _assert_steps_close(_state(tr.net),
                         _state(_ac_net(jax.tree.map(np.array, jtr.params))),
                         start, rtol=1e-4)
    for k in ("loss", "episode_return", "episodes"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-6), k
    jvn = jtr.vecnorm
    for got, want in ((tr.vecnorm.ret, jvn.ret),
                      (tr.vecnorm.ret_rms.var, jvn.ret_rms.var),
                      (tr.vecnorm.ret_rms.mean, jvn.ret_rms.mean),
                      (tr.vecnorm.ret_rms.count, jvn.ret_rms.count)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_save_load_bytes_equal_jax_both_ways(tmp_path):
    """With the reward filter on, the checkpoint holds its state under
    ``extra["vecnorm"]``; JAX's file loads into the port and is written
    back byte for byte, and the port's after an update loads into JAX
    and back."""
    jtr = _jax_trainer()[0]
    jtr.update_count = 1
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jtr.save(str(jax_path))
    tr = _port_trainer(vecnorm_reward=True)
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


def test_cli_runs(tmp_path):
    ckpt = str(tmp_path / "sp.msgpack")
    argv = ["--device", "cpu", "--num-envs", "8", "--num-steps", "8",
            "--num-updates", "2", "--num-test-games", "4", "--log-every",
            "1", "--batch-size", "32", "--vecnorm-reward", "--checkpoint",
            ckpt, "--log-dir", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = run_self_play.main(argv)
    text = out.getvalue()
    assert tr.update_count == 2 and "final eval:" in text
    assert "device: cpu; float32" in text and os.path.exists(ckpt)
    assert tr.ppo_cfg.batch_size == 32 and tr.run_cfg.vecnorm_reward
    with contextlib.redirect_stdout(io.StringIO()):
        again = run_self_play.main(
            ["--device", "cpu", "--num-envs", "8", "--num-steps", "8",
             "--num-updates", "0", "--num-test-games", "4", "--load",
             ckpt])
    assert again.update_count == 2
    assert os.path.exists(tmp_path / "metrics.jsonl")
