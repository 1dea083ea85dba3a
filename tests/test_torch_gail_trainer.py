"""The port's GAIL trainer (``train/gail_trainer.py``) and CLI
(``cli/gail_train.py``) against JAX's: two updates of
``GAILPPOTrainer`` from JAX's params with its collector's draws, its
policy rows, its mixup weights and its PPO shuffle words injected (the
expert rows come from the same ``RandomState``), with a non-zero return
accumulator and a ``last_done`` carried into the second update; the BC
warm-start's losses and params; ``chain_updates``' expert stacks; the
refusals with JAX's messages; and the CLI.

The discriminator's and the BC warm-start's Adam run at eps 1e-3
(``TEST_EPS``) on both sides in the whole-update comparisons: at optax's
default 1e-8 an entry whose gradient is near 0 steps by up to
``lr * sign(g)``, so XLA's and torch's float32 sums move single entries
by ~lr (measured: 3.8e-4 of the discriminator's largest step over two
updates, 5.2e-4 of a BC leaf's largest delta over three steps).  The
steps at the default eps are held to optax on one step in
``tests/test_torch_gail.py`` and ``tests/test_torch_simple_ppo.py``.

Draw injection: JAX's ``MaskedCategorical.sample`` and the collector's
``reset_done`` are patched to record their draws by ``io_callback`` in
program order (as ``tests/test_torch_a2c.py``); the policy rows, the
mixup weights and the shuffle words are rebuilt from the update's key as
JAX derives them."""

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

from gymothelloenv_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.train import gail_trainer as jgail_trainer
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import gail_train
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import load_flax_params
from gymothelloenv_tpu_torch.scripts import make_expert_dataset
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.gail_trainer import (GAILPPOTrainer,
                                                        GAILRunConfig)
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from torch_port_helpers import one_torch_thread  # noqa: F401

TN, TT, HIDDEN = 8, 8, 32   # games, rollout length, the policy's width
EPOCH, MB = 2, 8            # discriminator steps an update, rows a step
TEST_EPS = 1e-3             # the discriminator's and BC's Adam eps


@contextlib.contextmanager
def _adam_eps():
    """optax ``adam`` and the port's ``Adam`` in the GAIL modules at
    ``TEST_EPS`` unless given one (PPO's optimizers pass theirs)."""
    import optax
    from gymothelloenv_tpu_torch.agents import gail as pgail
    from gymothelloenv_tpu_torch.train import gail_trainer as pgt
    real = optax.adam, pgail.Adam, pgt.Adam
    optax.adam = functools.partial(real[0], eps=TEST_EPS)
    pgail.Adam = functools.partial(real[1], eps=TEST_EPS)
    pgt.Adam = functools.partial(real[2], eps=TEST_EPS)
    try:
        yield
    finally:
        optax.adam, pgail.Adam, pgt.Adam = real


@pytest.fixture(scope="module")
def expert(tmp_path_factory):
    """An expert npz of three maximin-1 games (the port's script)."""
    path = str(tmp_path_factory.mktemp("expert") / "expert.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        make_expert_dataset.main(["--games", "3", "--search-depth", "1",
                                  "--device", "cpu", "--out", path])
    return path


def _cfgs(**run):
    kw = dict(num_envs=TN, num_steps=TT, hidden_size=HIDDEN,
              num_test_games=4, test_interval=10 ** 6, seed=7, **run)
    gr = dict(gail_epoch=EPOCH, gail_batch_size=MB, num_trajectories=3,
              subsample_frequency=2)
    return ((jppo_trainer.SelfPlayConfig(**kw),
             jgail_trainer.GAILRunConfig(**gr)),
            (SelfPlayConfig(**kw), GAILRunConfig(**gr)))


PPO_KW = dict(lr=3e-4, num_updates=10)
KEYS = (jax.random.PRNGKey(0), jax.random.PRNGKey(1))
LAST_DONE = np.array([1, 0, 1, 1, 0, 0, 0, 1], bool)


def _key_draws(key):
    """The policy rows, mixup weights and PPO shuffle words of one JAX
    update's key (gail_trainer.py:83-157's splits)."""
    k_disc, k_ppo = jax.random.split(key)
    rows, alphas = [], []
    for k in jax.random.split(k_disc, EPOCH):
        k_idx, k_gp = jax.random.split(k)
        rows.append(np.asarray(jax.random.randint(k_idx, (MB,), 0,
                                                  TN * TT)))
        alphas.append(np.asarray(jax.random.uniform(k_gp, (MB, 1)))[:, 0])
    words = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                      for k in jax.random.split(k_ppo, 4)])
    return rows, alphas, words.astype(np.int64)


@pytest.fixture(scope="module")
def jax_run(expert):
    """JAX's trainer through two updates with every collector draw
    recorded; the return accumulator at 2.0 before the first, and
    ``LAST_DONE`` as the carry before the second.  Returns the initial
    params, colours, draws and each update's state."""
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
        ctx = contextlib.ExitStack()
        ctx.enter_context(_adam_eps())
        (jrun, jgr), _ = _cfgs()
        tr = jgail_trainer.GAILPPOTrainer(
            expert_path=expert, gail_run=jgr,
            env_cfg=JaxEnvConfig(num_disk_as_reward=True),
            ppo_cfg=JaxPPOConfig(**PPO_KW), run_cfg=jrun,
            log_fn=lambda *a: None)
        init = dict(params=jax.tree.map(np.array, tr.params),
                    disc=jax.tree.map(np.array, tr.gail_state.params))
        tr.ensure_initialized()
        jax.effects_barrier()
        init["colors"] = np.array(tr.sp_state.pcolor)
        tr.gail_state = tr.gail_state.replace(
            returns=jnp.full((TN,), 2.0))
        steps = []
        for u, key in enumerate(KEYS):
            if u == 1:
                tr._last_done = jnp.asarray(LAST_DONE)
            metrics = tr._do_update(key)
            jax.effects_barrier()
            g = tr.gail_state
            steps.append(dict(
                params=jax.tree.map(np.array, tr.params),
                disc=jax.tree.map(np.array, g.params),
                returns=np.array(g.returns), rms=(np.array(g.ret_rms.mean),
                                                  np.array(g.ret_rms.var),
                                                  np.array(g.ret_rms.count)),
                last_done=np.array(tr._last_done),
                pcolor=np.array(tr.sp_state.pcolor),
                metrics={k: float(v) for k, v in metrics.items()}))
    finally:
        ctx.close()
        jdist.MaskedCategorical.sample = real_sample
        jsp.reset_done = real_reset
    return init, uniforms, resets, steps


def _trainer(expert, **run):
    _, (run_cfg, gr) = _cfgs(**run)
    return GAILPPOTrainer(expert_path=expert, gail_run=gr,
                          env_cfg=EnvConfig(num_disk_as_reward=True),
                          ppo_cfg=PPOConfig(**PPO_KW), run_cfg=run_cfg,
                          log_fn=lambda *a: None, device="cpu")


def _assert_deltas_close(net, before, want_tree, rtol):
    """Each parameter's delta within ``rtol`` of the leaf's largest, plus
    one float32 spacing of the parameter."""
    want = type(net)(**_ctor(net))
    load_flax_params(want, want_tree)
    for k, w in want.state_dict().items():
        wd = w - before[k]
        gd = net.state_dict()[k] - before[k]
        big = float(wd.abs().max())
        if big == 0:                  # a leaf the update does not train
            assert not bool(gd.any()), k
            continue
        err = float(((gd - wd).abs() - 2.0 ** -23 * w.abs()).max()) / big
        assert err <= rtol, (k, err)


def _ctor(net):
    if hasattr(net, "fc0"):
        return dict(input_dim=net.fc0.in_features,
                    hidden_dim=net.fc0.out_features)
    return dict(hidden_size=HIDDEN)


def test_two_updates_equal_jax(expert, jax_run):
    """Both updates on JAX's draws (the discriminator's Adam at
    ``TEST_EPS``): the games' colours and ``last_done`` equal; the
    discriminator's steps within 1e-4 of each leaf's largest (measured
    3.9e-5: two steps an update on gradients through the penalty's
    double backward; one step is held to 1e-5 in
    ``tests/test_torch_gail.py``);
    the accumulator and running moments within 1e-5 (relative, and
    absolute near 0); the policy's deltas
    within 1e-3 of each leaf's largest (measured 4.8e-4 on
    ``logits.weight``: PPO's 16 clipped, norm-clipped Adam steps at eps
    1e-5 on relabelled rewards that agree to ~1e-6; ``ppo_update`` alone
    is held to JAX's in ``tests/test_torch_ppo.py``); the metrics to rtol
    1e-4."""
    init, uniforms, resets, steps = jax_run
    with _adam_eps():
        tr = _trainer(expert)
    load_flax_params(tr.net, init["params"])
    load_flax_params(tr.gail_state.net, init["disc"])
    draws = [_key_draws(k) for k in KEYS]
    tr.draws = sp.InjectedDraws(
        colors=[torch.from_numpy(init["colors"])]
        + [torch.from_numpy(c) for c in resets],
        uniforms=[torch.from_numpy(u) for u in uniforms],
        row_indices=[torch.from_numpy(r) for d in draws for r in d[0]],
        mix_uniforms=[torch.from_numpy(a) for d in draws for a in d[1]])
    tr.ensure_initialized()
    tr.gail_state.returns = torch.full((TN,), 2.0)
    for u, want in enumerate(steps):
        if u == 1:
            tr._last_done = torch.from_numpy(LAST_DONE)
        before = {k: v.clone() for k, v in tr.net.state_dict().items()}
        d_before = {k: v.clone()
                    for k, v in tr.gail_state.net.state_dict().items()}
        m = tr.gail_update(tr.sample_expert(),
                           torch.from_numpy(draws[u][2]))
        np.testing.assert_array_equal(tr.sp_state.pcolor.numpy(),
                                      want["pcolor"])
        np.testing.assert_array_equal(tr._last_done.numpy(),
                                      want["last_done"])
        _assert_deltas_close(tr.gail_state.net, d_before, want["disc"], 1e-4)
        _assert_deltas_close(tr.net, before, want["params"], 1e-3)
        g = tr.gail_state
        for got, w in ((g.returns, want["returns"]),
                       (g.ret_rms.mean, want["rms"][0]),
                       (g.ret_rms.var, want["rms"][1]),
                       (g.ret_rms.count, want["rms"][2])):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)
        for k in ("disc_loss", "gail_reward", "value_loss", "action_loss",
                  "entropy", "episodes"):
            assert float(m[k]) == pytest.approx(want["metrics"][k],
                                                rel=1e-4, abs=1e-6), (u, k)
    with pytest.raises(StopIteration):          # every draw was used
        tr.draws.row_indices(MB, TN * TT, "cpu")


def test_bc_warmstart_equals_jax(expert):
    """Three BC steps (batch 16, lr 1e-3, Adam eps ``TEST_EPS``) from
    JAX's params on the same expert rows: each logged loss to rtol 1e-5
    and the params' deltas within 1e-4 of each leaf's largest; the
    trainer's own optimizer and the value head are untouched."""
    (jrun, jgr), _ = _cfgs()
    jtr = jgail_trainer.GAILPPOTrainer(
        expert_path=expert, gail_run=jgr,
        env_cfg=JaxEnvConfig(num_disk_as_reward=True),
        ppo_cfg=JaxPPOConfig(**PPO_KW), run_cfg=jrun)
    tr = _trainer(expert)
    load_flax_params(tr.net, jax.tree.map(np.array, jtr.params))
    logs = {"jax": [], "port": []}
    jtr.log_fn = lambda step, m: logs["jax"].append((step, m["bc_loss"]))
    tr.log_fn = lambda step, m: logs["port"].append((step, m["bc_loss"]))
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    with _adam_eps():
        jtr.bc_warmstart(3, batch_size=16, lr=1e-3, log_every=1)
        tr.bc_warmstart(3, batch_size=16, lr=1e-3, log_every=1)
    assert [s for s, _ in logs["port"]] == [s for s, _ in logs["jax"]] == [
        -2, -1, 0]
    for (_, got), (_, want) in zip(logs["port"], logs["jax"]):
        assert got == pytest.approx(float(want), rel=1e-5)
    _assert_deltas_close(tr.net, before, jax.tree.map(np.array, jtr.params),
                         1e-4)
    assert torch.equal(tr.net.value.weight, before["value.weight"])
    assert not tr.optimizer.adam.state


def test_chain_updates_take_one_expert_stack_each(expert):
    tr = _trainer(expert, chain_updates=2)
    rng = np.random.RandomState(tr.run_cfg.seed)
    tr.train(2, log_every=100)
    assert tr.update_count == 2
    for _ in range(2 * EPOCH):
        tr.expert.sample(rng, MB)
    assert rng.randint(10 ** 9) == tr.np_rng.randint(10 ** 9)


@pytest.mark.parametrize("field", (dict(recurrent=True), dict(frame_stack=2),
                                   dict(max_episode_plies=8)))
def test_trainer_refuses_what_jax_refuses(expert, field):
    (jrun, jgr), (run, gr) = _cfgs(**field)
    with pytest.raises(ValueError) as jerr:
        jgail_trainer.GAILPPOTrainer(expert_path=expert, gail_run=jgr,
                                     run_cfg=jrun)
    with pytest.raises(ValueError) as err:
        GAILPPOTrainer(expert_path=expert, gail_run=gr, run_cfg=run,
                       device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="item 13"):
        GAILPPOTrainer(expert_path=expert, mesh=object(), device="cpu")


def test_cli_runs(expert, tmp_path):
    ckpt = str(tmp_path / "gail.msgpack")
    argv = ["--device", "cpu", "--expert", expert, "--num-envs", "8",
            "--num-steps", "8", "--num-updates", "2", "--num-test-games",
            "4", "--log-every", "1", "--bc-updates", "2",
            "--gail-batch-size", "8", "--num-trajectories", "3",
            "--checkpoint", ckpt, "--log-dir", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = gail_train.main(argv)
    text = out.getvalue()
    assert tr.update_count == 2 and os.path.exists(ckpt)
    assert "BC warm-start eval:" in text and "final eval:" in text
    assert f"expert rows: {len(tr.expert)}" in text
    assert "device: cpu; float32" in text
    assert tr.ppo_cfg.lr == 1e-5 and tr.ppo_cfg.num_updates == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert any("disc_loss" in line for line in lines)
    assert any("bc_loss" in line for line in lines)
