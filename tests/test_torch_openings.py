"""The training side of the search slice against JAX: the self-play
collector with random openings (``init_rand_steps``), with and without the
lookahead override; ``logp_mode="full"``; the distillation loss and one
update; ``compute_gae_masked``; the trainer's lookahead-mix sequence and
guards; and the new flags of ``cli/ppo_self_play.py``.

Collector parity: JAX's collector is run with its random draws recorded
(``jax.experimental.io_callback`` on its random legal moves and on each
reset's colours and random-opening counts) and the port is given the same
draws (``InjectedDraws``).  The policy is peaked (``ranked``: its choice
does not depend on the sampling uniform) and its value head is the exact
stub of JAX's search tests, so the override's argmax ties break alike.
Then every stored field must be equal (log-probs to 1e-5); the stored
action is the policy's or the override's even where the executed ply was
the random one, as in JAX."""

import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.engine import get_engine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.agents import ppo
from gymothelloenv_tpu_torch.cli import ppo_self_play as cli
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from test_chunked_search import _stub_apply
from test_torch_ppo import (_flax_params, _jax_rollout, _loss_inputs,
                            _port_rollout, _rollout, _state)
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import DiskDiffNet, random_states, to_port

N, T, HIDDEN, INIT = 32, 8, 32, 10
FIELDS = ("obs", "action", "logp", "value", "reward", "done", "legal")
RCFG = EnvConfig(num_disk_as_reward=True)
JRCFG = JaxEnvConfig(num_disk_as_reward=True)


@functools.cache
def _ranked():
    """Flax params whose logits are 200 x a fixed cell ranking: every
    non-maximal legal weight exp(-200 k) underflows to 0."""
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN, width_mult=1)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 8, 8)))
    head = params["params"]["Dense_2"]
    head["kernel"] = jnp.zeros_like(head["kernel"])
    head["bias"] = jnp.asarray(
        200.0 * np.random.RandomState(0).permutation(64), jnp.float32)
    return jnet, params


def _jax_apply(jnet):
    """The ranked logits with the stub's exact value head."""
    def apply_fn(params, obs):
        logits, _, _ = jnet.apply(params, obs)
        return logits, _stub_apply(None, obs)[1], None
    return apply_fn


class _Composite(torch.nn.Module):
    """The port twin of ``_jax_apply``."""

    def __init__(self, policy):
        super().__init__()
        self.policy, self.stub = policy, DiskDiffNet()

    def forward(self, obs):
        return self.policy(obs)[0], self.stub(obs)[1]


def _record(monkeypatch):
    """Patch JAX's random legal move and reset to record, in program
    order, each ply's legal words and random moves and each reset's
    random-opening counts and colours."""
    moves, resets = [], []
    real_move, real_reset = JaxBitEngine.random_legal, jsp.reset_done

    def random_legal(self, keys, state):
        a = real_move(self, keys, state)
        io_callback(lambda w0, w1, a: moves.append(
            (np.stack([w0, w1], -1), np.asarray(a))), None,
            state.legal[0], state.legal[1], a, ordered=True)
        return a

    def reset_done(*args, **kwargs):
        out = real_reset(*args, **kwargs)
        io_callback(lambda rl, pc: resets.append(
            (np.array(rl), np.array(pc))), None, out[1], out[2],
            ordered=True)
        return out

    monkeypatch.setattr(JaxBitEngine, "random_legal", random_legal)
    monkeypatch.setattr(jsp, "reset_done", reset_done)
    return moves, resets


def _legal_index(legal_pair, action):
    """The index of ``action`` among the set bits of each legal word."""
    legal = tb.pack_pair(legal_pair)
    a = torch.from_numpy(action.astype(np.int64)).clamp(0, 63)
    below = (torch.ones_like(a) << a) - 1
    return tb.popcount(legal & below)


@pytest.mark.parametrize("override", [False, True])
def test_collector_with_random_openings_matches_jax(override, monkeypatch):
    """4 rollouts of T=8 at N=32 with init_rand_steps 10, mirror
    self-play; ``override``: the protagonist acts with the argmax
    lookahead (tau 0)."""
    rollouts, seed = 4, 5
    jnet, params = _ranked()
    apply_fn = _jax_apply(jnet)
    moves, resets = _record(monkeypatch)
    j_override = (jsp.make_lookahead_override(JRCFG, 0.0) if override
                  else None)
    init = jax.jit(functools.partial(
        jsp.selfplay_init, apply_fn=apply_fn, cfg=JRCFG, num_envs=N,
        init_rand_steps=INIT, act_override=j_override))
    collect = jax.jit(functools.partial(
        jsp.collect_rollout, apply_fn=apply_fn, cfg=JRCFG, num_steps=T,
        init_rand_steps=INIT, act_override=j_override))
    key = jax.random.PRNGKey(seed)
    jstate = init(params, key=key)
    want = []
    for _ in range(rollouts):
        jstate, roll, _ = collect(params, sp=jstate)
        want.append({f: np.asarray(getattr(roll, f)) for f in FIELDS})
    want = {f: np.concatenate([w[f] for w in want]) for f in FIELDS}
    jax.effects_barrier()

    # selfplay_init's own draws, as JAX makes them.
    _, _, k_color, k_rand = jax.random.split(key, 4)
    rand_left0 = jax.vmap(draw_max_rand_steps, in_axes=(0, None))(
        jax.random.split(k_rand, N), INIT)
    color0 = jax.random.randint(k_color, (N,), 0, 2) * 2 - 1
    assert int(rand_left0.sum()) > 0
    assert len(resets) == rollouts * T
    draws = sp.InjectedDraws(
        colors=[torch.from_numpy(np.array(color0))]
        + [torch.from_numpy(pc) for _, pc in resets],
        uniforms=itertools.repeat(torch.full((N,), 0.5)),
        rand_left=[torch.from_numpy(np.array(rand_left0))]
        + [torch.from_numpy(rl) for rl, _ in resets],
        legal_index=[_legal_index(w, a) for w, a in moves])
    net = _Composite(policy_net_from_flax(params, 1, HIDDEN, device="cpu"))
    ov = sp.make_lookahead_override(RCFG, 0.0) if override else None
    state = sp.selfplay_init(net, RCFG, N, draws, INIT, device="cpu",
                             act_override=ov)
    got = []
    for _ in range(rollouts):
        state, roll, _ = sp.collect_rollout(net, state, RCFG, T, draws,
                                            INIT, act_override=ov)
        got.append({f: getattr(roll, f).numpy() for f in FIELDS})
    got = {f: np.concatenate([g[f] for g in got]) for f in FIELDS}
    assert want["done"].sum() >= N // 2          # resets were exercised
    for f in ("obs", "action", "value", "reward", "done", "legal"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["logp"], want["logp"], atol=1e-5, rtol=0)
    for f in ("rand_left", "pcolor"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    np.testing.assert_array_equal(state.env.turn.numpy(),
                                  np.asarray(jstate.env.turn))
    with pytest.raises(StopIteration):     # every recorded draw was used
        draws.legal_index(torch.zeros(N, dtype=torch.int64))


def test_policy_sample_full_and_masked_logp_match_jax():
    """``logp_mode="full"`` (the full softmax's log-prob) and "masked"
    at the same actions (fixed through the override hook) agree with JAX
    to 1e-6."""
    jnet, params = _flax_params(2)
    apply_fn = jtrainer.make_apply_fn(jnet)
    jstate = random_states(24, 3, max_plies=40)
    legal = np.asarray(get_engine(JRCFG).legal_flat(jstate))
    rng = np.random.RandomState(1)
    action = np.array([rng.choice(np.nonzero(row)[0]) if row.any() else 0
                       for row in legal])
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 24)
    fixed = jnp.asarray(action, jnp.int32)
    for mode in ("full", "masked"):
        _, _, a, want, _ = jax.jit(lambda s, k: jsp.policy_sample(
            params, apply_fn, get_engine(JRCFG), s, k, mode,
            lambda *args: fixed))(jstate, keys)
        _, _, b, got, _ = sp.policy_sample(
            net, to_port(jstate), None, mode,
            lambda *args: torch.from_numpy(action))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0, err_msg=mode)
    with pytest.raises(ValueError, match="logp_mode"):
        sp.policy_sample(net, to_port(jstate), None, "entropy")


def test_distill_loss_terms_match_jax():
    """The action loss is -mean(logp) of the taken action; every term to
    1e-6 of JAX's."""
    flat, logits, values, adv, ret = _loss_inputs(4)
    want_total, want = jppo.ppo_loss_terms(
        jnp.asarray(logits), jnp.asarray(values),
        jppo.Transition(**{k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(adv), jnp.asarray(ret), jppo.PPOConfig(distill=True))
    total, got = ppo.ppo_loss_terms(
        torch.from_numpy(logits), torch.from_numpy(values),
        _port_rollout(flat), torch.from_numpy(adv), torch.from_numpy(ret),
        ppo.PPOConfig(distill=True))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
    for name in ("value_loss", "action_loss", "entropy"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-6, err_msg=name)


def test_distill_update_step_matches_jax():
    """One optimizer step (1 epoch, 1 minibatch) of the distill update:
    parameter deltas to 1e-6 of JAX's, metrics to rtol 1e-6."""
    jnet, params = _flax_params(0)
    apply_fn = jtrainer.make_apply_fn(jnet)
    kw = dict(lr=3e-4, num_updates=1, ppo_epochs=1, num_mini_batch=1,
              distill=True)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    d = _rollout(9)
    boot = np.random.RandomState(2).randn(d["value"].shape[1]).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jopt = jppo.make_optimizer(jcfg)
    new_params, _, jmetrics = jax.jit(
        jppo.ppo_update, static_argnums=(5, 6, 7))(
        params, jopt.init(params), _jax_rollout(d), jnp.asarray(boot), key,
        apply_fn, jopt, jcfg)
    words = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                      for k in jax.random.split(key, 1)])
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu").train()
    before = _state(net)
    metrics = ppo.ppo_update(net, ppo.make_optimizer(cfg, net.parameters()),
                             _port_rollout(d), torch.from_numpy(boot),
                             torch.from_numpy(words.astype(np.int64)), cfg)
    want = _state(policy_net_from_flax(new_params, 1, HIDDEN, device="cpu"))
    for name, value in _state(net).items():
        np.testing.assert_allclose((value - before[name]).numpy(),
                                   (want[name] - before[name]).numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    for name in ("value_loss", "action_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.97, 0.9)])
def test_gae_masked_bit_equal_to_jax(gamma, lam):
    rng = np.random.RandomState(int(gamma * 100))
    Tn, Nn = 24, 64
    d = dict(value=(rng.randn(Tn, Nn) * 10).astype(np.float32),
             reward=(rng.randn(Tn, Nn) * (rng.rand(Tn, Nn) < 0.2)
                     * 30).astype(np.float32),
             done=rng.rand(Tn, Nn) < 0.1)
    weights = (rng.rand(Tn, Nn) < 0.7).astype(np.float32)
    boot = rng.randn(Nn).astype(np.float32)
    jroll = jppo.Transition(obs=None, action=None, logp=None, legal=None,
                            **{k: jnp.asarray(v) for k, v in d.items()})
    want = jax.jit(jppo.compute_gae_masked, static_argnums=3)(
        jroll, jnp.asarray(weights), jnp.asarray(boot),
        jppo.PPOConfig(gamma=gamma, gae_lambda=lam))
    roll = ppo.Transition(obs=None, action=None, logp=None, legal=None,
                          **{k: torch.from_numpy(v) for k, v in d.items()})
    got = ppo.compute_gae_masked(roll, torch.from_numpy(weights),
                                 torch.from_numpy(boot),
                                 ppo.PPOConfig(gamma=gamma, gae_lambda=lam))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _tiny(**run):
    return PPOSelfPlayTrainer(
        env_cfg=RCFG, ppo_cfg=ppo.PPOConfig(num_updates=4),
        run_cfg=SelfPlayConfig(num_envs=8, num_steps=4, hidden_size=32,
                               test_interval=10 ** 6, **run),
        log_fn=lambda *a: None, device="cpu")


@pytest.mark.parametrize("mix", [0.1, 0.25, 0.5, 1.0])
def test_mix_sequence_matches_jax(mix):
    """100 updates of JAX's ``_pick_step`` Bresenham accumulator, run on
    its own method, against the port's ``_pick_lookahead``."""
    jax_self = types.SimpleNamespace(
        _train_step="lookahead", _mix_err=0.0,
        _train_step_plain=None if mix == 1.0 else "plain",
        run_cfg=jtrainer.SelfPlayConfig(lookahead_collect=True,
                                        lookahead_mix=mix))
    want = [jtrainer.PPOSelfPlayTrainer._pick_step(jax_self) == "lookahead"
            for _ in range(100)]
    tr = _tiny(lookahead_collect=True, lookahead_mix=mix)
    assert [tr._pick_lookahead() for _ in range(100)] == want
    assert sum(want) == round(100 * mix)
    assert not any(_tiny()._pick_lookahead() for _ in range(8))


@pytest.mark.parametrize("run", [
    dict(frame_stack=2, lookahead_collect=True),
    dict(max_episode_plies=30, lookahead_collect=True),
    dict(lookahead_collect=True, lookahead_mix=0.0),
    dict(lookahead_collect=True, lookahead_mix=1.5),
    dict(lookahead_collect=True, lookahead_mix=0.5, chain_updates=2)])
def test_trainer_guards_match_jax(run):
    """The same ValueError and message as JAX's trainer."""
    with pytest.raises(ValueError) as want:
        jtrainer.PPOSelfPlayTrainer(
            env_cfg=JRCFG, ppo_cfg=jppo.PPOConfig(num_updates=4),
            run_cfg=jtrainer.SelfPlayConfig(num_envs=8, hidden_size=16,
                                            **run),
            log_fn=lambda *a: None)
    with pytest.raises(ValueError) as got:
        _tiny(**run)
    assert str(got.value) == str(want.value)


def test_trainer_mix_recipe_then_distill():
    """The mix-0.25 recipe's knobs at a tiny size: updates 1-3 collect
    plainly, update 4 with the override; then a distill update at tau 2
    with every collection overridden.  Finite losses, moved params."""
    logged = []
    tr = PPOSelfPlayTrainer(
        env_cfg=RCFG,
        ppo_cfg=ppo.PPOConfig(lr=5e-5, ppo_epochs=2, num_mini_batch=2,
                              use_linear_lr_decay=False),
        run_cfg=SelfPlayConfig(num_envs=8, num_steps=4, hidden_size=32,
                               test_interval=10 ** 6, init_rand_steps=INIT,
                               lookahead_collect=True, lookahead_tau=1.0,
                               lookahead_mix=0.25),
        log_fn=lambda step, m: logged.append(m), device="cpu")
    before = _state(tr.net)
    tr.train(4, log_every=1)
    assert [m["lookahead"] for m in logged] == [0.0, 0.0, 0.0, 1.0]
    assert int(tr.sp_state.rand_left.max()) <= INIT
    tr2 = _tiny(lookahead_collect=True, lookahead_tau=2.0)
    tr2.ppo_cfg = ppo.PPOConfig(num_updates=4, distill=True)
    tr2.train(1, log_every=1)
    for m in logged:
        assert all(np.isfinite(m[k]) for k in ("value_loss", "action_loss"))
    assert any(not torch.equal(v, before[k])
               for k, v in _state(tr.net).items())


def test_cli_runs_the_search_flags():
    trainer = cli.main(["--device", "cpu", "--num-envs", "8",
                        "--num-steps", "4", "--num-updates", "2",
                        "--hidden-size", "32", "--num-test-games", "4",
                        "--init-rand-steps", "4", "--lookahead-collect",
                        "--lookahead-mix", "0.5", "--lookahead-tau", "1.0",
                        "--distill"])
    assert trainer.update_count == 2 and trainer.ppo_cfg.distill
    run = trainer.run_cfg
    assert (run.init_rand_steps, run.lookahead_collect, run.lookahead_mix,
            run.lookahead_tau) == (4, True, 0.5, 1.0)
