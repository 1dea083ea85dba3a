"""The port's self-play collector against ``gymothelloenv_tpu.train.
self_play.collect_rollout`` (mirror self-play, no random openings).

Exact parity: a peaked deterministic policy, whose sampled action does not
depend on the uniform, plays the same games on both sides once the port is
given JAX's protagonist colours (read back from the turn plane of the
emitted observations).  ``obs``/``action``/``reward``/``done``/``legal``
must then be equal; ``logp``/``value`` agree to fp32 tolerance.
Statistical parity: with a sampling net the two collectors' episode
length, terminal reward and colour balance agree within 4 standard
errors."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train.ppo_trainer import make_apply_fn
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.train import self_play as sp
from torch_port_helpers import one_torch_thread  # noqa: F401

N, T, HIDDEN = 32, 8, 32
FIELDS = ("obs", "action", "logp", "value", "reward", "done", "legal")


@functools.cache
def _jax_fns():
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN, width_mult=1)
    apply_fn = make_apply_fn(jnet)
    cfg = JaxEnvConfig(num_disk_as_reward=True)
    init = jax.jit(functools.partial(jsp.selfplay_init, apply_fn=apply_fn,
                                     cfg=cfg, num_envs=N))
    collect = jax.jit(functools.partial(jsp.collect_rollout,
                                        apply_fn=apply_fn, cfg=cfg,
                                        num_steps=T))
    return jnet, init, collect


def _params(kind, seed=0):
    """``ranked``: zero logits kernel, bias 200 x a fixed cell ranking (every
    non-maximal legal weight exp(-200 k) underflows to 0).  ``sharp``: the
    seeded head times 1e9: state-dependent, and its top-two logit gap
    is far above 104 (where exp underflows) on these seeds.  ``sampling``:
    the head times 100, O(1) logits."""
    jnet = _jax_fns()[0]
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)))
    head = params["params"]["Dense_2"]
    if kind == "ranked":
        rank = np.random.RandomState(seed).permutation(64)
        head["kernel"] = jnp.zeros_like(head["kernel"])
        head["bias"] = jnp.asarray(200.0 * rank, jnp.float32)
    else:
        scale = {"sharp": 1e9, "sampling": 100.0}[kind]
        head["kernel"] = head["kernel"] * scale
    return params


def _jax_collect(params, rollouts, seed, opp_params=None):
    _, init, collect = _jax_fns()
    state = init(params, key=jax.random.PRNGKey(seed),
                 opp_params=opp_params)
    out = []
    for _ in range(rollouts):
        state, roll, _ = collect(params, sp=state, opp_params=opp_params)
        out.append({f: np.asarray(getattr(roll, f)) for f in FIELDS})
    joined = {f: np.concatenate([o[f] for o in out]) for f in FIELDS}
    return state, joined


def _port_collect(net, rollouts, draws, opp_net=None):
    cfg = EnvConfig(num_disk_as_reward=True)
    state = sp.selfplay_init(net, cfg, N, draws, device="cpu",
                             opp_net=opp_net)
    out = []
    for _ in range(rollouts):
        state, roll, boot = sp.collect_rollout(net, state, cfg, T, draws,
                                               opp_net=opp_net)
        assert torch.equal(boot, state.pending.value)
        out.append({f: getattr(roll, f).numpy() for f in FIELDS})
    joined = {f: np.concatenate([o[f] for o in out]) for f in FIELDS}
    return state, joined


def _colour(obs):
    """Protagonist colour of each slot: the turn plane (plane 2) of its
    observation is (turn + 1) / 2, and the protagonist is to move."""
    return torch.from_numpy(2 * obs[:, 2, 0, 0].astype(np.int8) - 1)


@pytest.mark.parametrize("kind,opponent", [("ranked", None),
                                           ("sharp", None),
                                           ("sharp", "ranked"),
                                           ("ranked", "sharp")])
def test_collector_matches_jax_exactly(kind, opponent):
    """5 rollouts of T=8 at N=32 (40 slots: most games end and reset),
    mirror self-play or against a frozen opponent of another kind and
    seed (JAX's ``opp_params``, the port's ``opp_net``).
    Tolerance: exact for obs/action/reward/done/legal; atol 1e-5 for
    logp/value (fp32 forward on both sides, summed in other orders)."""
    rollouts = 5
    params = _params(kind)
    opp = None if opponent is None else _params(opponent, seed=1)
    jstate, want = _jax_collect(params, rollouts, seed=3, opp_params=opp)
    colours = [_colour(o) for o in want["obs"]]
    colours.append(_colour(np.asarray(jstate.pending.obs)))
    draws = sp.InjectedDraws(colours,
                             itertools.repeat(torch.full((N,), 0.5)))
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu")
    opp_net = (None if opp is None else
               policy_net_from_flax(opp, 1, HIDDEN, device="cpu"))
    state, got = _port_collect(net, rollouts, draws, opp_net)
    assert want["done"].sum() >= N // 2          # resets were exercised
    for f in ("obs", "action", "reward", "done", "legal"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["obs"].dtype == np.int8
    for f in ("logp", "value"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-5, rtol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(state.pcolor.numpy(),
                                  np.asarray(jstate.pcolor))
    np.testing.assert_array_equal(state.env.turn.numpy(),
                                  np.asarray(jstate.env.turn))
    assert state.host_syncs >= 2 * rollouts * T


def _episode_stats(roll):
    """Per finished episode: transitions, terminal reward, colour."""
    done, reward = roll["done"], roll["reward"]
    colour = 2 * roll["obs"][:, :, 2, 0, 0].astype(np.int64) - 1
    lengths, rewards, colours = [], [], []
    for n in range(done.shape[1]):
        start = 0
        for t in np.nonzero(done[:, n])[0]:
            lengths.append(t + 1 - start)
            rewards.append(reward[t, n])
            colours.append(colour[t, n])
            start = t + 1
    return {"length": np.array(lengths, float),
            "reward": np.array(rewards, float),
            "white": (np.array(colours) == 1).astype(float)}


def test_collector_statistics_match_jax():
    """12 rollouts of T=8 at N=32 on each side (~90 finished episodes).
    Mean transitions per episode, mean terminal reward and the share of
    white protagonists agree within 4 standard errors of the difference.
    Rewards off-terminal are 0 on both sides."""
    rollouts = 12
    params = _params("sampling", seed=1)
    _, jroll = _jax_collect(params, rollouts, seed=5)
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu")
    draws = sp.Draws(torch.Generator().manual_seed(5))
    _, proll = _port_collect(net, rollouts, draws)
    for roll in (jroll, proll):
        assert not roll["reward"][~roll["done"]].any()
    js, ps = _episode_stats(jroll), _episode_stats(proll)
    assert len(js["length"]) > 60 and len(ps["length"]) > 60
    for name in ("length", "reward", "white"):
        a, b = js[name], ps[name]
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        assert abs(a.mean() - b.mean()) <= 4 * se, (
            name, a.mean(), b.mean(), se)


def test_advance_opponent_is_bounded(monkeypatch):
    """A state the opponent never leaves raises instead of looping."""
    cfg = EnvConfig(num_disk_as_reward=True)
    net = policy_net_from_flax(_params("sampling"), 1, HIDDEN, device="cpu")
    draws = sp.Draws(torch.Generator().manual_seed(0))
    state = sp.selfplay_init(net, cfg, 4, draws, device="cpu")
    monkeypatch.setattr(sp, "masked_step", lambda env, a, do, c: env)
    with pytest.raises(RuntimeError, match="opponent still to move"):
        sp.advance_opponent(net, state.env, -state.env.turn, cfg, draws)


@pytest.mark.parametrize("kw", [dict(init_rand_steps=2),
                                dict(logp_mode="full")])
def test_unported_collector_options_raise(kw):
    net = policy_net_from_flax(_params("sampling"), 1, HIDDEN, device="cpu")
    draws = sp.Draws(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        sp.selfplay_init(net, EnvConfig(), 4, draws, device="cpu", **kw)
