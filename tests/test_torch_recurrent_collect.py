"""The recurrent slice's games and updates against ``gymothelloenv_tpu``:
the recurrent collector (mirror, and with a frozen opponent), the
time-limited collector, ``ppo_update_recurrent`` (the batched-trunk path
and the frame-stack cell's whole-forward path), ``play_games_recurrent``
with the sampling cell and with the recurrent lookahead, and the
lookahead cell on its own.

JAX's random draws are recorded with ``io_callback`` (its random legal
moves and resets, as ``test_torch_openings.py`` does; in the evaluation
games, the states each ply, from which the test rebuilds JAX's key chain
and random moves) and injected into the port (``InjectedDraws``).  The
sampling policies are peaked (``ranked``: the choice does not depend on
the sampling noise).  Then the games are equal: every stored field
exactly, log-probs, values and hidden states to 1e-5 (float32 in other
orders)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.policies.scripted import greedy_policy as jgreedy
from gymothelloenv_tpu.policies.scripted import random_action
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.agents import ppo
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.models.nets import FrameStackCell
from gymothelloenv_tpu_torch.policies.scripted import greedy_policy
from gymothelloenv_tpu_torch.train import ppo_trainer as trainer
from gymothelloenv_tpu_torch.train import self_play as sp
from test_torch_openings import _legal_index, _record
from test_torch_ppo import _rollout
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import othello_state, random_states, to_port

N, T, HIDDEN, INIT = 16, 8, 32, 10
FIELDS = ("obs", "action", "logp", "value", "reward", "done", "legal")
EXACT = ("obs", "action", "reward", "done", "legal")
TOL = dict(atol=1e-5, rtol=1e-5)
RCFG = EnvConfig(num_disk_as_reward=True)
JRCFG = JaxEnvConfig(num_disk_as_reward=True)


def _recurrent_params(seed, ranked):
    """Flax params of a recurrent net (hidden 32); ``ranked``: its logits
    are 200 x a fixed cell ranking whatever the input or hidden state, so
    every non-maximal legal weight exp(-200 k) underflows to 0."""
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN, recurrent=True)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 4, 8, 8)),
                                jnp.zeros((1, HIDDEN)), jnp.ones((1,)))
    params = jax.tree.map(np.array, params)
    head = params["params"]["Dense_2"]
    if ranked:
        head["kernel"] = np.zeros_like(head["kernel"])
        head["bias"] = (200.0 * np.random.RandomState(seed).permutation(64)
                        ).astype(np.float32)
    else:
        head["kernel"] = head["kernel"] * 100.0
    params["params"]["Dense_1"]["kernel"] *= 20.0    # values apart
    return jnet, params


def _injected(key, init, resets, moves):
    """``InjectedDraws`` for a port collector: JAX's init colours and
    random-opening counts (recomputed from ``key`` as
    ``selfplay_init*`` draws them), then the recorded resets and random
    moves."""
    _, _, k_color, k_rand = jax.random.split(key, 4)
    rand_left0 = jax.vmap(draw_max_rand_steps, in_axes=(0, None))(
        jax.random.split(k_rand, N), init)
    color0 = jax.random.randint(k_color, (N,), 0, 2) * 2 - 1
    return sp.InjectedDraws(
        colors=[torch.from_numpy(np.array(color0))]
        + [torch.from_numpy(pc) for _, pc in resets],
        uniforms=itertools.repeat(torch.full((N,), 0.5)),
        rand_left=[torch.from_numpy(np.array(rand_left0))]
        + ([torch.from_numpy(rl) for rl, _ in resets] if init else []),
        legal_index=[_legal_index(w, a) for w, a in moves])


def _compare_rollout(got, want, label):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {label}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{f} {label}", **TOL)


@pytest.mark.parametrize("init,with_opp", [(INIT, False), (0, True)])
def test_recurrent_collector_matches_jax(init, with_opp, monkeypatch):
    """4 rollouts of T=12 at N=16: the same games, ``h0``, ``masks``,
    bootstrap values and both hidden streams.  ``init``: random opening
    plies; ``with_opp``: a second ranked net plays the non-learning
    colour (its stream advances only on its own plies)."""
    jnet, params = _recurrent_params(0, True)
    opp = _recurrent_params(1, True)[1] if with_opp else None
    apply_fn = jtrainer.make_apply_fn_recurrent(jnet)
    moves, resets = _record(monkeypatch)
    init_fn = jax.jit(functools.partial(
        jsp.selfplay_init_recurrent, apply_fn=apply_fn, cfg=JRCFG,
        num_envs=N, hidden_size=HIDDEN, init_rand_steps=init))
    collect = jax.jit(functools.partial(
        jsp.collect_rollout_recurrent, apply_fn=apply_fn, cfg=JRCFG,
        num_steps=12, init_rand_steps=init))
    key = jax.random.PRNGKey(5)
    jstate = init_fn(params, key=key, opp_params=opp)
    want = [collect(params, sp=jstate, opp_params=opp)]
    for _ in range(3):
        want.append(collect(params, sp=want[-1][0], opp_params=opp))
    jax.effects_barrier()

    draws = _injected(key, init, resets, moves)
    net = policy_net_from_flax(params, device="cpu")
    opp_net = policy_net_from_flax(opp, device="cpu") if with_opp else None
    state = sp.selfplay_init_recurrent(net, RCFG, N, HIDDEN, draws, init,
                                       opp_net=opp_net, device="cpu")
    ends = 0
    for r, (jstate, jroll, jh0, jmasks, jboot) in enumerate(want):
        state, roll, h0, masks, boot = sp.collect_rollout_recurrent(
            net, state, RCFG, 12, draws, init, opp_net=opp_net)
        _compare_rollout(roll, jroll, f"rollout {r}")
        np.testing.assert_allclose(h0.numpy(), np.asarray(jh0), **TOL)
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        np.testing.assert_allclose(boot.numpy(), np.asarray(jboot), **TOL)
        ends += int(roll.done.sum())
    assert ends >= N // 2 and float(h0.abs().max()) > 0
    for f in ("rand_left", "pcolor"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    for f in ("h_prot", "h_opp"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), **TOL)
    with pytest.raises(StopIteration):      # every recorded draw was used
        draws.legal_index(torch.zeros(N, dtype=torch.int64))


def test_time_limited_collector_matches_jax(monkeypatch):
    """3 rollouts of T=8 at N=16 with a cap of 6 protagonist decisions
    and random openings: the same games, ``bad_transition`` and
    ``elapsed`` (rewards included: the cap alone gives no outcome)."""
    plies = 6
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN)
    params = jax.tree.map(np.array, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8))))
    head = params["params"]["Dense_2"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = (200.0 * np.random.RandomState(0).permutation(64)
                    ).astype(np.float32)
    apply_fn = jtrainer.make_apply_fn(jnet)
    moves, resets = _record(monkeypatch)
    init_fn = jax.jit(functools.partial(
        jsp.selfplay_init, apply_fn=apply_fn, cfg=JRCFG, num_envs=N,
        init_rand_steps=INIT))
    collect = jax.jit(functools.partial(
        jsp.collect_rollout_time_limited, apply_fn=apply_fn, cfg=JRCFG,
        num_steps=T, max_episode_plies=plies, init_rand_steps=INIT))
    key = jax.random.PRNGKey(9)
    jstate, jelapsed = init_fn(params, key=key), jnp.ones(N, jnp.int32)
    want = []
    for _ in range(3):
        jstate, jelapsed, roll, bad, boot = collect(params, sp=jstate,
                                                    elapsed=jelapsed)
        want.append((roll, bad, jelapsed, boot))
    jax.effects_barrier()

    draws = _injected(key, INIT, resets, moves)
    net = policy_net_from_flax(params, device="cpu")
    state = sp.selfplay_init(net, RCFG, N, draws, INIT, device="cpu")
    elapsed = torch.ones(N, dtype=torch.int32)
    for r, (jroll, jbad, jelapsed, jboot) in enumerate(want):
        state, elapsed, roll, bad, boot = sp.collect_rollout_time_limited(
            net, state, elapsed, RCFG, T, plies, draws, INIT)
        _compare_rollout(roll, jroll, f"rollout {r}")
        np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
        np.testing.assert_array_equal(elapsed.numpy(), np.asarray(jelapsed))
        np.testing.assert_allclose(boot.numpy(), np.asarray(jboot), **TOL)
        assert bad.any()
    assert int(elapsed.max()) <= plies


def _update_inputs(frames):
    """A (T=8, N=32) rollout, masks from its dones, and ``h0``: hidden
    states in [-1, 1], or for the frame-stack cell {0,1} frames."""
    d = _rollout(11)
    rng = np.random.RandomState(12)
    size = frames * 256 if frames else HIDDEN
    h0 = (rng.rand(32, size) < 0.3 if frames
          else rng.uniform(-1, 1, (32, size))).astype(np.float32)
    masks = np.concatenate([np.ones((1, 32), np.float32),
                            1.0 - d["done"][:-1].astype(np.float32)])
    boot = rng.randn(32).astype(np.float32)
    return d, h0, masks, boot


def _leafwise(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("path,epochs", [("split", 1), ("split", 4),
                                         ("framestack", 4)])
def test_ppo_update_recurrent_matches_jax(path, epochs):
    """JAX's env permutations (``jax.random.permutation`` of each epoch
    key) injected through ``perms``.  One step (1 epoch, 1 minibatch):
    deltas to 1e-6 (lr 3e-4).  The full update (4 epochs x 4 minibatches
    of env subsets, the GRU replayed over T from ``h0`` with the masks;
    or the frame-stack cell's whole forward): each leaf's deltas to 1e-4
    of the leaf's largest delta (rounding grows over 16 steps).  Metrics
    to rtol 1e-4."""
    frames = 2 if path == "framestack" else 0
    if frames:
        jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN)
        params = jax.tree.map(np.array, jnet.init(
            jax.random.PRNGKey(4), jnp.zeros((1, 12, 8, 8))))
        params["params"]["Dense_2"]["kernel"] *= 100.0
        apply_fn = jtrainer.make_apply_fn_framestack(jnet, 3,
                                                     JaxEnvConfig())
        split = None
    else:
        jnet, params = _recurrent_params(4, False)
        apply_fn = jtrainer.make_apply_fn_recurrent(jnet)
        split = jtrainer.make_split_fns(jnet)
    mb = 1 if epochs == 1 else 4
    kw = dict(lr=3e-4, num_updates=1, ppo_epochs=epochs, num_mini_batch=mb,
              entropy_coef=0.01)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    d, h0, masks, boot = _update_inputs(frames)
    key = jax.random.PRNGKey(13)
    jopt = jppo.make_optimizer(jcfg)
    update = jax.jit(functools.partial(
        jppo.ppo_update_recurrent, apply_fn=apply_fn, optimizer=jopt,
        cfg=jcfg, split_fns=split))
    new, _, jm = update(params, jopt.init(params),
                        jppo.Transition(**{k: jnp.asarray(v)
                                           for k, v in d.items()}),
                        jnp.asarray(h0), jnp.asarray(masks),
                        jnp.asarray(boot), key)
    perms = [np.array(jax.random.permutation(k, 32))
             for k in jax.random.split(key, epochs)]

    net = policy_net_from_flax(params, device="cpu").train()
    policy = FrameStackCell(net, 3) if frames else net
    before = _leafwise(net)
    roll = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    roll["action"] = roll["action"].to(torch.int64)
    m = ppo.ppo_update_recurrent(
        policy, ppo.make_optimizer(cfg, net.parameters()),
        ppo.Transition(**roll), torch.from_numpy(h0),
        torch.from_numpy(masks), torch.from_numpy(boot), cfg,
        perms=[torch.from_numpy(p) for p in perms],
        split_fns=None if frames else trainer.make_split_fns(net))
    want = _leafwise(policy_net_from_flax(jax.tree.map(np.asarray, new),
                                          device="cpu"))
    for name, value in _leafwise(net).items():
        got_d = (value - before[name]).numpy()
        want_d = (want[name] - before[name]).numpy()
        big = float(np.abs(want_d).max())
        assert big > 0, name
        tol = 1e-6 if epochs == 1 else 1e-4 * big
        np.testing.assert_allclose(got_d, want_d, atol=tol, rtol=0,
                                   err_msg=name)
    for name in m:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_ppo_update_recurrent_refuses_a_ragged_split():
    d, h0, masks, boot = _update_inputs(0)
    net = policy_net_from_flax(_recurrent_params(4, False)[1],
                               device="cpu").train()
    cfg = ppo.PPOConfig(num_updates=1, num_mini_batch=5)
    roll = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    with pytest.raises(ValueError, match=r"num_envs \(32\) must divide by "
                       r"num_mini_batch \(5\) for the recurrent generator"):
        ppo.ppo_update_recurrent(
            net, ppo.make_optimizer(cfg, net.parameters()),
            ppo.Transition(**roll), torch.from_numpy(h0),
            torch.from_numpy(masks), torch.from_numpy(boot), cfg)


def _jax_games(cell, params, apply_fn, n, color, key):
    """JAX's ``play_games_recurrent`` against greedy with ``cell``; returns
    the winners and, per ply, the game states' legal masks, the cell's
    actions and the hidden state it was given."""
    log = []

    def recorded(keys, states, h):
        a, h_new = cell(keys, states, h)
        io_callback(lambda legal, a, h: log.append(
            (np.array(legal), np.array(a), np.array(h))), None,
            states.legal, a, h, ordered=True)
        return a, h_new

    winners = jax.jit(lambda k: jtrainer.play_games_recurrent(
        k, JaxEnvConfig(), params, apply_fn, jgreedy, n, color, INIT,
        HIDDEN, act_cell=recorded))(key)
    jax.effects_barrier()
    return np.asarray(winners), log


def _jax_draws(key, n, log):
    """JAX's random-opening counts and each ply's random move (its key
    chain rebuilt: ``split(key, n + 1)``, then ``split(key, 4)`` a ply),
    as ``InjectedDraws`` of counts and legal-move indices."""
    keys = jax.random.split(key, n + 1)
    key = keys[0]
    rand_left = jax.vmap(draw_max_rand_steps, in_axes=(0, None))(keys[1:],
                                                                 INIT)
    index = []
    for legal, _, _ in log:
        key, k_rand, _, _ = jax.random.split(key, 4)
        a = np.asarray(jax.vmap(random_action)(jax.random.split(k_rand, n),
                                               jnp.asarray(legal)))
        index.append(torch.tensor([int(row[:max(int(x), 0)].sum())
                                   for row, x in zip(legal, a)]))
    return sp.InjectedDraws(colors=(), uniforms=itertools.repeat(
        torch.full((n,), 0.5)), rand_left=[torch.from_numpy(
            np.array(rand_left))], legal_index=index)


@pytest.mark.parametrize("kind,color", [("sampling", 1), ("lookahead", -1)])
def test_play_games_recurrent_matches_jax(kind, color):
    """12 games against greedy with 10 random opening plies: the same
    states every ply, the same decisions of the net's cell and the same
    hidden state handed to it (it advances on the net's live turns,
    random-opening plies included), and the same winners.  ``sampling``:
    a ranked net; ``lookahead``: the recurrent depth-1 lookahead of a net
    whose values depend on the hidden state."""
    n = 12
    jnet, params = _recurrent_params(2, kind == "sampling")
    apply_fn = jtrainer.make_apply_fn_recurrent(jnet)
    jcell = (jtrainer.net_sampling_cell(params, apply_fn)
             if kind == "sampling" else
             jtrainer.net_lookahead_cell_recurrent(params, apply_fn, JRCFG))
    key = jax.random.PRNGKey(21)
    want_w, want = _jax_games(jcell, params, apply_fn, n, color, key)

    net = policy_net_from_flax(params, device="cpu")
    cell = (trainer.net_sampling_cell(net) if kind == "sampling" else
            trainer.net_lookahead_cell_recurrent(net, RCFG))
    got = []

    def recorded(states, h, draws):
        a, h_new = cell(states, h, draws)
        got.append((tb.unpack_flat(states.legal).numpy(), a.numpy(),
                    h.numpy()))
        return a, h_new

    winners = trainer.play_games_recurrent(
        EnvConfig(), net, greedy_policy, n, color, INIT, HIDDEN,
        act_cell=recorded, draws=_jax_draws(key, n, want), device="cpu")
    assert len(got) == len(want) > 20
    for ply, ((gl, ga, gh), (wl, wa, wh)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gl, wl, err_msg=f"legal, ply {ply}")
        np.testing.assert_array_equal(ga, wa, err_msg=f"action, ply {ply}")
        np.testing.assert_allclose(gh, wh, err_msg=f"h, ply {ply}", **TOL)
    assert float(np.abs(got[-1][2]).max()) > 0
    np.testing.assert_array_equal(winners.numpy(), want_w)


def test_lookahead_cell_matches_jax_on_random_states():
    """The recurrent lookahead on 48 reachable positions with random
    hidden states: the carried state ``h_cur`` to 1e-5 and the decisions
    equal wherever the best value leads the second by more than 1e-4;
    depth 2 raises JAX's ``NotImplementedError``."""
    n = 48
    jnet, params = _recurrent_params(3, False)
    apply_fn = jtrainer.make_apply_fn_recurrent(jnet)
    states = random_states(n, 17)
    h = np.random.RandomState(3).uniform(-1, 1, (n, HIDDEN)).astype(
        np.float32)
    jcell = jtrainer.net_lookahead_cell_recurrent(params, apply_fn, JRCFG)
    wa, wh = jax.jit(jcell)(jax.random.split(jax.random.PRNGKey(0), n),
                            othello_state(states), jnp.asarray(h))
    net = policy_net_from_flax(params, device="cpu")
    action, scores, margin, h_cur = trainer.lookahead_recurrent(
        net, to_port(states), torch.from_numpy(h), RCFG)
    np.testing.assert_allclose(h_cur.numpy(), np.asarray(wh), **TOL)
    held = margin.numpy() > 1e-4
    assert held.sum() >= n - 2
    np.testing.assert_array_equal(action.numpy()[held], np.asarray(wa)[held])
    legal = tb.unpack_flat(to_port(states).legal)
    assert (scores[~legal] == sp.NEG).all() and (scores[legal] > sp.NEG).all()
    for depth in (2, 3):
        with pytest.raises(NotImplementedError, match="depth 1 only"):
            trainer.net_lookahead_cell_recurrent(net, RCFG, depth)
        with pytest.raises(NotImplementedError, match="depth 1 only"):
            jtrainer.net_lookahead_cell_recurrent(params, apply_fn, JRCFG,
                                                  depth)
