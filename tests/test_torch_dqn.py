"""The port's DQN agent (``agents/dqn.py``, ``models/nets.py`` DQN nets)
against JAX's: ``DQNNet`` and ``DuelingDQNNet`` against flax (1e-5), the
committed dueling checkpoint ``data/dqn_tpu_run.msgpack`` (1e-5),
``featurize3`` and ``epsilon_at`` exactly, ``dqn_loss_grads`` with Double
on and off at n = 1 and 3 (loss, TD errors and every gradient leaf to
1e-6), the hand-written RMSprop against optax's ``rmsprop(lr, eps=0.01,
momentum=0.95)`` (one step to 1e-6, four steps per leaf within 1e-4 of
the leaf's largest delta plus one float32 spacing of the leaf) and its
state in optax's layout both ways,
``dqn_act`` with JAX's draws injected, and the trainer's evaluation of the
committed checkpoint with JAX's evaluation draws injected (every game's
winner equal)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import dqn as jdqn
from gymothelloenv_tpu.agents.replay import ReplayConfig as JaxReplayConfig
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models import nets as jnets
from gymothelloenv_tpu.policies.scripted import \
    random_action as jrandom_action
from gymothelloenv_tpu.train import dqn_trainer as jtrain
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.agents import dqn
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    load_flax_params,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.nets import DQNNet, DuelingDQNNet
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
BATCH = 48


@functools.cache
def _flax(dueling, b=8, seed=0):
    cls = jnets.DuelingDQNNet if dueling else jnets.DQNNet
    jnet = cls(num_actions=b * b)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 3, b, b)))
    return jnet, jax.tree.map(np.array, params)


def _port(dueling, params, b=8):
    cls = DuelingDQNNet if dueling else DQNNet
    return load_flax_params(cls(num_actions=b * b, board_size=b), params)


def _obs(n, b=8, seed=0):
    rng = np.random.RandomState(seed)
    board = rng.randint(-1, 2, (n, b, b)).astype(np.int8)
    turn = rng.choice([-1, 1], n).astype(np.int8)
    return board, turn


@pytest.mark.parametrize("dueling,b", [(False, 8), (True, 8), (True, 6)])
def test_nets_equal_flax(dueling, b):
    jnet, params = _flax(dueling, b)
    board, turn = _obs(16, b)
    x = np.array(jdqn.featurize3(jnp.asarray(board), jnp.asarray(turn)))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    got = _port(dueling, params, b)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The port's own tree is flax's, leaf for leaf.
    tree = flax_tree(_port(dueling, params, b))
    assert [k for k, _ in flax_leaves(tree)] == [k for k, _ in
                                                 flax_leaves(params)]


def test_committed_dueling_checkpoint_forward():
    """``data/dqn_tpu_run.msgpack`` (``ConvTrunk_0``, ``Dense_0..3``,
    ``extra/t``) through the port's dueling net, against flax, 1e-5."""
    step, params, opt_state, extra = load_checkpoint(
        os.path.join(DATA, "dqn_tpu_run.msgpack"))
    assert step == 400 and extra["t"] > 0
    board, turn = _obs(64, seed=3)
    x = np.array(jdqn.featurize3(jnp.asarray(board), jnp.asarray(turn)))
    want = np.asarray(jnets.DuelingDQNNet(num_actions=64).apply(
        params, jnp.asarray(x)))
    got = _port(True, params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    net = _port(True, params)
    opt = dqn.make_dqn_optimizer(dqn.DQNConfig(), net.parameters())
    opt.load_optax_state(opt_state, functools.partial(tensors_from_flax,
                                                      net))
    back = opt.to_optax_state(functools.partial(flax_tree, net))
    for (k1, a), (k2, b) in zip(flax_leaves(back), flax_leaves(opt_state),
                                strict=True):
        assert k1 == k2
        np.testing.assert_array_equal(a, np.asarray(b))


def test_featurize3_and_epsilon_equal_jax():
    board, turn = _obs(32, 6)
    np.testing.assert_array_equal(
        dqn.featurize3(torch.from_numpy(board), torch.from_numpy(turn))
        .numpy(),
        np.asarray(jdqn.featurize3(jnp.asarray(board), jnp.asarray(turn))))
    for cfg in (jdqn.DQNConfig(), jdqn.DQNConfig(
            initial_replay_size=0, annealing_steps=12345, final_epsilon=0.05)):
        pcfg = dqn.DQNConfig(initial_replay_size=cfg.initial_replay_size,
                             annealing_steps=cfg.annealing_steps,
                             final_epsilon=cfg.final_epsilon)
        for t in (0, 1, 19_999, 20_000, 20_001, 123_457, 999_999,
                  5_000_000):
            assert float(dqn.epsilon_at(pcfg, t)) == float(
                jdqn.epsilon_at(cfg, jnp.int32(t))), (cfg, t)


def _batch(n=BATCH, seed=1):
    rng = np.random.RandomState(seed)
    board, turn = _obs(n, seed=seed)
    next_board, next_turn = _obs(n, seed=seed + 100)
    return (board, turn, rng.randint(0, 64, n).astype(np.int32),
            (rng.randint(-64, 65, n) / 64.0).astype(np.float32),
            next_board, next_turn, rng.rand(n) < 0.3)


def _states(dueling, double, n_step):
    """JAX's and the port's agent on the same params (target params from
    another seed) and configs."""
    jnet, params = _flax(dueling)
    _, target = _flax(dueling, seed=1)
    cfg = jdqn.DQNConfig(double=double, dueling=dueling, n_step=n_step)
    pcfg = dqn.DQNConfig(double=double, dueling=dueling, n_step=n_step)
    opt = jdqn.make_dqn_optimizer(cfg)
    jstate = jdqn.DQNState(params=params, target_params=target,
                           opt_state=opt.init(params), t=jnp.int32(0))
    net = _port(dueling, params)
    state = dqn.DQNState(net=net, target=dqn.frozen_copy(
        _port(dueling, target)), optimizer=dqn.make_dqn_optimizer(
            pcfg, net.parameters()))
    apply_fn = jax.jit(jnet.apply)
    return (jstate, cfg, apply_fn, opt), (state, pcfg)


@pytest.mark.parametrize("double,n_step", [(False, 1), (True, 1),
                                           (False, 3), (True, 3)])
def test_loss_and_grads_equal_jax(double, n_step):
    """Dueling net; loss, TD errors and each gradient leaf to 1e-6."""
    (jstate, cfg, apply_fn, _), (state, pcfg) = _states(True, double, n_step)
    batch = _batch()
    (jloss, jtd), jgrads = jax.jit(
        lambda s, b: jdqn.dqn_loss_grads(s, cfg, apply_fn, b))(
            jstate, tuple(map(jnp.asarray, batch)))
    loss, td = dqn.dqn_loss_grads(state, pcfg,
                                  tuple(map(torch.from_numpy, batch)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=0,
                               atol=1e-6)
    grads = flax_tree(state.net, [p.grad for p in state.net.parameters()])
    for (k, g), (_, w) in zip(flax_leaves(grads), flax_leaves(jgrads),
                              strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg="/".join(k))
    assert max(np.abs(np.asarray(w)).max() for _, w in
               flax_leaves(jgrads)) > 1e-3


def test_rmsprop_equals_optax():
    """One step to 1e-6; four steps (fresh gradients each, from the same
    batch sequence) per leaf within 1e-4 of the leaf's largest delta plus
    one float32 spacing of its largest entry; the state as optax's tree
    (to 1e-6)."""
    (jstate, cfg, apply_fn, opt), (state, pcfg) = _states(True, True, 3)
    params0 = jax.tree.map(np.array, jstate.params)
    step = jax.jit(lambda s, b: jdqn.dqn_loss_grads(s, cfg, apply_fn, b))
    for k in range(4):
        batch = _batch(seed=10 + k)
        _, jgrads = step(jstate, tuple(map(jnp.asarray, batch)))
        updates, opt_state = opt.update(jgrads, jstate.opt_state,
                                        jstate.params)
        jstate = jstate.replace(params=optax.apply_updates(jstate.params,
                                                           updates),
                                opt_state=opt_state)
        dqn.dqn_loss_grads(state, pcfg, tuple(map(torch.from_numpy, batch)))
        state.optimizer.step()
        got = flax_tree(state.net)
        for (key, g), (_, w), (_, p0) in zip(
                flax_leaves(got), flax_leaves(jstate.params),
                flax_leaves(params0), strict=True):
            w = np.asarray(w)
            if k == 0:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg="/".join(key))
            else:
                # Relative to the leaf's largest delta, plus the float32
                # spacing of its largest entry (a delta below it rounds).
                scale = np.abs(w - p0).max()
                bound = 1e-4 * scale + np.spacing(np.abs(w).max())
                assert np.abs(g - w).max() <= bound, (key, k)
    tree = state.optimizer.to_optax_state(functools.partial(flax_tree,
                                                            state.net))
    for (k1, a), (k2, b) in zip(flax_leaves(tree),
                                flax_leaves(jax.tree.map(
                                    np.asarray, _optax_dict(jstate))),
                                strict=True):
        assert k1 == k2
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="rmsprop"):
        state.optimizer.load_optax_state({"0": {}, "1": {}},
                                         lambda t: t)


def _optax_dict(jstate):
    from flax import serialization
    return serialization.to_state_dict(jstate.opt_state)


def test_dqn_act_equals_jax_with_injected_draws():
    """JAX's epsilon uniforms and its categorical random moves (as ranks
    among the legal moves) injected: every action equal, at epsilon 0.5
    (both branches taken) and 0."""
    jnet, params = _flax(True)
    net = _port(True, params)
    board, turn = _obs(64, seed=4)
    rng = np.random.RandomState(4)
    legal = rng.rand(64, 64) < 0.25
    legal[:, 0] |= ~legal.any(1)
    apply_fn = jax.jit(jnet.apply)
    for eps in (0.5, 0.0):
        key = jax.random.PRNGKey(7)
        want = np.asarray(jdqn.dqn_act(params, apply_fn, jnp.asarray(board),
                                       jnp.asarray(turn),
                                       jnp.asarray(legal), key, eps))
        k_eps, k_rand = jax.random.split(key)
        u = np.array(jax.random.uniform(k_eps, (64,)))
        rand = np.asarray(jax.random.categorical(
            k_rand, jnp.where(jnp.asarray(legal), 0.0, -jnp.inf), axis=-1))
        rank = np.array([legal[i, :rand[i]].sum() for i in range(64)])
        draws = sp.InjectedDraws([], [torch.from_numpy(u)],
                                 legal_index=[torch.from_numpy(rank)])
        got = dqn.dqn_act(net, torch.from_numpy(board),
                          torch.from_numpy(turn), torch.from_numpy(legal),
                          torch.tensor(eps), draws).numpy()
        np.testing.assert_array_equal(got, want)
        explored = u < eps
        assert explored.any() == (eps > 0) and (~explored).any()


EVAL_GAMES = 40


def _record_eval(records):
    """Wrap JAX's ``play_games_impl`` (as ``train/dqn_trainer.py`` calls
    it) so that each call appends its key, and each ply of each side its
    legal mask and the draws either policy could take from its per-game
    keys: the net's epsilon uniform and random move (``_eval_act``'s own
    split) and the random opponent's move, and the call's winners."""
    real = jtrain.play_games_impl

    def side(act, ply_records):
        def batched(keys, states):
            k_eps, k_rand = jax.vmap(jax.random.split)(keys).transpose(
                1, 0, 2)
            u = jax.vmap(lambda k: jax.random.uniform(k, ()))(k_eps)
            net_move = jax.vmap(jrandom_action)(k_rand, states.legal)
            opp_move = jax.vmap(jrandom_action)(keys, states.legal)
            io_callback(lambda *a: ply_records.append(
                tuple(map(np.array, a))), None, states.legal, u, net_move,
                opp_move, ordered=True)
            return jax.vmap(act)(keys, states)
        batched.batched = True
        return batched

    def play_games_impl(key, cfg, act_black, act_white, num_games,
                        init_rand_steps=0, max_plies=0):
        call = dict(black=[], white=[])
        io_callback(lambda k: call.update(key=np.array(k)), None, key,
                    ordered=True)
        records.append(call)
        winners = real(key, cfg, side(act_black, call["black"]),
                       side(act_white, call["white"]), num_games,
                       init_rand_steps, max_plies)
        io_callback(lambda w: call.update(winners=np.array(w)), None,
                    winners, ordered=True)
        return winners
    return play_games_impl


def _rank(legal, action):
    return torch.from_numpy(np.array([legal[i, :a].sum()
                                      for i, a in enumerate(action)]))


def _eval_draws(records, init_rand_steps):
    """JAX's evaluation draws in the port's order of calls: for each
    ``play_games`` (random: net black, net white; greedy: the same) its
    opening counts, then each ply's opening move (rebuilt from the call's
    key as ``play_games_impl`` splits it), black's draws and white's (the
    net's random move and uniform, or the random opponent's move; greedy
    draws none)."""
    uniforms, rand_left, legal_index = [], [], []
    for c, call in enumerate(records):
        net_side = "black" if c % 2 == 0 else "white"
        opp_random = c < 2
        n = len(call["winners"])
        game_keys = jax.random.split(jnp.asarray(call["key"]), n + 1)
        key = game_keys[0]
        rand_left.append(torch.from_numpy(np.array(jax.vmap(
            draw_max_rand_steps, in_axes=(0, None))(game_keys[1:],
                                                    init_rand_steps))))
        for black, white in zip(call["black"], call["white"]):
            key, k_rand, _, _ = jax.random.split(key, 4)
            legal = black[0]
            opening = np.array(jax.vmap(jrandom_action)(
                jax.random.split(k_rand, n), jnp.asarray(legal)))
            legal_index.append(_rank(legal, opening))
            for name, (lg, u, net_move, opp_move) in (("black", black),
                                                      ("white", white)):
                if name == net_side:
                    legal_index.append(_rank(lg, net_move))
                    uniforms.append(torch.from_numpy(u))
                elif opp_random:
                    legal_index.append(_rank(lg, opp_move))
    return sp.InjectedDraws([], uniforms, rand_left, legal_index)


def test_evaluation_of_the_committed_checkpoint_agrees_with_jax(
        monkeypatch):
    """The port's evaluation of ``data/dqn_tpu_run.msgpack`` (epsilon 0.05
    against random and greedy, half the games as each colour, 10 random
    opening plies), EVAL_GAMES games an opponent, against JAX's
    ``DQNTrainer.evaluate`` of the same checkpoint with its draws
    recorded and injected: every game's winner and both win rates
    equal."""
    path = os.path.join(DATA, "dqn_tpu_run.msgpack")
    records = []
    monkeypatch.setattr(jtrain, "play_games_impl",
                        _record_eval(records))
    jtr = jtrain.DQNTrainer(JaxEnvConfig(num_disk_as_reward=True),
                            jdqn.DQNConfig(dueling=True),
                            JaxReplayConfig(capacity=64),
                            jtrain.DQNRunConfig(num_test_games=EVAL_GAMES))
    jtr.load(path)
    want = jtr.evaluate()
    jax.effects_barrier()
    assert len(records) == 4

    winners, real = [], tournament.play_games

    def play_games(*args, **kwargs):
        winners.append(real(*args, **kwargs).numpy())
        return winners[-1]
    monkeypatch.setattr(tournament, "play_games", play_games)
    tr = DQNTrainer(EnvConfig(num_disk_as_reward=True),
                    dqn.DQNConfig(dueling=True), ReplayConfig(capacity=64),
                    DQNRunConfig(num_test_games=EVAL_GAMES), device="cpu")
    tr.load(path)
    draws = _eval_draws(records, tr.run_cfg.test_init_rand_steps)
    draws_used = list(draws._uniforms)
    draws._uniforms = iter(draws_used)
    got = tr.evaluate(draws)
    for call, w in zip(records, winners, strict=True):
        np.testing.assert_array_equal(w, call["winners"])
    games = 2 * (EVAL_GAMES // 2)
    assert {k: round(v * games) for k, v in got.items()} == {
        k: round(float(v) * games) for k, v in want.items()}
    assert 0 < want["rand"] < 1 and 0 < want["greedy"] < 1
    explored = sum(int((u.numpy() < tr.dqn_cfg.test_epsilon).sum())
                   for u in draws_used)
    assert explored > 0                    # both branches of _eval_act
    with pytest.raises(StopIteration):     # every recorded draw was used
        draws.legal_index(torch.zeros(1, dtype=torch.int64))
