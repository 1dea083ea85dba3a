"""The port's Rainbow (``agents/rainbow.py``, ``train/rainbow_trainer.py``,
``cli/rainbow_train.py``) against JAX's: ``NoisyLinear``/``RainbowNet``
against flax with the noise off and with JAX's noise injected (1e-5), the
committed ``rainbow_pool_600``/``_1200`` checkpoints through
``models/convert.py`` (1e-5), the initializer by its distribution,
``expected_q`` and ``rainbow_act``'s decisions, ``_project_distribution``
on random and edge inputs (1e-6), one ``rainbow_train_batch`` on given
rows and noise (loss and KL priorities 1e-5, the Adam step per leaf within
1e-5 of the leaf's largest), two chunks of job 07's pool mode against
JAX's ``RainbowTrainer._train_chunk`` with its draws injected,
checkpoints byte for byte both ways, and the CLI.

JAX draws each ``NoisyDense``'s normals from a key (four per forward,
split in two each); the tests rebuild them from the keys JAX used
(``_jax_noise``) and hand them to the port as ``InjectedDraws.normals``,
one vector a noisy forward."""

import contextlib
import copy
import dataclasses
import functools
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.agents import dqn as jdqn
from gymothelloenv_tpu.agents import rainbow as jrainbow
from gymothelloenv_tpu.agents import replay as jreplay
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import dqn_trainer as jdqn_trainer
from gymothelloenv_tpu.train import rainbow_trainer as jrtrain
from gymothelloenv_tpu_torch.agents import rainbow
from gymothelloenv_tpu_torch.agents.rainbow import (NoisyLinear,
                                                    RainbowConfig,
                                                    RainbowNet)
from gymothelloenv_tpu_torch.agents.replay import (ReplayConfig,
                                                   replay_init,
                                                   replay_insert)
from gymothelloenv_tpu_torch.cli import rainbow_train
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    load_flax_params,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.dqn_trainer import DQNRunConfig
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_dqn_trainer import (FIELDS, _leaves, _legal_rank,
                                    _reset_draws, _rows)
from gymothelloenv_tpu.core.bitboard import to_board
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_states

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay")
N, PLIES, INIT, CAP, SYNC = 8, 64, 4, 2048, 200
JCFG = jrainbow.RainbowConfig()
CFG = RainbowConfig()


@functools.cache
def _flax(b=8, seed=0):
    jnet = jrainbow.make_rainbow_net(jrainbow.RainbowConfig(board_size=b))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 3, b, b)))
    return jnet, jax.tree.map(np.array, params)


def _port_net(params, b=8):
    return load_flax_params(RainbowNet(num_actions=b * b, board_size=b),
                            params)


def _sizes(net: RainbowNet):
    return [(layer.in_features, layer.out_features)
            for layer in net._noisy()]


def _jax_noise(key, sizes) -> torch.Tensor:
    """The normals JAX's ``RainbowNet`` draws from ``key``: four keys, one
    a ``NoisyDense``, each split into ``f_in`` and ``f_out`` keys."""
    parts = []
    for k, (n_in, out) in zip(jax.random.split(jnp.asarray(key), 4), sizes):
        k1, k2 = jax.random.split(k)
        parts += [np.asarray(jax.random.normal(k1, (n_in,))),
                  np.asarray(jax.random.normal(k2, (out,)))]
    return torch.from_numpy(np.concatenate(parts))


def _obs(n, b=8, seed=0):
    rng = np.random.RandomState(seed)
    board = rng.randint(-1, 2, (n, b, b)).astype(np.int8)
    turn = rng.choice([-1, 1], n).astype(np.int8)
    return board, turn


@pytest.mark.parametrize("b", [8, 6])
def test_net_equals_flax_with_and_without_noise(b):
    jnet, params = _flax(b)
    board, turn = _obs(16, b)
    x = jdqn.featurize3(jnp.asarray(board), jnp.asarray(turn))
    net = _port_net(params, b)
    xt = torch.from_numpy(np.array(x))
    want = np.asarray(jnet.apply(params, x))
    np.testing.assert_allclose(net(xt).detach().numpy(), want, rtol=0,
                               atol=1e-5)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jnet.apply(params, x, key))
    got = net(xt, _jax_noise(key, _sizes(net))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.allclose(got, np.asarray(jnet.apply(params, x)),
                           atol=1e-3)                   # the noise acts
    # The port's own tree is flax's, leaf for leaf, in flax's layout.
    mine = dict(flax_leaves(flax_tree(net)))
    for k, leaf in flax_leaves(params):
        np.testing.assert_array_equal(mine[k], leaf, err_msg=str(k))


def test_noisy_linear_alone_equals_flax():
    jlayer = jrainbow.NoisyDense(24)
    x = jnp.asarray(np.random.RandomState(1).randn(5, 40), jnp.float32)
    params = jlayer.init(jax.random.PRNGKey(2), x)
    layer = NoisyLinear(40, 24)
    with torch.no_grad():
        for k in ("w_mu", "b_mu", "w_sigma", "b_sigma"):
            getattr(layer, k).copy_(torch.from_numpy(np.array(
                params["params"][k])))
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    noise = torch.cat([torch.from_numpy(np.array(jax.random.normal(
        k, (n,)))) for k, n in ((k1, 40), (k2, 24))])
    xt = torch.from_numpy(np.array(x))
    for got, want in ((layer(xt), jlayer.apply(params, x)),
                      (layer(xt, noise), jlayer.apply(params, x, key))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


def test_init_follows_jax_distribution():
    """flax's ``uniform(scale)`` draws from [0, scale): ``w_mu``/``b_mu``
    in [0, 1/sqrt(in)) with mean 1/(2 sqrt(in)); the sigmas constant at
    0.5/sqrt(in).  Both inits hold this."""
    net = rainbow.make_rainbow_net(CFG, seed=3, device="cpu")
    _, params = _flax()
    for name, jname in (("adv_fc", "NoisyDense_0"), ("adv", "NoisyDense_2")):
        layer = getattr(net, name)
        bound = 1.0 / np.sqrt(layer.in_features)
        for w in (layer.w_mu.detach().numpy(),
                  np.asarray(params["params"][jname]["w_mu"])):
            assert w.min() >= 0.0 and w.max() < bound
            assert abs(w.mean() - bound / 2) < 0.02 * bound
            assert abs(w.std() - bound / np.sqrt(12)) < 0.02 * bound
        for s in (layer.w_sigma.detach().numpy(), layer.b_sigma.detach(
                ).numpy(), np.asarray(params["params"][jname]["w_sigma"])):
            np.testing.assert_allclose(s, 0.5 * bound, rtol=1e-6)


@pytest.mark.parametrize("chunk", [600, 1200])
def test_committed_checkpoints_forward(chunk):
    """The trained nets on 32 reachable positions, noise off and on: the
    atom logits to 1e-5 of the largest (1200's logits reach 35, where the
    port and flax each sit 1.6e-5 from a float64 forward)."""
    step, params, _, extra = load_checkpoint(
        os.path.join(DATA, f"rainbow_pool_{chunk}.msgpack"))
    assert step == chunk and extra["t"] > 0
    jnet, _ = _flax()
    s = random_states(32, seed=chunk)
    x = jdqn.featurize3(to_board(s), s.turn)
    net = _port_net(params)
    xt = torch.from_numpy(np.array(x))
    key = jax.random.PRNGKey(chunk)
    for got, want in ((net(xt), jnet.apply(params, x)),
                      (net(xt, _jax_noise(key, _sizes(net))),
                       jnet.apply(params, x, key))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_expected_q_and_act_decisions_equal_jax():
    """Expected Q to 1e-6; the noisy greedy decision equal wherever the
    top two legal Q values are more than 1e-5 apart."""
    _, params = _flax()
    net = _port_net(params)
    jnet = jrainbow.make_rainbow_net(JCFG)
    board, turn = _obs(256, seed=4)
    legal = np.random.RandomState(4).rand(256, 64) < 0.3
    legal[0] = False
    key = jax.random.PRNGKey(11)
    want_a = np.asarray(jrainbow.rainbow_act(
        params, lambda p, x, k=None: jnet.apply(p, x, k), jnp.asarray(board),
        jnp.asarray(turn), jnp.asarray(legal), key, JCFG))
    noise = _jax_noise(key, _sizes(net))
    draws = sp.InjectedDraws((), (), normals=[noise])
    got_a = rainbow.rainbow_act(net, torch.from_numpy(board),
                                torch.from_numpy(turn),
                                torch.from_numpy(legal), draws, CFG).numpy()
    logits = np.asarray(jnet.apply(params, jdqn.featurize3(
        jnp.asarray(board), jnp.asarray(turn)), key))
    want_q = np.asarray(jrainbow.expected_q(jnp.asarray(logits), JCFG))
    got_q = rainbow.expected_q(torch.from_numpy(logits.copy()), CFG).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-6)
    masked = np.sort(np.where(legal, want_q, -1e9), axis=1)
    clear = masked[:, -1] - masked[:, -2] > 1e-5
    assert clear.sum() > 200
    np.testing.assert_array_equal(got_a[clear], want_a[clear])
    assert got_a[0] == want_a[0] == 0        # no legal move: argmax of -inf
    np.testing.assert_allclose(                    # one float32 spacing
        CFG.support().numpy(), np.asarray(JCFG.support), rtol=0,
        atol=2.0 ** -23)


def test_projection_equals_jax_on_random_and_edge_inputs():
    """Random probabilities and rewards, and the edges: ``done`` rows,
    targets clipped at ``v_min``/``v_max``, and ``b`` exactly on an atom
    (reward 0 and gamma^n z landing on the grid)."""
    rng = np.random.RandomState(0)
    n = 64
    probs = rng.dirichlet(np.ones(51), n).astype(np.float32)
    reward = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    reward[:8] = 0.0                                # b on an atom if done
    reward[8:12] = 1.2                              # clipped at v_max
    reward[12:16] = -1.2                            # clipped at v_min
    reward[16:20] = 0.04                            # exactly one atom up
    done = rng.rand(n) < 0.3
    done[:8] = True
    done[16:20] = True
    not_done = (1.0 - done).astype(np.float32)
    for cfg, jcfg in ((CFG, JCFG), (RainbowConfig(n_step=1, gamma=1.0),
                                    jrainbow.RainbowConfig(n_step=1,
                                                           gamma=1.0))):
        want = np.asarray(jrainbow._project_distribution(
            jnp.asarray(probs), jnp.asarray(reward), jnp.asarray(not_done),
            jcfg))
        got = rainbow._project_distribution(
            torch.from_numpy(probs), torch.from_numpy(reward),
            torch.from_numpy(not_done), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    # A done row with reward 0 puts all its mass on the middle atom.
    np.testing.assert_allclose(got[:8, 25], 1.0, atol=1e-6)
    np.testing.assert_allclose(got[16:20, 26], 1.0, atol=1e-6)


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    board, turn = _obs(n, seed=seed)
    next_board, next_turn = _obs(n, seed=seed + 100)
    action = rng.randint(0, 64, n).astype(np.int32)
    reward = rng.uniform(-1, 1, n).astype(np.float32)
    done = rng.rand(n) < 0.3
    return board, turn, action, reward, next_board, next_turn, done


def test_train_batch_equals_jax_with_given_rows_and_noise():
    """One ``rainbow_train_batch`` on PER: the sampled rows and the three
    noise samples (online, target, trained forward) injected; the loss
    and the KL priorities to rtol 1e-5, every gradient leaf within 1e-5
    of its largest, and Adam's step on JAX's gradients per leaf within
    1e-5 of the leaf's largest (float32 bias corrections: measured
    6.7e-6).  The whole step on the port's own gradients holds to 2e-4
    of the leaf's largest plus one float32 spacing of the parameter:
    Adam's first step is ``lr g / (|g| + eps)``, so a gradient's absolute
    error counts ``1 / eps`` (eps 1.5e-4) where the leaf's largest step
    counts ``1 / |g|max``; measured 1.3e-4 from gradients 2e-6 apart."""
    cap, batch = 64, 32
    fields = _batch(cap, 7)
    jrb_cfg = jreplay.ReplayConfig(capacity=cap, prioritized=True)
    jrb = jreplay.replay_insert(jreplay.replay_init(jrb_cfg), jrb_cfg,
                                *map(jnp.asarray, fields),
                                jnp.ones(cap, bool))
    jcfg = jrainbow.RainbowConfig(batch_size=batch)
    state = jrainbow.rainbow_init(jcfg, jax.random.PRNGKey(1))
    jnet = jrainbow.make_rainbow_net(jcfg)

    def apply_fn(p, x, k=None):
        return jnet.apply(p, x, k)
    key = jax.random.PRNGKey(3)
    k_sample, k_core = jax.random.split(key)
    jidx = np.asarray(jreplay.replay_sample_idx(jrb, jrb_cfg, k_sample,
                                                batch))
    new, jrb2, jloss = jax.jit(functools.partial(
        jrainbow.rainbow_train_batch, cfg=jcfg, rb_cfg=jrb_cfg,
        apply_fn=apply_fn, optimizer=jrainbow.make_rainbow_optimizer(
            jcfg)))(state, jrb, key=key)
    _, jgrads = jax.jit(functools.partial(
        jrainbow.rainbow_loss_grads, cfg=jcfg, apply_fn=apply_fn))(
        state, batch=jreplay.replay_gather(jrb, jnp.asarray(jidx)),
        key=k_core)

    cfg = RainbowConfig(batch_size=batch)
    agent = rainbow.rainbow_init(cfg, 0, "cpu")
    params0 = jax.tree.map(np.array, state.params)
    load_flax_params(agent.net, params0)
    load_flax_params(agent.target, params0)
    rb_cfg = ReplayConfig(capacity=cap, prioritized=True)
    rb = replay_init(rb_cfg, "cpu")
    replay_insert(rb, rb_cfg, *map(torch.from_numpy, fields),
                  torch.ones(cap, dtype=torch.bool))
    sizes = _sizes(agent.net)
    draws = sp.InjectedDraws((), (), replay_uniforms=[torch.from_numpy(
        np.array(jax.random.uniform(k_sample, (batch,))))],
        normals=[_jax_noise(k, sizes) for k in jax.random.split(k_core, 3)])
    taken, grads = [], []
    real_sample, real_loss = rainbow.replay_sample_idx, \
        rainbow.rainbow_loss_grads

    def sample(rb_, cfg_, u):
        taken.append(real_sample(rb_, cfg_, u))
        return torch.from_numpy(jidx.astype(np.int64))

    def loss_grads(*args):
        out = real_loss(*args)
        grads.extend(p.grad.clone() for p in agent.net.parameters())
        return out
    rainbow.replay_sample_idx = sample
    rainbow.rainbow_loss_grads = loss_grads
    try:
        loss = rainbow.rainbow_train_batch(agent, rb, cfg, rb_cfg, draws)
    finally:
        rainbow.replay_sample_idx = real_sample
        rainbow.rainbow_loss_grads = real_loss
    assert int((taken[0].numpy() != jidx).sum()) <= 1
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(
        rb.priority[:cap].numpy(), np.asarray(jrb2.priority[:cap]),
        rtol=1e-5, atol=0)
    names = [k for k, _ in agent.net.named_parameters()]
    jg = tensors_from_flax(agent.net, jax.tree.map(np.array, jgrads))
    start = _leaves(_port_net(params0))
    want = _leaves(_port_net(jax.tree.map(np.array, new.params)))
    port = _leaves(agent.net)
    jopt = jrainbow.make_rainbow_optimizer(jcfg)
    jsteps = tensors_from_flax(agent.net, jax.tree.map(np.array, jopt.update(
        jgrads, jopt.init(state.params))[0]))
    for k, g, w, jstep in zip(names, grads, jg, jsteps):
        big = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * big, k
        p = torch.zeros_like(w, requires_grad=True)
        adam = torch.optim.Adam([p], lr=cfg.lr, eps=cfg.adam_eps)
        p.grad = w.clone()
        adam.step()                       # from 0: the step itself
        assert float((p.detach() - jstep).abs().max()) <= \
            1e-5 * float(jstep.abs().max()), k
        wd, gd = want[k] - start[k], port[k] - start[k]
        assert bool(((gd - wd).abs() <= 2e-4 * wd.abs().max()
                     + 2.0 ** -23 * want[k].abs()).all()), k
    # The optimizer's state is optax's adam tree.
    to_tree = functools.partial(flax_tree, agent.net)
    mine = agent.optimizer.to_optax_state(to_tree)
    jstate = jax.tree.map(np.array, new.opt_state)
    assert mine["1"] == {} and int(mine["0"]["count"]) == int(
        jstate[0].count) == 1
    for name in ("mu", "nu"):
        got = dict(flax_leaves(mine["0"][name]))
        for k, leaf in flax_leaves(getattr(jstate[0], name)):
            scale = np.abs(leaf).max() + 1e-30
            assert np.abs(got[k] - leaf).max() <= 1e-5 * scale, (name, k)


def test_loss_takes_the_row_before_normalizing():
    """Selecting the action's row of the raw logits and then taking the
    log-softmax over the atoms equals normalizing every row first."""
    logits = torch.randn(6, 64, 51, generator=torch.Generator().manual_seed(0))
    action = torch.tensor([0, 5, 63, 17, 17, 2])
    first = torch.log_softmax(rainbow._row(logits, action), -1)
    full = torch.log_softmax(logits, -1)[torch.arange(6), action]
    torch.testing.assert_close(first, full, rtol=0, atol=1e-6)


# -- the trainer ---------------------------------------------------------

def _configs(pool=False, interval=100):
    """Self-play, or (``pool``) job 07's mode: the non-learning colour
    played greedily by a frozen snapshot, the protagonist's colour drawn
    a game, one pushed every ``interval`` chunks."""
    kw = dict(initial_replay_size=0, batch_size=16,
              target_update_interval=SYNC)
    run = dict(num_envs=N, chunk_plies=PLIES, init_rand_steps=INIT,
               num_test_games=4, seed=3, opponent_pool=2 if pool else 0,
               pool_interval=interval)
    rb = dict(capacity=CAP, prioritized=True)
    return ((JaxEnvConfig(num_disk_as_reward=True),
             jrainbow.RainbowConfig(**kw), jreplay.ReplayConfig(**rb),
             jdqn_trainer.DQNRunConfig(**run)),
            (EnvConfig(num_disk_as_reward=True), RainbowConfig(**kw),
             ReplayConfig(**rb), DQNRunConfig(**run)))


class _Recording(jrtrain.RainbowTrainer):
    """JAX's Rainbow trainer with each ply's acting key recorded."""
    act_keys: list

    def _agent_act(self, params, board, turn, legal, key, eps):
        io_callback(lambda k: self.act_keys.append(np.array(k)), None, key,
                    ordered=True)
        return super()._agent_act(params, board, turn, legal, key, eps)


class _JaxPool:
    """JAX's Rainbow trainer in job 07's pool mode with its draws
    recorded, built once for the module so that its chunk program is
    traced and compiled once: every ``run`` starts the trainer from its
    initial state with its recordings cleared, and calls that program.

    ``run(chunks, interval)`` returns ``(trainer, draws, params before,
    each update's sampled rows)``; ``trainer.losses`` holds each update's
    loss and KL terms, ``trainer.snapshots`` the params, replay, ``t`` and
    the pool opponent's params after each chunk (copies of this run's,
    the live trainer under ``trainer.live``).  With no ``interval`` the
    frozen opponent is the initial params and each chunk's key JAX's
    ``fold_in(PRNGKey(17), c)``; with an ``interval`` the chunks run
    through JAX's ``train``, whose pool takes a snapshot every
    ``interval`` chunks and draws each chunk's opponent from it.  The
    trainer's ``pool_interval`` is 1: the chunk program does not read it,
    ``train`` does."""

    def __init__(self, jcfgs=None):
        self.moves, self.updates = [], []
        jcfgs = jcfgs or _configs(True, 1)[0]
        self.plies = jcfgs[3].chunk_plies
        tr = self.tr = _Recording(*jcfgs, log_fn=lambda *a: None)
        tr.act_keys, tr.losses, tr.snapshots = [], [], []
        tr.ensure_initialized()
        self.initial = jax.tree.map(np.array, (tr.agent, tr.replay,
                                               tr.roll))
        self.key, self.pool_rng = tr.key, copy.deepcopy(tr._pool_rng)
        real_chunk = tr._train_chunk

        def chunk(agent, replay, roll, key, snap):
            with self._recording():    # read while the program is traced
                out = real_chunk(agent, replay, roll, key, snap)
            jax.effects_barrier()
            tr.snapshots.append(dict(
                replay=jax.tree.map(np.array, out[1]),
                params=jax.tree.map(np.array, out[0].params),
                target=jax.tree.map(np.array, out[0].target_params),
                t=int(out[0].t), updates=len(tr.losses),
                opponent=None if snap is None else jax.tree.map(np.array,
                                                                snap)))
            return out
        tr._train_chunk = chunk
        self.runs = {}

    @contextlib.contextmanager
    def _recording(self):
        """JAX's random moves, sampled rows and losses recorded by
        ``io_callback`` into this object's lists."""
        moves, updates, tr = self.moves, self.updates, self.tr
        real_move = JaxBitEngine.random_legal
        real_sample = jrainbow.replay_sample_idx
        real_loss = jrainbow.rainbow_loss_grads

        def random_legal(engine, keys, state):
            a = real_move(engine, keys, state)
            io_callback(lambda w0, w1, a: moves.append(
                (np.stack([w0, w1], -1), np.array(a))), None,
                state.legal[0], state.legal[1], a, ordered=True)
            return a

        def sample_idx(rb, cfg, key, batch):
            idx = real_sample(rb, cfg, key, batch)
            io_callback(lambda u, i: updates.append(
                [np.array(u), np.array(i)]), None,
                jax.random.uniform(key, (batch,)), idx, ordered=True)
            return idx

        def loss_grads(state, cfg, apply_fn, batch, key):
            (loss, kl), grads = real_loss(state, cfg, apply_fn, batch, key)
            io_callback(lambda k, l, d: tr.losses.append(
                (np.array(k), float(l), np.array(d))), None, key, loss, kl,
                ordered=True)
            return (loss, kl), grads
        JaxBitEngine.random_legal = random_legal
        jrainbow.replay_sample_idx = sample_idx
        jrainbow.rainbow_loss_grads = loss_grads
        try:
            yield
        finally:
            JaxBitEngine.random_legal = real_move
            jrainbow.replay_sample_idx = real_sample
            jrainbow.rainbow_loss_grads = real_loss

    def run(self, chunks, interval=None):
        if (chunks, interval) in self.runs:
            return self.runs[chunks, interval]
        tr = self.tr
        tr.agent, tr.replay, tr.roll = jax.tree.map(jnp.asarray,
                                                    self.initial)
        tr.key, tr._pool_rng = self.key, copy.deepcopy(self.pool_rng)
        tr.pool, tr.chunk_count = [], 0
        for recorded in (self.moves, self.updates, tr.act_keys, tr.losses,
                         tr.snapshots):
            recorded.clear()
        params0, _, roll0 = self.initial
        params0 = params0.params
        if interval is not None:
            tr.train(num_chunks=chunks, log_every=10 ** 6)
        else:
            snap = jax.tree.map(jnp.asarray, params0)
            for c in range(chunks):
                tr.agent, tr.replay, tr.roll, _ = tr._train_chunk(
                    tr.agent, tr.replay, tr.roll,
                    jax.random.fold_in(jax.random.PRNGKey(17), c), snap)
        plies = self.plies
        assert len(tr.act_keys) == len(self.moves) == plies * chunks
        sizes = _sizes(RainbowNet())
        acts = [_jax_noise(k, sizes) for k in tr.act_keys]
        normals, first = [], 0
        for c, snapshot in enumerate(tr.snapshots):     # program order
            normals += acts[c * plies:(c + 1) * plies]
            for k, _, _ in tr.losses[first:snapshot["updates"]]:
                normals += [_jax_noise(s, sizes)
                            for s in jax.random.split(k, 3)]
            first = snapshot["updates"]
        colors, rand_left = _reset_draws(jnp.asarray(roll0.env_keys),
                                         plies * chunks)
        draws = sp.InjectedDraws(
            colors=[torch.from_numpy(roll0.pcolor)] + list(map(
                torch.from_numpy, colors)),
            uniforms=(),
            rand_left=[torch.from_numpy(roll0.rand_left)] + list(map(
                torch.from_numpy, rand_left)),
            legal_index=[_legal_rank(w, m) for w, m in self.moves],
            replay_uniforms=[torch.from_numpy(u) for u, _ in self.updates],
            normals=normals)
        recorded = types.SimpleNamespace(
            live=tr, run_cfg=dataclasses.replace(
                tr.run_cfg, pool_interval=interval or 100),
            losses=list(tr.losses), snapshots=list(tr.snapshots))
        self.runs[chunks, interval] = (
            recorded, draws, params0,
            [torch.from_numpy(i) for _, i in self.updates])
        return self.runs[chunks, interval]


@pytest.fixture(scope="module")
def jax_pool():
    return _JaxPool()


def _port(draws=None, params=None, pool=False, interval=100):
    _, cfgs = _configs(pool, interval)
    tr = RainbowTrainer(*cfgs, log_fn=lambda *a: None, device="cpu")
    if draws is not None:
        tr.draws = draws
    if params is not None:
        load_flax_params(tr.agent.net, params)
        load_flax_params(tr.agent.target, params)
    return tr


def _chunk_checker(jtr, draws, params0, jidx, monkeypatch, rtol=2e-3,
                   rebase=False):
    """``(tr, check, worst)``: the port's trainer on JAX's draws, params
    and sampled rows; ``check(c, metrics)``, which holds the state after
    chunk ``c`` to JAX's snapshot ``c`` as ``test_pool_chunks_equal_jax``
    says, the params per leaf within ``rtol`` of the leaf's largest
    delta (since the start, or with ``rebase`` since JAX's params at the
    chunk's start); and ``worst``, each chunk's largest such ratio."""
    taken, losses = iter(jidx), []
    real_loss = rainbow.rainbow_loss_grads

    def loss_grads(state, cfg, batch, draws_):
        loss, kl = real_loss(state, cfg, batch, draws_)
        losses.append((float(loss), kl.numpy().copy()))
        return loss, kl
    monkeypatch.setattr(rainbow, "replay_sample_idx",
                        lambda rb, cfg, u: next(taken).to(torch.int64))
    monkeypatch.setattr(rainbow, "rainbow_loss_grads", loss_grads)
    run = jtr.run_cfg
    tr = _port(draws, params0, True, run.pool_interval)
    start = _leaves(_port_net(params0))
    worst = []

    def check(c, metrics):
        s = jtr.snapshots[c]
        begin = (_leaves(_port_net(jtr.snapshots[c - 1]["params"]))
                 if rebase and c else start)
        first = jtr.snapshots[c - 1]["updates"] if c else 0
        rb, jrb = tr.replay, s["replay"]
        size = int(jrb.size)
        assert size > 40 and int(rb.size) == size, c
        assert int(rb.write_pos) == int(jrb.write_pos), c
        assert tr.agent.t == s["t"] > SYNC * (c + 1), c
        want = jreplay.replay_gather(jrb, jnp.arange(size))
        got = _rows(rb, size)
        for f, w in zip(FIELDS, want):
            np.testing.assert_array_equal(got[f], np.asarray(w),
                                          err_msg=f"{f} chunk {c}")
        assert got["done"].any() and (got["reward"] != 0).any()
        assert metrics["updates"] == s["updates"] - first == len(
            losses) - first == 64
        for i in range(first, s["updates"]):
            (loss, kl), (_, jloss, jkl) = losses[i], jtr.losses[i]
            assert loss == pytest.approx(jloss, rel=1e-4), (c, i)
            np.testing.assert_allclose(kl, jkl, rtol=0, atol=1e-4,
                                       err_msg=f"chunk {c} update {i}")
        port = _leaves(tr.agent.net)
        worst.append(0.0)
        for k, w in _leaves(_port_net(s["params"])).items():
            wd, gd = (w - begin[k]).numpy(), (port[k] - begin[k]).numpy()
            big = np.abs(wd).max()
            worst[-1] = max(worst[-1], np.abs(gd - wd).max() / big)
            assert np.abs(gd - wd).max() <= rtol * big + 1e-8, (c, k)
        for a, b in zip(tr.agent.net.parameters(),
                        tr.agent.target.parameters()):
            assert torch.equal(a, b)
        np.testing.assert_allclose(rb.priority[:size].numpy(),
                                   np.asarray(jrb.priority[:size]),
                                   rtol=0, atol=5e-4, err_msg=str(c))
    return tr, check, worst


def test_pool_chunks_equal_jax(monkeypatch, jax_pool):
    """Two chunks in job 07's pool mode (a frozen snapshot, the initial
    params, plays the other colour; the protagonist's colour drawn a
    game) on PER: 64 plies a chunk at N 8 with 4 random opening plies and
    64 updates of 16 rows, each chunk crossing a target sync.  After
    each chunk: the replay rows, write position and size exactly; every
    update, on the rows and noise JAX drew, its loss to rtol 1e-4 and KL
    terms to 1e-4; the online params per leaf within 2e-3 of the leaf's
    largest delta since the start plus 1e-8, the target synced to them;
    the priorities to 5e-4.  The params' bound: Adam's step is ``m /
    (sqrt(v) + eps)`` with eps 1.5e-4, so a gradient's float32 error
    counts ``1 / eps`` in the step where the step's size counts
    ``1 / |g|``, and the updates carry it on (measured 3.4e-5 and
    1.4e-4 after 64 and 128 updates; a self-play chunk of 128 updates
    read 5.5e-4 of ``val_fc.w_sigma``'s largest delta); the losses, which
    hold to 1e-4 at every update, show the two runs on the same path."""
    jtr, draws, params0, jidx = jax_pool.run(2)
    tr, check, _ = _chunk_checker(jtr, draws, params0, jidx, monkeypatch)
    snap = tr._snapshot()
    for c in range(len(jtr.snapshots)):
        check(c, tr.train_chunk(snap))
    with pytest.raises(StopIteration):     # every recorded normal was used
        draws.normals(1, "cpu")


def test_pool_interval_1_chunks_equal_jax(monkeypatch, jax_pool):
    """Three chunks of the pool mode through both trainers' ``train``
    with a snapshot pushed after every chunk (``pool_interval=1``, two
    kept): chunk 1 plays the initial params, chunks 2 and 3 an opponent
    drawn by the pool's ``random.Random(seed)`` from snapshots that the
    updates moved, so the pool's push, eviction and draw, and a frozen
    opponent other than the initial net, are held to JAX's.

    Each chunk starts from JAX's params: after the chunk is checked, the
    port's online and target nets take JAX's params of that chunk's end,
    so the snapshot the pool then pushes is JAX's, and each opponent the
    port plays must equal the one JAX played bit for bit.  Free-running,
    the third chunk's rows part at one opponent move whose two best
    expected values lie 2.9e-8 apart, the snapshots differing by 6e-5
    (float32 rounding carried through 128 updates), so the rows cannot
    be held exactly past it.  Each chunk is then checked as
    ``test_pool_chunks_equal_jax`` checks its two, the params per leaf
    within 2e-2 of the leaf's largest delta since the chunk's start plus
    1e-8 (measured 7.4e-3 after the first chunk: its 64 updates on this
    chunk's rows move ``trunk.conv0.weight`` by 2.1e-3 at most, and Adam
    at eps 1.5e-4 weighs a gradient's rounding by 1 / eps there)."""
    jtr, draws, params0, jidx = jax_pool.run(3, interval=1)
    tr, check, worst = _chunk_checker(jtr, draws, params0, jidx,
                                      monkeypatch, rtol=2e-2, rebase=True)
    real_chunk, played = tr.train_chunk, []

    def train_chunk(snap=None):
        c = len(played)
        played.append(_leaves(snap))
        metrics = real_chunk(snap)
        check(c, metrics)
        for net in (tr.agent.net, tr.agent.target):
            load_flax_params(net, jtr.snapshots[c]["params"])
        return metrics
    tr.train_chunk = train_chunk
    tr.train(3, log_every=10 ** 6)
    assert len(played) == 3 and len(tr.pool) == 2
    start = _leaves(_port_net(params0))
    moved = []
    for c, (mine, s) in enumerate(zip(played, jtr.snapshots)):
        want = _leaves(_port_net(s["opponent"]))
        assert all(torch.equal(mine[k], w) for k, w in want.items()), c
        moved.append(max(float((w - start[k]).abs().max())
                         for k, w in want.items()))
    # Chunk 2 draws the initial params again, chunk 3 a trained snapshot.
    assert moved[0] == 0.0 and max(moved[1:]) > 1e-3, moved
    assert max(worst) > 0.0
    with pytest.raises(StopIteration):     # every recorded normal was used
        draws.normals(1, "cpu")


def test_save_load_bytes_equal_jax_both_ways(tmp_path, jax_pool):
    """JAX's checkpoint (params, Adam state, ``extra.t``) loaded by the
    port and written again is the same file; the port's, loaded by JAX's
    trainer and written again, too."""
    jtr = jax_pool.run(2)[0].live
    jtr.chunk_count = 1
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jtr.save(str(jax_path))
    tr = _port()
    tr.load(str(jax_path))
    assert tr.agent.t == int(jtr.agent.t) > 0 and tr.chunk_count == 1
    tr.save(str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    tr.run_cfg = DQNRunConfig(num_envs=N, chunk_plies=4, seed=3)
    tr.train_chunk()
    tr.chunk_count = 2
    tr.save(str(port_path))
    jtr.load(str(port_path))
    assert int(jtr.agent.t) == tr.agent.t and jtr.chunk_count == 2
    jtr.save(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    with pytest.raises(ValueError, match="optax adam"):
        tr.agent.optimizer.load_optax_state({"0": {}, "1": {}}, None)


def test_pool_mode_and_evaluation():
    """The opponent pool plays noise-off greedy snapshots; the evaluation
    is deterministic (no draws) and gives rates in [0, 1]."""
    run = DQNRunConfig(num_envs=N, chunk_plies=8, opponent_pool=2,
                       pool_interval=1, test_interval=10_000,
                       num_test_games=4, seed=11)
    tr = RainbowTrainer(EnvConfig(num_disk_as_reward=True),
                        RainbowConfig(batch_size=8, initial_replay_size=1),
                        ReplayConfig(capacity=512, prioritized=True), run,
                        log_fn=lambda *a: None, device="cpu")
    tr.train(num_chunks=3, log_every=100)
    assert len(tr.pool) == 2 and tr.agent.t > 0
    assert all(bool(torch.isfinite(p).all())
               for p in tr.agent.net.parameters())
    board = torch.zeros(3, 8, 8, dtype=torch.int8)
    legal = torch.ones(3, 64, dtype=torch.bool)
    turn = torch.ones(3, dtype=torch.int8)
    a = tr._opponent_greedy(tr.pool[0], board, turn, legal)
    assert torch.equal(a, tr._opponent_greedy(tr.pool[0], board, turn,
                                              legal))
    rates = tr.evaluate()
    assert set(rates) == {"rand", "greedy"}
    assert all(0.0 <= r <= 1.0 for r in rates.values())
    assert float(tr._epsilon(tr.agent.t)) == 0.0


def test_cli_runs_and_resumes(tmp_path):
    ckpt = str(tmp_path / "rainbow.msgpack")
    argv = ["--device", "cpu", "--num-envs", "8", "--chunk-plies", "8",
            "--replay-size", "4096", "--initial-replay-size", "0",
            "--batch-size", "16", "--num-test-games", "4", "--log-every",
            "1", "--checkpoint", ckpt]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = rainbow_train.main(argv + ["--num-chunks", "2"])
    text = out.getvalue()
    assert tr.chunk_count == 2 and "final eval:" in text
    assert "device: cpu; float32" in text and os.path.exists(ckpt)
    assert tr.rb_cfg.prioritized
    with contextlib.redirect_stdout(io.StringIO()):
        tr2 = rainbow_train.main(argv + ["--num-chunks", "1", "--load",
                                         ckpt])
    assert tr2.chunk_count == 3 and tr2.agent.t > tr.agent.t
    with pytest.raises(ValueError, match="n_devices=2"):
        rainbow_train.main(argv + ["--data-parallel", "2", "--dist-backend",
                                   "gloo"])
    with contextlib.redirect_stderr(io.StringIO()) as err, \
            pytest.raises(SystemExit):
        rainbow_train.main(argv + ["--replay-sharding", "per-shard"])
    assert "requires --data-parallel" in err.getvalue()
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        RainbowTrainer(mesh=object(), device="cpu")
