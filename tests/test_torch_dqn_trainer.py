"""The port's DQN trainer (``train/dqn_trainer.py``) against JAX's: one
chunk's emissions with JAX's draws injected and its updates on JAX's
sampled rows, in shared self-play and against the greedy opponent on
PER; the ``force_plane`` collection equal to the
bitboard one (JAX's ``test_dqn_bit_and_plane_collection_identical``);
the opponent-pool mode; ``save``/``load`` with ``extra.t`` byte for byte
with JAX's trainer both ways; and the CLI on the CPU.

Draw injection: JAX's epsilon uniforms and its random moves (the
categorical of ``dqn_act`` and ``BitEngine.random_legal`` of the random
openings) are recorded in program order by ``io_callback``; each reset's
colours and opening counts are rebuilt from the per-game keys, which
advance the same way every ply.  The port gets them as ``InjectedDraws``
(moves as ranks among the legal ones) and JAX's initial params.  Then the
replay (every field of every filled row), its write position and size,
and ``t`` must be equal."""

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

from gymothelloenv_tpu.agents import dqn as jdqn
from gymothelloenv_tpu.agents import replay as jreplay
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import dqn_trainer as jtrain
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.agents import dqn as dqn_mod
from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.cli import dqn_train
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import load_flax_params
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)
from torch_port_helpers import one_torch_thread  # noqa: F401

N, PLIES, INIT, CAP, TARGET_SYNC = 8, 64, 4, 2048, 200
# The three-chunk witness: a ring that one chunk's transitions do not fill
# and three do (it wraps in the third), and a target sync each chunk.
WITNESS_CHUNKS, WITNESS_CAP, WITNESS_SYNC = 3, 1280, 400
FIELDS = ("board", "turn", "action", "reward", "next_board", "next_turn",
          "done")


def _configs(opponent, n_step, dueling, force_plane=False, per=None,
             cap=CAP, sync=TARGET_SYNC):
    """Self-play on a uniform replay, or against greedy on PER (``per``
    overrides); the chunk's updates start at once (128 and 64 of them)
    and its transitions cross a target-sync boundary."""
    kw = dict(n_step=n_step, dueling=dueling, double=True,
              initial_replay_size=0, batch_size=16,
              target_update_interval=sync,
              initial_epsilon=0.5, final_epsilon=0.5)
    run = dict(num_envs=N, chunk_plies=PLIES, opponent=opponent,
               init_rand_steps=INIT, num_test_games=4, seed=3,
               force_plane=force_plane)
    rb = dict(capacity=cap, prioritized=(opponent is not None if per is None
                                         else per))
    return ((JaxEnvConfig(num_disk_as_reward=True), jdqn.DQNConfig(**kw),
             jreplay.ReplayConfig(**rb), jtrain.DQNRunConfig(**run)),
            (EnvConfig(num_disk_as_reward=True), DQNConfig(**kw),
             ReplayConfig(**rb), DQNRunConfig(**run)))


class _Recording(jtrain.DQNTrainer):
    """JAX's trainer with its epsilon uniforms and random moves recorded
    (``dqn_act``'s own draws, recomputed from its key)."""
    acts: list
    updates: list    # each update's replay uniforms and sampled rows
    losses: list     # each update's loss and TD errors


    def _agent_act(self, params, board, turn, legal, key, eps):
        k_eps, k_rand = jax.random.split(key)
        u = jax.random.uniform(k_eps, (board.shape[0],))
        rand = jax.random.categorical(
            k_rand, jnp.where(legal, 0.0, -jnp.inf), axis=-1)
        io_callback(lambda lg, u, a: self.acts.append(
            (np.array(lg), np.array(u), np.array(a))), None, legal, u, rand,
            ordered=True)
        return super()._agent_act(params, board, turn, legal, key, eps)


def _split(keys):
    both = jax.vmap(jax.random.split)(keys)
    return both[:, 0], both[:, 1]


def _reset_draws(env_keys, plies=PLIES):
    """Each ply's fresh colours and opening counts, rebuilt from the
    per-game keys as JAX's ply advances them."""
    colors, rand_left = [], []
    for _ in range(plies):
        env_keys, _ = _split(env_keys)          # the opening move's key
        env_keys, sub = _split(env_keys)
        k_rand, k_color = _split(sub)
        rand_left.append(np.array(jax.vmap(draw_max_rand_steps,
                                           in_axes=(0, None))(k_rand, INIT)))
        colors.append(np.array(jax.vmap(lambda k: jax.random.randint(
            k, (), 0, 2))(k_color) * 2 - 1))
    return colors, rand_left


def _rank(legal, action):
    """Each row's ``action`` as its rank among the row's legal moves."""
    return torch.tensor([int(legal[i, :action[i]].sum())
                         for i in range(len(action))])


@functools.cache
def _jax_chunk(opponent, n_step, dueling, chunks=1, per=None, cap=CAP,
               sync=TARGET_SYNC):
    """``chunks`` JAX chunks with their draws recorded: ``(trainer, draws,
    params before the first chunk, each update's sampled rows)``; the
    trainer's ``snapshots`` hold, after each chunk, its replay, params,
    target params and how many updates had run."""
    moves = []
    real = JaxBitEngine.random_legal

    def random_legal(self, keys, state):
        a = real(self, keys, state)
        io_callback(lambda w0, w1, a: moves.append(
            (np.stack([w0, w1], -1), np.array(a))), None,
            state.legal[0], state.legal[1], a, ordered=True)
        return a
    def loss_grads(state, cfg, apply_fn, batch):
        (loss, td), grads = real_loss_grads(state, cfg, apply_fn, batch)
        io_callback(lambda l, t: tr.losses.append((float(l), np.array(t))),
                    None, loss, td, ordered=True)
        return (loss, td), grads

    def sample_idx(rb, cfg, key, batch):
        idx = real_sample(rb, cfg, key, batch)
        io_callback(lambda u, i: tr.updates.append(
            (np.array(u), np.array(i))), None,
            jax.random.uniform(key, (batch,)), idx, ordered=True)
        return idx
    real_sample = jdqn.replay_sample_idx
    real_loss_grads = jdqn.dqn_loss_grads
    JaxBitEngine.random_legal = random_legal
    jdqn.replay_sample_idx = sample_idx
    jdqn.dqn_loss_grads = loss_grads
    try:
        jcfgs, _ = _configs(opponent, n_step, dueling, per=per, cap=cap,
                            sync=sync)
        tr = _Recording(*jcfgs, log_fn=lambda *a: None)
        tr.acts, tr.updates, tr.losses, tr.snapshots = [], [], [], []
        tr.ensure_initialized()
        params0 = jax.tree.map(np.array, tr.agent.params)
        roll0 = jax.tree.map(np.array, tr.roll)
        for c in range(chunks):
            key = jax.random.PRNGKey(17)
            if c:
                key = jax.random.fold_in(key, c)
            tr.agent, tr.replay, tr.roll, _ = tr._train_chunk(
                tr.agent, tr.replay, tr.roll, key)
            jax.effects_barrier()
            tr.snapshots.append(dict(
                replay=jax.tree.map(np.array, tr.replay),
                params=jax.tree.map(np.array, tr.agent.params),
                target=jax.tree.map(np.array, tr.agent.target_params),
                t=int(tr.agent.t), updates=len(tr.updates)))
    finally:
        JaxBitEngine.random_legal = real
        jdqn.replay_sample_idx = real_sample
        jdqn.dqn_loss_grads = real_loss_grads
    assert len(tr.acts) == len(moves) == PLIES * chunks
    colors, rand_left = _reset_draws(jnp.asarray(roll0.env_keys),
                                     PLIES * chunks)
    legal_index = []
    for (lg, _, a), (w, m) in zip(tr.acts, moves):
        legal_index += [_rank(lg, a), _legal_rank(w, m)]
    draws = sp.InjectedDraws(
        colors=[torch.from_numpy(roll0.pcolor)] + list(map(
            torch.from_numpy, colors)),
        uniforms=[torch.from_numpy(u) for _, u, _ in tr.acts],
        rand_left=[torch.from_numpy(roll0.rand_left)] + list(map(
            torch.from_numpy, rand_left)),
        legal_index=legal_index,
        replay_uniforms=[torch.from_numpy(u) for u, _ in tr.updates])
    return tr, draws, params0, [torch.from_numpy(i) for _, i in tr.updates]


def _legal_rank(legal_pair, action):
    legal = tb.pack_pair(legal_pair)
    a = torch.from_numpy(action.astype(np.int64)).clamp(0, 63)
    return tb.popcount(legal & ((torch.ones_like(a) << a) - 1))


def _port(opponent, n_step, dueling, draws=None, params=None,
          force_plane=False, **kw):
    _, cfgs = _configs(opponent, n_step, dueling, force_plane, **kw)
    tr = DQNTrainer(*cfgs, log_fn=lambda *a: None, device="cpu")
    if draws is not None:
        tr.draws = draws
    if params is not None:
        load_flax_params(tr.agent.net, params)
        load_flax_params(tr.agent.target, params)
    return tr


def _rows(rb, size):
    return dict(zip(FIELDS, (getattr(rb, f)[:size].numpy()
                             for f in FIELDS)))


def _leaves(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("opponent,n_step,dueling", [(None, 2, False),
                                                     ("greedy", 3, True)])
def test_chunk_emissions_equal_jax(opponent, n_step, dueling, monkeypatch):
    """The chunk's replay rows equal JAX's.  Then its updates, each on the
    rows JAX sampled (PER: the port's own sampler, given JAX's uniforms,
    picks the same rows but for prefix-sum rounding at a segment's edge,
    counted): every update's loss to rtol 1e-4 and TD errors to 1e-4;
    the online params after them per leaf within ``rtol`` of the leaf's
    largest delta plus 1e-8, the target synced to them; with PER the
    refreshed priorities to 5e-4, which TD errors 1e-4 apart allow.

    ``rtol`` is 1e-4 in self-play (measured 4.0e-5 after 128 updates) and
    2e-2 against greedy on PER with the dueling net (measured 7.4e-3
    after 64): there, in a few updates, a ReLU input lies within float32
    rounding of 0 and falls on the other side of the kink in XLA's
    arithmetic, and the later updates carry that gradient on
    (``relu_flip_report``: update 21 differs from JAX's gradient by
    4.6e-3 of a leaf's largest, 1.5e-3 once the port flips its ReLU
    inputs within 1e-6 of 0; update 38 by 5.1e-2, 1.8e-5 flipped).  The
    16-row PER batches, many rows repeated, weigh one row's unit heavily;
    the TD errors, which a unit at 0 hardly moves, hold to 1e-4."""
    jtr, draws, params0, jidx = _jax_chunk(opponent, n_step, dueling)
    rtol = 1e-4 if opponent is None else 2e-2
    taken, moved, losses = iter(jidx), [], []
    real_sample = dqn_mod.replay_sample_idx
    real_loss_grads = dqn_mod.dqn_loss_grads

    def sample(rb, cfg, u):
        want = next(taken)
        if cfg.prioritized:
            moved.append(int((real_sample(rb, cfg, u) != want).sum()))
        return want.to(torch.int64)

    def loss_grads(state, cfg, batch):
        loss, td = real_loss_grads(state, cfg, batch)
        losses.append((float(loss), td.numpy().copy()))
        return loss, td
    monkeypatch.setattr(dqn_mod, "replay_sample_idx", sample)
    monkeypatch.setattr(dqn_mod, "dqn_loss_grads", loss_grads)
    tr = _port(opponent, n_step, dueling, draws, params0)
    metrics = tr.train_chunk()
    size = int(jtr.replay.size)
    assert size > 40 and int(tr.replay.size) == size
    assert int(tr.replay.write_pos) == int(jtr.replay.write_pos)
    assert tr.agent.t == int(jtr.agent.t) > TARGET_SYNC
    want = jreplay.replay_gather(jtr.replay, jnp.arange(size))
    got = _rows(tr.replay, size)
    for f, w in zip(FIELDS, want):
        np.testing.assert_array_equal(got[f], np.asarray(w), err_msg=f)
    assert got["done"].any() and (got["reward"] != 0).any()
    np.testing.assert_array_equal(tr.roll.pcolor.numpy(),
                                  np.asarray(jtr.roll.pcolor))
    np.testing.assert_array_equal(tr.roll.rand_left.numpy(),
                                  np.asarray(jtr.roll.rand_left))
    with pytest.raises(StopIteration):     # every recorded draw was used
        draws.legal_index(torch.zeros(N, dtype=torch.int64))
    with pytest.raises(StopIteration):     # as many updates as JAX's
        next(taken)
    assert metrics["updates"] == len(jidx) == (128 if opponent is None
                                               else 64)
    for i, ((loss, td), (jloss, jtd)) in enumerate(zip(losses, jtr.losses,
                                                       strict=True)):
        assert loss == pytest.approx(jloss, rel=1e-4), i
        np.testing.assert_allclose(td, jtd, rtol=0, atol=1e-4,
                                   err_msg=str(i))
    cls = type(tr.agent.net)
    start = _leaves(load_flax_params(cls(num_actions=64, board_size=8),
                                     params0))
    jnet = load_flax_params(cls(num_actions=64, board_size=8),
                            jax.tree.map(np.array, jtr.agent.params))
    port = _leaves(tr.agent.net)
    for k, w in _leaves(jnet).items():
        wd, gd = (w - start[k]).numpy(), (port[k] - start[k]).numpy()
        assert np.abs(gd - wd).max() <= rtol * np.abs(wd).max() + 1e-8, k
    for a, b in zip(tr.agent.net.parameters(), tr.agent.target.parameters()):
        assert torch.equal(a, b)            # the target synced
    if opponent is not None:
        np.testing.assert_allclose(
            tr.replay.priority[:size].numpy(),
            np.asarray(jtr.replay.priority[:size]), rtol=0, atol=5e-4)
        np.testing.assert_allclose(float(tr.replay.max_priority),
                                   float(jtr.replay.max_priority),
                                   rtol=0, atol=5e-4)
        assert sum(moved) <= len(jidx)      # at most one row an update


def test_three_chunks_wrap_and_sync_equal_jax(monkeypatch):
    """Job 60's kind (self-play, n-step 3, double, dueling, PER) over three
    chunks: the ring (``WITNESS_CAP`` rows) wraps in the third and the
    target syncs after each.  After every chunk: the replay rows, their
    write position and size exactly; each of the chunk's updates, on the
    rows JAX sampled, its loss to rtol 1e-4 and TD errors to 1e-4; the
    online and target params per leaf within 1e-4 of the leaf's largest
    delta since the start plus 1e-8 (the one-chunk self-play bound); the
    target equal to the online net; the priorities to 5e-4."""
    kw = dict(per=True, cap=WITNESS_CAP, sync=WITNESS_SYNC)
    jtr, draws, params0, jidx = _jax_chunk(None, 3, True, WITNESS_CHUNKS,
                                           **kw)
    taken, losses = iter(jidx), []
    real_loss_grads = dqn_mod.dqn_loss_grads

    def loss_grads(state, cfg, batch):
        loss, td = real_loss_grads(state, cfg, batch)
        losses.append((float(loss), td.numpy().copy()))
        return loss, td
    monkeypatch.setattr(dqn_mod, "replay_sample_idx",
                        lambda rb, cfg, u: next(taken).to(torch.int64))
    monkeypatch.setattr(dqn_mod, "dqn_loss_grads", loss_grads)
    tr = _port(None, 3, True, draws, params0, **kw)
    cls = type(tr.agent.net)

    def leaves(params):
        return _leaves(load_flax_params(cls(num_actions=64, board_size=8),
                                        params))
    start, t_old, wrapped = leaves(params0), 0, False
    for c, snap in enumerate(jtr.snapshots):
        tr.train_chunk()
        rb, jrb = tr.replay, snap["replay"]
        size = int(jrb.size)
        assert int(rb.size) == size and tr.agent.t == snap["t"], c
        assert int(rb.write_pos) == int(jrb.write_pos), c
        wrapped |= snap["t"] > WITNESS_CAP
        want = jreplay.replay_gather(jrb, jnp.arange(size))
        got = _rows(rb, size)
        for f, w in zip(FIELDS, want):
            np.testing.assert_array_equal(got[f], np.asarray(w),
                                          err_msg=f"{f} chunk {c}")
        first = 0 if c == 0 else jtr.snapshots[c - 1]["updates"]
        assert len(losses) == snap["updates"] > first, c
        for i in range(first, snap["updates"]):
            (loss, td), (jloss, jtd) = losses[i], jtr.losses[i]
            assert loss == pytest.approx(jloss, rel=1e-4), (c, i)
            np.testing.assert_allclose(td, jtd, rtol=0, atol=1e-4,
                                       err_msg=f"chunk {c} update {i}")
        assert snap["t"] // WITNESS_SYNC > t_old // WITNESS_SYNC
        t_old = snap["t"]
        for name, net, jparams in (("online", tr.agent.net, snap["params"]),
                                   ("target", tr.agent.target,
                                    snap["target"])):
            port = _leaves(net)
            for k, w in leaves(jparams).items():
                wd = (w - start[k]).numpy()
                gd = (port[k] - start[k]).numpy()
                assert (np.abs(gd - wd).max()
                        <= 1e-4 * np.abs(wd).max() + 1e-8), (c, name, k)
        for a, b in zip(tr.agent.net.parameters(),
                        tr.agent.target.parameters()):
            assert torch.equal(a, b), c        # the target synced
        np.testing.assert_allclose(rb.priority[:size].numpy(),
                                   np.asarray(jrb.priority[:size]),
                                   rtol=0, atol=5e-4, err_msg=str(c))
    assert wrapped and int(tr.replay.size) == WITNESS_CAP
    with pytest.raises(StopIteration):     # as many updates as JAX's
        next(taken)


def test_force_plane_collection_equals_bitboard():
    """Two chunks against greedy with the same seed: the replay is the
    same row for row on planes and on words."""
    rows = {}
    for force_plane in (False, True):
        tr = _port("greedy", 2, False, force_plane=force_plane)
        for _ in range(2):
            tr.train_chunk()
        rows[force_plane] = (tr.agent.t, _rows(tr.replay,
                                               int(tr.replay.size)))
    (t_bit, bit), (t_plane, plane) = rows[False], rows[True]
    assert t_bit == t_plane > 0
    for f in FIELDS:
        np.testing.assert_array_equal(bit[f], plane[f], err_msg=f)


def test_opponent_pool_mode():
    """The non-learning colour plays greedily from a frozen snapshot;
    only the protagonist's colour feeds the replay; the pool is trimmed
    to ``opponent_pool``."""
    run = DQNRunConfig(num_envs=N, chunk_plies=8, opponent_pool=2,
                       pool_interval=1, test_interval=10_000, seed=11)
    tr = DQNTrainer(EnvConfig(num_disk_as_reward=True),
                    DQNConfig(batch_size=8, initial_replay_size=1, n_step=2),
                    ReplayConfig(capacity=512), run, log_fn=lambda *a: None,
                    device="cpu")
    tr.train(num_chunks=3, log_every=100)
    assert len(tr.pool) == 2
    assert 0 < tr.agent.t <= 3 * 8 * 8 + 16
    assert all(bool(torch.isfinite(p).all())
               for p in tr.agent.net.parameters())
    assert not any(p.requires_grad for p in tr.pool[0].parameters())


def test_save_load_bytes_equal_jax_both_ways(tmp_path):
    """JAX's checkpoint (params, RMSprop state, ``extra.t``) loaded by the
    port and written again is the same file; the port's, loaded by JAX's
    trainer and written again, too."""
    jtr, _, _, _ = _jax_chunk(None, 2, False)
    jtr.chunk_count = 1
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jtr.save(str(jax_path))
    tr = _port(None, 2, False)
    tr.load(str(jax_path))
    assert tr.agent.t == int(jtr.agent.t) > 0 and tr.chunk_count == 1
    tr.save(str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    tr.train_chunk()
    tr.chunk_count = 2
    tr.save(str(port_path))
    jtr.load(str(port_path))
    assert int(jtr.agent.t) == tr.agent.t and jtr.chunk_count == 2
    jtr.save(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()


def test_cli_runs_and_resumes(tmp_path):
    ckpt = str(tmp_path / "dqn.msgpack")
    argv = ["--device", "cpu", "--num-envs", "8", "--chunk-plies", "8",
            "--replay-size", "4096", "--initial-replay-size", "0",
            "--batch-size", "16", "--num-test-games", "4", "--prioritized",
            "1", "--double", "1", "--dueling", "1", "--n-step", "3",
            "--log-every", "1", "--checkpoint", ckpt]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = dqn_train.main(argv + ["--num-chunks", "2"])
    text = out.getvalue()
    assert tr.chunk_count == 2 and "final eval:" in text
    assert "device: cpu; float32" in text and os.path.exists(ckpt)
    with contextlib.redirect_stdout(io.StringIO()):
        tr2 = dqn_train.main(argv + ["--num-chunks", "1", "--load", ckpt])
    assert tr2.chunk_count == 3 and tr2.agent.t > tr.agent.t
    # A mesh of two ranks needs a group of two; per-shard replay needs a
    # mesh (JAX's usage error).
    with pytest.raises(ValueError, match="n_devices=2"):
        dqn_train.main(argv + ["--data-parallel", "2", "--dist-backend",
                               "gloo"])
    with contextlib.redirect_stderr(io.StringIO()) as err, \
            pytest.raises(SystemExit):
        dqn_train.main(argv + ["--replay-sharding", "per-shard"])
    assert "requires --data-parallel" in err.getvalue()


def relu_flip_report(threshold=1e-6):
    """Print, for each update of the PER chunk against greedy whose
    gradient differs from JAX's by more than 1e-4 of a leaf's largest,
    that reading and the reading once the port flips its ReLU inputs
    that are not 0 but within ``threshold`` of it (the cause named in
    ``test_chunk_emissions_equal_jax``).  After the first such update
    the two runs' params differ, so later readings compare unlike
    states.  Run: ``JAX_PLATFORMS=cpu python
    tests/test_torch_dqn_trainer.py``."""
    from gymothelloenv_tpu_torch.models.convert import tensors_from_flax
    grads, real = [], jdqn.dqn_loss_grads

    def recording(state, cfg, apply_fn, batch):
        out = real(state, cfg, apply_fn, batch)
        io_callback(lambda g: grads.append(jax.tree.map(np.array, g)),
                    None, out[1], ordered=True)
        return out
    jdqn.dqn_loss_grads = recording
    try:
        _jax_chunk.cache_clear()
        _, draws, params0, jidx = _jax_chunk("greedy", 3, True)
        jax.effects_barrier()
    finally:
        jdqn.dqn_loss_grads = real
        _jax_chunk.cache_clear()
    tr = _port("greedy", 3, True, draws, params0)
    taken, port_grads, relu = iter(jidx), dqn_mod.dqn_loss_grads, torch.relu

    def flipped(x):
        near = (x.abs() < threshold) & (x != 0)
        return x * ((x > 0) ^ near).to(x.dtype)

    def gap(state):
        want = tensors_from_flax(state.net, grads[len(seen)])
        return max(float((p.grad - w).abs().max() / w.abs().max())
                   for p, w in zip(state.net.parameters(), want))
    seen = []

    def loss_grads(state, cfg, batch):
        out = port_grads(state, cfg, batch)
        plain = gap(state)
        if plain > 1e-4:
            kept = [p.grad for p in state.net.parameters()]
            torch.relu = flipped
            try:
                port_grads(state, cfg, batch)
            finally:
                torch.relu = relu
            print(f"update {len(seen)}: gradient {plain:.3e} of a leaf's "
                  f"largest; {gap(state):.3e} with the ReLU inputs within "
                  f"{threshold} of 0 flipped", flush=True)
            for p, g in zip(state.net.parameters(), kept):
                p.grad = g
        seen.append(plain)
        return out
    dqn_mod.replay_sample_idx = lambda rb, cfg, u: next(taken).to(
        torch.int64)
    dqn_mod.dqn_loss_grads = loss_grads
    torch.set_num_threads(1)
    tr.train_chunk()


if __name__ == "__main__":
    relu_flip_report()
