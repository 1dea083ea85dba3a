"""The port's teacher-vs-student PPO (``train/teacher_student.py``,
``collect_ts_rollout``) against JAX's at N 8, T 4 (several rollouts in
a row, so games end and reset) on the 8x8 bitboard, JAX's draws
injected; and forward parity on the three committed ``data/ts``
checkpoints (1e-5, absolute or relative: their logits reach ~40).  The
6x6 rollout (planes, random openings), the trainer, its checkpoints and
the CLI are in test_torch_ts_trainer.py, which shares these helpers.

Both nets are peaked (``_ranked``: 200 x a fixed cell ranking in the
logits), so a sample does not depend on its uniform.  JAX's random
opening moves and each reset's teacher colours and opening counts are
recorded in program order by ``io_callback`` and handed to the port
(``InjectedDraws``, moves as ranks among the legal ones).  Records,
weights and bootstraps must then match: integers and planes exactly,
floats to 1e-6."""

import functools
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.core import engine as jengine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import teacher_student as jts
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train import teacher_student as ts
from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_states, to_port

N, T, HIDDEN = 8, 4, 32
# Rollouts in a row at each board size (enough slots for games to end),
# and random-opening plies (6x6 only: JAX's recorded 8x8 scan compiles
# in ~37 s with them, ~24 s without).
ROLLOUTS = {8: 9, 6: 5}
INIT = {8: 0, 6: 4}
FIELDS = ("obs", "action", "logp", "value", "reward", "done", "legal")
EXACT = ("obs", "action", "reward", "done", "legal")
DATA = os.path.join(os.path.dirname(__file__), "..", "data", "ts")


@functools.cache
def _ranked(seed, b):
    """Flax params of a small ``PolicyNet`` whose logits are 200 x a fixed
    cell ranking: every non-maximal legal weight exp(-200 k) underflows."""
    jnet = JaxPolicyNet(num_actions=b * b, hidden_size=HIDDEN, width_mult=1)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 4, b, b)))
    params = jax.tree.map(np.array, params)
    head = params["params"]["Dense_2"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = (200.0 * np.random.RandomState(seed).permutation(b * b)
                    ).astype(np.float32)
    return jnet, params


def _recording(b):
    """Patch JAX to record its random legal moves (as ranks) and each
    reset's opening counts and teacher colours, in program order; returns
    ``(moves, resets, undo)``."""
    moves, resets = [], []
    cls = jengine.BitEngine if b == 8 else jengine.PlaneEngine
    real_move, real_reset = cls.random_legal, jts.reset_done

    def random_legal(self, keys, state):
        a = real_move(self, keys, state)
        io_callback(lambda lg, a: moves.append(torch.from_numpy(np.array(
            [lg[i, :a[i]].sum() for i in range(len(a))]))), None,
            self.legal_flat(state), a, ordered=True)
        return a

    def reset_done(*args, **kwargs):
        out = real_reset(*args, **kwargs)
        io_callback(lambda rl, tc: resets.append(
            (np.array(rl), np.array(tc))), None, out[1], out[2],
            ordered=True)
        return out

    def undo():
        cls.random_legal, jts.reset_done = real_move, real_reset
    cls.random_legal, jts.reset_done = random_legal, reset_done
    return moves, resets, undo


@functools.cache
def _jax_rollouts(b):
    """JAX's ``ts_init`` and ``ROLLOUTS[b]`` collections with its draws
    recorded: ``(rollouts, moves, resets, init draws, final state)``."""
    jcfg = JaxEnvConfig(board_size=b, num_disk_as_reward=True)
    (jnet, pt), (_, ps) = _ranked(1, b), _ranked(2, b)
    moves, resets, undo = _recording(b)
    try:
        key = jax.random.PRNGKey(b)
        jstate = jts.ts_init(key, jcfg, N, INIT[b])
        collect = jax.jit(functools.partial(
            jts.collect_ts_rollout, apply_fn=jtrainer.make_apply_fn(jnet),
            cfg=jcfg, num_steps=T, init_rand_steps=INIT[b]))
        want = []
        for r in range(ROLLOUTS[b]):
            jstate, jt, js = collect(pt, ps, ts=jstate,
                                     teacher_reward=jnp.float32(0.25),
                                     key=jax.random.PRNGKey(100 + r))
            want.append((jt, js))
        jax.effects_barrier()
    finally:
        undo()
    return want, moves, resets, _init_draws(key, INIT[b]), jstate


def _draws(b):
    """The recorded draws of ``_jax_rollouts(b)`` for the port."""
    _, moves, resets, (rl0, c0), _ = _jax_rollouts(b)
    return sp.InjectedDraws(
        colors=[torch.from_numpy(c0)] + [torch.from_numpy(c)
                                         for _, c in resets],
        uniforms=itertools.repeat(torch.full((N,), 0.5)),
        rand_left=[torch.from_numpy(rl0)] + [torch.from_numpy(rl)
                                             for rl, _ in resets],
        legal_index=list(moves))


def _init_draws(key, init):
    """``ts_init``'s own draws, as JAX makes them from its key."""
    _, _, k_color, k_rand = jax.random.split(key, 4)
    rand_left = jax.vmap(draw_max_rand_steps, in_axes=(0, None))(
        jax.random.split(k_rand, N), init)
    color = jax.random.randint(k_color, (N,), 0, 2) * 2 - 1
    return np.array(rand_left), np.array(color)


def _stacked(parts, f):
    return np.concatenate([np.asarray(getattr(p, f)) for p in parts])


@pytest.mark.parametrize("b", [8])
def test_rollout_equals_jax(b):
    """8x8 (the bitboard engine); 6x6 planes with random openings are in
    test_torch_ts_trainer.py, whose trainer chunk shares their JAX
    recording."""
    check_rollout(b)


def check_rollout(b):
    """The port's ``ROLLOUTS[b]`` collections against JAX's recording at
    board ``b``."""
    cfg = EnvConfig(board_size=b, num_disk_as_reward=True)
    want, _, _, _, jstate = _jax_rollouts(b)
    draws = _draws(b)
    net_t = policy_net_from_flax(_ranked(1, b)[1], device="cpu")
    net_s = policy_net_from_flax(_ranked(2, b)[1], device="cpu")
    state = ts.ts_init(cfg, N, INIT[b], draws, device="cpu")
    got = []
    for _ in range(ROLLOUTS[b]):
        state, pt_, ps_ = ts.collect_ts_rollout(net_t, net_s, state, cfg, T,
                                                INIT[b], 0.25, draws)
        got.append((pt_, ps_))
    for role in (0, 1):
        rows = 2 * T if role == 0 else 4 * T
        assert got[0][role][0].reward.shape == (rows, N)
        for f in FIELDS:
            g = _stacked([r[role][0] for r in got], f)
            w = _stacked([r[role][0] for r in want], f)
            if f in EXACT:
                np.testing.assert_array_equal(g, w, err_msg=f"{role} {f}")
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=f"{role} {f}")
        for i, tol in ((1, 0), (2, 1e-6)):
            np.testing.assert_allclose(
                np.concatenate([r[role][i].numpy() for r in got]),
                np.concatenate([np.asarray(r[role][i]) for r in want]),
                rtol=0, atol=tol, err_msg=f"{role} {i}")
    w_t = np.concatenate([r[0][1].numpy() for r in got])
    w_s = np.concatenate([r[1][1].numpy() for r in got])
    done_s = _stacked([r[1][0] for r in got], "done")
    rew_t = _stacked([r[0][0] for r in got], "reward")
    assert (w_t == 0).any() and (w_t == 1).any() and (w_s == 0).any()
    assert (done_s & (w_s > 0)).sum() >= 2       # games ended and reset
    assert (rew_t[w_t > 0] == np.float32(0.25)).any()
    np.testing.assert_array_equal(state.tcolor.numpy(),
                                  np.asarray(jstate.tcolor))
    with pytest.raises(StopIteration):       # every recorded draw was used
        draws.legal_index(torch.zeros(N, dtype=torch.int64))


@pytest.mark.parametrize("name", ["ts_wide2_1500.student",
                                  "ts_wide2_1500.teacher",
                                  "ts_tuned_1000.student"])
def test_committed_checkpoints_forward(name):
    step, params, _, _ = load_checkpoint(os.path.join(DATA, name))
    assert step in (1000, 1500)
    net = policy_net_from_flax(params, device="cpu")
    obs = make_state(to_port(random_states(16, 4)))
    jnet = JaxPolicyNet(num_actions=64, hidden_size=net.hidden_size,
                        width_mult=net.trunk.conv0.out_channels // 32)
    logits, value, _ = jnet.apply(params, jnp.asarray(obs.numpy()))
    got_l, got_v = net(obs)
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(value),
                               rtol=1e-5, atol=1e-5)
