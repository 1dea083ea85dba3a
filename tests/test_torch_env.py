"""Port env, featurizer and engine against the JAX bit vector env and
``BitEngine`` on the same positions and the same injected random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.envs import bit_vector_env as jenv
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.engine import (BitEngine, PlaneEngine,
                                                 get_engine)
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.envs import bit_vector_env as penv
from torch_port_helpers import (assert_same_state, legal_lists,
                                random_states, to_port)

JAX_ENGINE = JaxBitEngine()
ENGINE = BitEngine()


@pytest.fixture(scope="module")
def states():
    return random_states(80, seed=20, max_plies=64)


def _i64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("init_rand", [0, 6])
@pytest.mark.parametrize("sudden", [True, False])
def test_bitvec_matches_jax_with_injected_draws(init_rand, sudden):
    n, steps = 24, 90
    rng = np.random.RandomState(init_rand + sudden)
    jcfg = JaxEnvConfig(sudden_death_on_invalid_move=sudden,
                        num_disk_as_reward=not sudden)
    cfg = EnvConfig(sudden_death_on_invalid_move=sudden,
                    num_disk_as_reward=not sudden)
    key = jax.random.PRNGKey(init_rand)
    ref = jenv.bitvec_reset(key, n, init_rand)
    _, k_rand = jax.random.split(key)
    want_left = 2 * jax.random.randint(k_rand, (n,), 0, init_rand // 2 + 1,
                                       dtype=jnp.int32)
    port = penv.bitvec_reset(n, init_rand, rand_left=_i64(want_left),
                             device="cpu")
    np.testing.assert_array_equal(port.rand_left.numpy(),
                                  np.asarray(ref.rand_left))
    for step in range(steps):
        legal = legal_lists(ref.core.legal)
        actions = np.array([rng.randint(65) if rng.rand() < 0.05
                            else rng.choice(np.nonzero(r)[0])
                            for r in legal], np.int32)
        # The draws bitvec_step makes from its key, injected into the port.
        _, k_rand, k_reset = jax.random.split(ref.key, 3)
        count = jnp.asarray(legal.sum(-1), jnp.int32)
        t = jax.random.randint(k_rand, (n,), 0, jnp.maximum(count, 1),
                               dtype=jnp.int32)
        fresh = 2 * jax.random.randint(k_reset, (n,), 0, init_rand // 2 + 1,
                                       dtype=jnp.int32)
        res = jenv.bitvec_step(ref, jnp.asarray(actions), jcfg, init_rand)
        pres = penv.bitvec_step(port, torch.from_numpy(actions), cfg,
                                init_rand, rand_t=_i64(t),
                                reset_rand_left=_i64(fresh))
        assert_same_state(pres.state.core, res.state.core, f"step {step}")
        np.testing.assert_array_equal(pres.state.rand_left.numpy(),
                                      np.asarray(res.state.rand_left))
        np.testing.assert_array_equal(pres.reward.numpy(),
                                      np.asarray(res.reward))
        np.testing.assert_array_equal(pres.done.numpy(),
                                      np.asarray(res.done))
        ref, port = res.state, pres.state


def test_bitvec_draws_from_generator():
    g = torch.Generator().manual_seed(0)
    s = penv.bitvec_reset(64, 10, generator=g, device="cpu")
    left = s.rand_left.numpy()
    assert set(np.unique(left)) <= {0, 2, 4, 6, 8, 10} and left.max() > 0
    actions = torch.zeros(64, dtype=torch.int64)
    res = penv.bitvec_step(s, actions, EnvConfig(), 10, generator=g)
    forced = s.rand_left > 0
    # Forced-random games played a legal move (no sudden death).
    assert not bool(res.done[forced].any())


def test_featurize_matches_bit_engine(states):
    want = np.asarray(JAX_ENGINE.featurize(states))
    got = make_state(to_port(states))
    assert got.dtype == torch.float32 and got.shape == (80, 4, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # The single-legal-move quirk is exercised by these positions.
    single = legal_lists(states.legal).sum(-1) == 1
    assert single.any()
    assert float(got[torch.from_numpy(single), 3].abs().sum()) == 0.0


def test_engine_legal_flat_and_greedy(states):
    port = to_port(states)
    np.testing.assert_array_equal(ENGINE.legal_flat(port).numpy(),
                                  np.asarray(JAX_ENGINE.legal_flat(states)))
    live = ~np.asarray(states.terminated)
    want = np.asarray(JAX_ENGINE.greedy(states))
    got = ENGINE.greedy(port).numpy()
    np.testing.assert_array_equal(got[live], want[live])


@pytest.mark.parametrize("disk_reward", [False, True])
def test_engine_outcome_for(disk_reward, states):
    pcolor = np.where(np.arange(80) % 2 == 0, -1, 1).astype(np.int8)
    want = np.asarray(JAX_ENGINE.outcome_for(
        states, jnp.asarray(pcolor),
        JaxEnvConfig(num_disk_as_reward=disk_reward)))
    got = ENGINE.outcome_for(to_port(states), torch.from_numpy(pcolor),
                             EnvConfig(num_disk_as_reward=disk_reward))
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_step_where_and_reset_where(states):
    rng = np.random.RandomState(21)
    legal = legal_lists(states.legal)
    actions = np.array([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                        for r in legal], np.int32)
    do = rng.rand(80) < 0.7
    jcfg, cfg = JaxEnvConfig(), EnvConfig()
    want = JAX_ENGINE.step_where(states, jnp.asarray(actions),
                                 jnp.asarray(do), jcfg)
    got = ENGINE.step_where(to_port(states), torch.from_numpy(actions),
                            torch.from_numpy(do), cfg)
    assert_same_state(got, want)
    done = rng.rand(80) < 0.5
    assert_same_state(ENGINE.reset_where(got, torch.from_numpy(done)),
                      JAX_ENGINE.reset_where(want, jnp.asarray(done), jcfg))


def test_env_config_is_8x8_only():
    """The config's board was 8x8 only; other sizes now run on the plane
    engine (tests/test_torch_plane_state.py), and 8x8 stays the default
    on the bitboard engine."""
    assert EnvConfig().num_actions == 64
    assert EnvConfig(board_size=6).num_actions == 36
    assert isinstance(get_engine(EnvConfig()), BitEngine)
    assert isinstance(get_engine(EnvConfig(board_size=6)), PlaneEngine)
    tb.bit_reset(1, device="cpu")
