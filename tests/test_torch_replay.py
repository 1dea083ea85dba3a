"""The port's replay (``agents/replay.py``) against JAX's: masked batch
inserts and gathers across the ring's wrap and through the scratch row,
uniform sampling from injected uniforms, the proportional (PER) sampler's
indices at capacity 3000 (three 1024-slot blocks, the last one partial)
on power-of-two priorities, and ``replay_update_priorities`` with its
running maximum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import replay as jreplay
from gymothelloenv_tpu_torch.agents import replay
from torch_port_helpers import one_torch_thread  # noqa: F401

B = 6
FIELDS = replay.FIELDS


def _batch(rng, k, p_valid=0.6):
    return (rng.randint(-1, 2, (k, B, B)).astype(np.int8),
            rng.choice([-1, 1], k).astype(np.int8),
            rng.randint(0, B * B, k).astype(np.int32),
            rng.randn(k).astype(np.float32),
            rng.randint(-1, 2, (k, B, B)).astype(np.int8),
            rng.choice([-1, 1], k).astype(np.int8),
            rng.rand(k) < 0.3, rng.rand(k) < p_valid)


def _filled(capacity, prioritized, inserts=5, k=40, seed=0):
    """JAX's and the port's replay after the same ``inserts`` inserts."""
    jcfg = jreplay.ReplayConfig(capacity=capacity, board_size=B,
                                prioritized=prioritized)
    cfg = replay.ReplayConfig(capacity=capacity, board_size=B,
                              prioritized=prioritized)
    jrb, rb = jreplay.replay_init(jcfg), replay.replay_init(cfg, "cpu")
    insert = jax.jit(jreplay.replay_insert, static_argnums=1)
    rng = np.random.RandomState(seed)
    for _ in range(inserts):
        args = _batch(rng, k)
        jrb = insert(jrb, jcfg, *map(jnp.asarray, args))
        rb = replay.replay_insert(rb, cfg, *map(torch.from_numpy, args))
    return (jrb, jcfg), (rb, cfg)


def test_insert_and_gather_equal_jax_across_the_wrap():
    """5 inserts of 40 rows (60% valid) into a ring of 64: it wraps; every
    row, ``write_pos`` and ``size`` equal JAX's, and the scratch row takes
    the invalid rows without reaching a sample."""
    (jrb, _), (rb, _) = _filled(64, False)
    assert int(rb.size) == int(jrb.size) == 64
    assert int(rb.write_pos) == int(jrb.write_pos) != 0
    idx = np.arange(64)
    want = jreplay.replay_gather(jrb, jnp.asarray(idx))
    got = replay.replay_gather(rb, torch.from_numpy(idx))
    for f, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(rb.priority.numpy()[:64],
                                  np.asarray(jrb.priority)[:64])


def test_uniform_sampling_from_injected_uniforms():
    """Uniform sampling: JAX's ``randint`` indices come back from the
    uniforms ``(idx + 0.5) / size``, and the port's own draws cover the
    filled rows only."""
    (jrb, jcfg), (rb, cfg) = _filled(512, False, inserts=3)
    size = int(rb.size)
    assert 0 < size < 512
    want = np.asarray(jreplay.replay_sample_idx(jrb, jcfg,
                                                jax.random.PRNGKey(1), 256))
    u = torch.from_numpy(((want + 0.5) / size).astype(np.float32))
    np.testing.assert_array_equal(replay.replay_sample_idx(rb, cfg, u)
                                  .numpy(), want)
    own = replay.replay_sample_idx(rb, cfg, torch.rand(
        4096, generator=torch.Generator().manual_seed(0)))
    assert int(own.min()) == 0 and int(own.max()) == size - 1


@pytest.mark.parametrize("size", [3000, 2100])
def test_per_indices_equal_jax_on_power_of_two_priorities(size):
    """Capacity 3000 (blocks of 1024, the last partial), priorities powers
    of two (exact prefix sums on both sides), JAX's uniforms injected:
    every index equal; with ``size`` < capacity the rows past it are
    never drawn."""
    cap, batch = 3000, 512
    rng = np.random.RandomState(size)
    prio = (2.0 ** rng.randint(-4, 5, cap + 1)).astype(np.float32)
    jcfg = jreplay.ReplayConfig(capacity=cap, board_size=B,
                                prioritized=True)
    cfg = replay.ReplayConfig(capacity=cap, board_size=B, prioritized=True)
    jrb = jreplay.replay_init(jcfg).replace(
        priority=jnp.asarray(prio), size=jnp.int32(size))
    rb = replay.replay_init(cfg, "cpu")
    rb.priority, rb.size = torch.from_numpy(prio), torch.tensor(size)
    key = jax.random.PRNGKey(size)
    want = np.asarray(jreplay.replay_sample_idx(jrb, jcfg, key, batch))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (batch,))))
    got = replay.replay_sample_idx(rb, cfg, u).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < size and len(np.unique(got // 1024)) >= 2


def test_update_priorities_and_max_priority_equal_jax():
    (jrb, jcfg), (rb, cfg) = _filled(256, True, inserts=4)
    rng = np.random.RandomState(3)
    idx = rng.randint(0, int(rb.size), 64).astype(np.int32)
    idx = np.unique(idx)
    err = (rng.randn(len(idx)) * 3).astype(np.float32)
    jrb = jreplay.replay_update_priorities(jrb, jcfg, jnp.asarray(idx),
                                           jnp.asarray(err))
    rb = replay.replay_update_priorities(rb, cfg, torch.from_numpy(idx)
                                         .long(), torch.from_numpy(err))
    np.testing.assert_allclose(rb.priority.numpy(), np.asarray(jrb.priority),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(rb.max_priority),
                               float(jrb.max_priority), rtol=1e-6)
    assert float(rb.max_priority) > 1.0
    # New rows enter at the running maximum, on both sides.
    args = _batch(np.random.RandomState(9), 8, p_valid=1.0)
    jrb = jreplay.replay_insert(jrb, jcfg, *map(jnp.asarray, args))
    rb = replay.replay_insert(rb, cfg, *map(torch.from_numpy, args))
    pos = (int(rb.write_pos) - 8) % 256
    np.testing.assert_allclose(rb.priority.numpy()[pos:pos + 8],
                               np.asarray(jrb.priority)[pos:pos + 8],
                               rtol=1e-6)
