"""The port's n-step FIFO (``agents/nstep.py``) against JAX's
``nstep_push`` on seeded push sequences at n = 1, 2 and 3: masked pushes,
pops of full FIFOs and terminal flushes.  Every emitted field, the valid
mask and the FIFO after each push must be equal, the discounted sums
included (float32 rewards, JAX's multiply-add order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import nstep as jnstep
from gymothelloenv_tpu_torch.agents import nstep
from torch_port_helpers import one_torch_thread  # noqa: F401

STREAMS, B, PUSHES = 24, 4, 30
EMITTED = ("board", "turn", "action", "reward", "next_board", "next_turn",
           "done")
FIFO = EMITTED + ("count",)


@functools.cache
def _jax_push():
    return jax.jit(jnstep.nstep_push, static_argnums=1)


def _pushes(seed):
    rng = np.random.RandomState(seed)
    for _ in range(PUSHES):
        yield (rng.randint(-1, 2, (STREAMS, B, B)).astype(np.int8),
               rng.choice([-1, 1], STREAMS).astype(np.int8),
               rng.randint(0, B * B, STREAMS).astype(np.int32),
               rng.randn(STREAMS).astype(np.float32),
               rng.randint(-1, 2, (STREAMS, B, B)).astype(np.int8),
               rng.choice([-1, 1], STREAMS).astype(np.int8),
               rng.rand(STREAMS) < 0.2, rng.rand(STREAMS) < 0.7)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_nstep_push_equals_jax(n):
    jf, pf = jnstep.nstep_init(n, STREAMS, B), nstep.nstep_init(
        n, STREAMS, B)
    emitted = pops = flushes = 0
    for i, args in enumerate(_pushes(n)):
        jf, je = _jax_push()(jf, 0.99, *map(jnp.asarray, args))
        pf, pe = nstep.nstep_push(pf, 0.99, *map(torch.from_numpy, args))
        valid = np.asarray(je.valid)
        np.testing.assert_array_equal(pe.valid.numpy(), valid,
                                      err_msg=f"valid, push {i}")
        for f in EMITTED:
            np.testing.assert_array_equal(
                getattr(pe, f).numpy()[valid],
                np.asarray(getattr(je, f))[valid], err_msg=f"{f}, push {i}")
        for f in FIFO:
            np.testing.assert_array_equal(
                getattr(pf, f).numpy(), np.asarray(getattr(jf, f)),
                err_msg=f"fifo {f}, push {i}")
        emitted += int(valid.sum())
        do, done = args[-1], args[-2]
        flushes += int((do & done).sum())
        pops += int((valid[0] & ~(do & done)).sum())
    assert emitted > PUSHES and flushes > 10
    assert pops > 10 or n == 1
