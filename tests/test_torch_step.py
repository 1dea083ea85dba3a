"""The ply kernel's wrappers (``ops/step.py``): on the CPU their plain
versions against the JAX ``bit_step``, ``BitEngine.step_where``/
``reset_where`` and ``bitvec_step``'s auto-reset select, exact (integer
logic and float32 rewards that are small integers), on reachable states
with terminated games and legal, empty-illegal, occupied, -1 and 64
actions; the wrappers' refusals; no launch counted on the CPU; the C
entry points against ``_build._SIGNATURES``; and, on a card only, the
kernel against its plain version."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as bb
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.engine import BitEngine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import _build
from gymothelloenv_tpu_torch.ops import step
from torch_port_helpers import (assert_same_state,  # noqa: F401
                                legal_lists, one_torch_thread,
                                random_states, to_port)

N = 96
FLAGS = [(True, False), (True, True), (False, False), (False, True)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def inputs():
    """JAX states (an eighth of them forced terminated, legal mask 0), the
    actions (legal, empty but illegal, occupied, -1, 64), ``do`` and
    ``done``."""
    rng = np.random.RandomState(40)
    states = random_states(N, seed=41, max_plies=64)
    term = np.asarray(states.terminated) | (rng.rand(N) < 0.125)
    zero = jnp.zeros_like(states.legal[0])
    states = states.replace(
        terminated=jnp.asarray(term),
        legal=tuple(jnp.where(jnp.asarray(term), zero, w)
                    for w in states.legal))
    legal = legal_lists(states.legal)
    black = np.asarray(bb.unpack2(states.black)).reshape(N, 64)
    white = np.asarray(bb.unpack2(states.white)).reshape(N, 64)
    occupied = black | white
    actions = []
    for i in range(N):
        kind = rng.randint(8)
        empty_illegal = np.nonzero(~occupied[i] & ~legal[i])[0]
        if kind < 4 and legal[i].any():
            actions.append(rng.choice(np.nonzero(legal[i])[0]))
        elif kind == 4 and len(empty_illegal):
            actions.append(rng.choice(empty_illegal))
        elif kind == 5:
            actions.append(rng.choice(np.nonzero(occupied[i])[0]))
        else:
            actions.append(-1 if kind == 6 else 64)
    return (states, np.asarray(actions, np.int32), rng.rand(N) < 0.7,
            rng.rand(N) < 0.5)


def _assert_same_result(got, want_state, want_reward, want_done):
    assert_same_state(got.state, want_state)
    np.testing.assert_array_equal(got.reward.numpy(),
                                  np.asarray(want_reward))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want_done))


@pytest.mark.parametrize("sudden,disk", FLAGS)
@pytest.mark.parametrize("mode", ["plain", "where", "autoreset"])
def test_step_modes_match_jax(mode, sudden, disk, inputs):
    states, actions, do, _ = inputs
    jcfg = JaxEnvConfig(sudden_death_on_invalid_move=sudden,
                        num_disk_as_reward=disk)
    # Eager JAX: its per-op compiles are shared by the twelve cases, where
    # a jit would compile once per flag pair.
    ref = bb.bit_step(states, jnp.asarray(actions), sudden, disk)
    action = torch.from_numpy(actions.astype(np.int64))
    if mode == "plain":
        got = step.bit_step(to_port(states), action, sudden, disk)
        _assert_same_result(got, ref.state, ref.reward, ref.done)
    elif mode == "where":
        got = step.bit_step(to_port(states), action, sudden, disk,
                            do=torch.from_numpy(do))
        want = JaxBitEngine().step_where(states, jnp.asarray(actions),
                                         jnp.asarray(do), jcfg)
        _assert_same_result(got, want, np.where(do, ref.reward, 0.0),
                            do & np.asarray(ref.done))
        cfg = EnvConfig(sudden_death_on_invalid_move=sudden,
                        num_disk_as_reward=disk)
        assert_same_state(BitEngine().step_where(
            to_port(states), action, torch.from_numpy(do), cfg), want)
    else:
        # bitvec_step's select (envs/bit_vector_env.py): finished games
        # become bit_reset's opening.  test_torch_env.py holds the whole
        # port env against JAX's bitvec_step over full games.
        done = jnp.asarray(ref.done)
        want = jax.tree.map(lambda f, x: jnp.where(done, f, x),
                            bb.bit_reset((N,)), ref.state)
        got = step.bit_step(to_port(states), action, sudden, disk,
                            autoreset=True)
        _assert_same_result(got, want, ref.reward, ref.done)


def test_reset_where_matches_jax(inputs):
    states, _, _, done = inputs
    want = JaxBitEngine().reset_where(states, jnp.asarray(done),
                                      JaxEnvConfig())
    assert_same_state(step.reset_where(to_port(states),
                                       torch.from_numpy(done)), want)


def _bad_call(bad):
    s = tb.opening(8, "cpu")
    a = torch.zeros(8, dtype=torch.int64)
    if bad == "turn_dtype":
        s.turn = s.turn.to(torch.int32)
    elif bad == "action_dtype":
        a = a.to(torch.int32)
    elif bad == "action_shape":
        a = torch.zeros(9, dtype=torch.int64)
    elif bad == "state_shape":
        s.legal = s.legal[:4]
    elif bad == "device_mix":
        a = torch.zeros(8, dtype=torch.int64, device="meta")
    elif bad == "mode":
        return lambda: step.bit_step(s, a, do=torch.ones(8, dtype=torch.bool),
                                     autoreset=True)
    elif bad == "reset_done_dtype":
        return lambda: step.reset_where(s, torch.ones(8, dtype=torch.int8))
    elif bad == "reset_device_mix":
        return lambda: step.reset_where(
            s, torch.ones(8, dtype=torch.bool, device="meta"))
    return lambda: step.bit_step(s, a)


@pytest.mark.parametrize("bad,err", [
    ("turn_dtype", TypeError), ("action_dtype", TypeError),
    ("action_shape", ValueError), ("state_shape", ValueError),
    ("device_mix", ValueError), ("mode", ValueError),
    ("reset_done_dtype", TypeError), ("reset_device_mix", ValueError)])
def test_wrappers_refuse_bad_input(bad, err):
    with pytest.raises(err):
        _bad_call(bad)()


def test_wrappers_count_no_cpu_launch():
    before = (step.bit_step.launches, step.reset_where.launches)
    s = tb.opening(4, "cpu")
    a = torch.full((4,), 19, dtype=torch.int64)
    step.bit_step(s, a)
    step.bit_step(s, a, do=torch.ones(4, dtype=torch.bool))
    step.bit_step(s, a, autoreset=True)
    step.reset_where(s, torch.ones(4, dtype=torch.bool))
    assert (step.bit_step.launches, step.reset_where.launches) == before


def test_entry_points_are_bound_and_defined():
    """Every ``extern "C"`` function of ``csrc/*.cu`` is in
    ``_SIGNATURES`` with as many arguments, and the ply kernel's two are
    among them."""
    defined = {}
    for path in _build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       path.read_text()):
            defined[name] = len(params.split(","))
    assert {"otb_bit_step", "otb_reset_where"} <= set(defined)
    assert defined == {k: len(v) for k, v in _build._SIGNATURES.items()}
    assert len(re.findall(r'extern "C"',
                          (_build.CSRC / "step.cu").read_text())) == 2


def test_ply_kernel_matches_plain_on_card(inputs):
    _need_card()
    states, actions, do, done = inputs
    dev = torch.device("cuda")
    cpu = to_port(states)
    card = tb.BitState(**{k: v.to(dev) for k, v in vars(cpu).items()})
    action = torch.from_numpy(actions.astype(np.int64))
    for sudden, disk in FLAGS:
        for kw in ({}, {"do": torch.from_numpy(do)}, {"autoreset": True}):
            before = step.bit_step.launches
            got = step.bit_step(card, action.to(dev), sudden, disk,
                                **{k: (v.to(dev) if torch.is_tensor(v)
                                       else v) for k, v in kw.items()})
            assert step.bit_step.launches == before + 1
            want = tb.bit_step_plain(cpu, action, sudden, disk, **kw)
            for f in ("black", "white", "legal", "turn", "terminated",
                      "winner"):
                assert torch.equal(getattr(got.state, f).cpu(),
                                   getattr(want.state, f)), f
            assert torch.equal(got.reward.cpu(), want.reward)
            assert torch.equal(got.done.cpu(), want.done)
    got = step.reset_where(card, torch.from_numpy(done).to(dev))
    want = tb.reset_where_plain(cpu, torch.from_numpy(done))
    for f in ("black", "white", "legal", "turn", "terminated", "winner"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
