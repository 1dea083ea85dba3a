"""The port's checkpoint IO against flax and the JAX trainer.

The pure-Python msgpack reader gives ``flax.serialization.msgpack_restore``'s
leaves (shape, dtype and bits) for the committed checkpoints, and the
writer gives ``msgpack_serialize``'s bytes on generated payloads.  A JAX
trainer's checkpoint loaded and saved again by the port is byte-identical;
a port checkpoint loads in the JAX trainer with params and optax state
bit-equal after the layout mapping; from a loaded state one optax step and
one port ``Optimizer.step`` on the same gradients agree to 1e-6 at the same
learning rate; ``train``'s evaluation and save cadence (``{step}`` file
names, ``save_interval``, ``chain_updates``) is the JAX trainer's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.train.ppo_trainer import \
    PPOSelfPlayTrainer as JaxTrainer
from gymothelloenv_tpu.train.ppo_trainer import \
    SelfPlayConfig as JaxSelfPlayConfig
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.utils import checkpoint as ck
from torch_port_helpers import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay")
SMALL = dict(num_envs=16, num_steps=8, hidden_size=32,
             test_interval=10 ** 9)
LR, UPDATES = 3e-4, 10       # the schedule is still well above 0 after 2


def _jax_trainer(**run):
    return JaxTrainer(ppo_cfg=jppo.PPOConfig(lr=LR, num_updates=UPDATES),
                      run_cfg=JaxSelfPlayConfig(**{**SMALL, **run}),
                      log_fn=lambda *a: None)


def _port_trainer(**run):
    return PPOSelfPlayTrainer(ppo_cfg=PPOConfig(lr=LR, num_updates=UPDATES),
                              run_cfg=SelfPlayConfig(**{**SMALL, **run}),
                              log_fn=lambda *a: None, device="cpu")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX trainer (hidden 32, N 16, T 8) after 2 updates, saved."""
    trainer = _jax_trainer()
    trainer.train(2, log_every=1)
    path = str(tmp_path_factory.mktemp("jax") / "jax.msgpack")
    trainer.save(path)
    return trainer, path


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same_tree(got, want):
    got_l, want_l = _leaves(got), _leaves(want)
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    for (key, a), (_, b) in zip(got_l, want_l):
        assert type(a) is type(b), key
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("name", ["ppo_wide2_4k.msgpack",
                                  "ppo_tuned_8k.msgpack"])
def test_reader_matches_flax_on_committed_checkpoints(name):
    path = os.path.join(DATA, name)
    if not os.path.isfile(path):
        pytest.skip(f"checkpoint not in this checkout: {path}")
    with open(path, "rb") as f:
        raw = f.read()
    got, want = ck.unpackb(raw), serialization.msgpack_restore(raw)
    _assert_same_tree(got, want)
    assert type(got["step"]) is int and got["step"] == want["step"]
    assert got["extra"] == {} and got["opt_state"]["0"] == {}
    assert ck.packb(got) == raw


_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
          2 ** 63 - 1, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
          -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.float32]


def _array(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, info.max, shape, dtype=dtype)


_leaf = st.one_of(
    st.sampled_from(_EDGES), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(), st.booleans(), st.none(),
    st.builds(lambda n, c: c * n,
              st.sampled_from([0, 1, 15, 31, 32, 33, 255, 256, 65535,
                               65536]),
              st.sampled_from(["a", "é"])),
    st.builds(_array, st.sampled_from(_DTYPES),
              st.lists(st.integers(0, 5), max_size=3).map(tuple),
              st.integers(0, 2 ** 31)),
    st.builds(lambda d, v: d(v), st.sampled_from([np.float32, np.int32]),
              st.integers(-100, 100)))
_tree = st.recursive(_leaf, lambda kids: st.dictionaries(
    st.text(max_size=6), kids, max_size=17), max_leaves=30)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(st.dictionaries(st.text(max_size=6), _tree, max_size=4))
def test_writer_bytes_and_reader_match_flax(payload):
    want = serialization.msgpack_serialize(payload)
    assert ck.packb(payload) == want
    _assert_same_tree(ck.unpackb(want),
                      serialization.msgpack_restore(want))


@pytest.mark.parametrize("payload,match", [
    ({"a": {"__msgpack_chunked_array__": True, "shape": {}}}, "chunked"),
    ({"a": complex(1, 2)}, "ext type 2"),
])
def test_reader_refuses_what_flax_writes_only_past_the_subset(payload,
                                                                match):
    with pytest.raises(ValueError, match=match):
        ck.unpackb(serialization.msgpack_serialize(payload))


def test_save_checkpoint_writes_through_tmp_and_loads(tmp_path):
    path = str(tmp_path / "sub" / "c.msgpack")
    params = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    ck.save_checkpoint(path, 7, params, extra={"note": "x"})
    assert os.listdir(tmp_path / "sub") == ["c.msgpack"]
    step, got, opt, extra = ck.load_checkpoint(path)
    assert (step, opt, extra) == (7, None, {"note": "x"})
    np.testing.assert_array_equal(got["params"]["w"], params["params"]["w"])
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(
            {"step": 7, "params": params, "opt_state": None,
             "extra": {"note": "x"}})


def _port_opt_tree(trainer):
    return trainer.optimizer.to_optax_state(
        lambda ts: flax_tree(trainer.net, ts))


def test_jax_checkpoint_loads_and_saves_byte_identical(jax_ckpt, tmp_path):
    jt, path = jax_ckpt
    port = _port_trainer()
    port.load(path)
    assert port.update_count == jt.update_count == 2
    _assert_same_tree(flax_tree(port.net), jax.tree.map(np.asarray,
                                                        jt.params))
    _assert_same_tree(_port_opt_tree(port), serialization.to_state_dict(
        jax.tree.map(np.asarray, jt.opt_state)))
    again = str(tmp_path / "again.msgpack")
    port.save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_port_checkpoint_loads_in_the_jax_trainer(tmp_path):
    port = _port_trainer(seed=3)
    port.train(1, log_every=1)
    path = str(tmp_path / "port.msgpack")
    port.save(path)
    jt = _jax_trainer()
    jt.load(path)
    assert jt.update_count == 1
    _assert_same_tree(jax.tree.map(np.asarray, jt.params),
                      flax_tree(port.net))
    _assert_same_tree(serialization.to_state_dict(
        jax.tree.map(np.asarray, jt.opt_state)), _port_opt_tree(port))
    counts = jt.opt_state[1]
    assert int(counts[0].count) == int(counts[1].count) == 16


def test_one_step_after_load_agrees_with_optax(jax_ckpt):
    """Gradients from a numpy seed, in flax layout for optax and in the
    port's layout for the port.  Tolerance: 1e-6 absolute on the params
    (one Adam step of lr 3e-4 moves each by at most ~3e-4)."""
    jt, path = jax_ckpt
    port = _port_trainer()
    port.load(path)
    rng = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        jt.params)
    count = int(jt.opt_state[1][1].count)
    total = UPDATES * 4 * 4
    schedule = optax.linear_schedule(LR, 0.0, total)
    assert port.optimizer.adam.param_groups[0]["lr"] == pytest.approx(
        float(schedule(count)), rel=1e-6)
    opt = jppo.make_optimizer(jppo.PPOConfig(lr=LR, num_updates=UPDATES))
    updates, _ = jax.jit(opt.update)(grads, jt.opt_state, jt.params)
    want = jax.jit(optax.apply_updates)(jt.params, updates)
    for p, g in zip(port.net.parameters(),
                    tensors_from_flax(port.net,
                                      jax.tree.map(np.asarray, grads))):
        p.grad = g
    port.optimizer.step()
    got = flax_tree(port.net)
    for (key, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0,
                                   err_msg=str(key))
    moved = max(float(np.abs(np.asarray(b) - np.asarray(c)).max())
                for b, c in zip(jax.tree.leaves(want),
                                jax.tree.leaves(jt.params)))
    assert moved > 1e-5
    assert port.optimizer.adam.param_groups[0]["lr"] == pytest.approx(
        float(schedule(count + 1)), rel=1e-6)


def test_load_params_only_resets_the_optimizer(jax_ckpt):
    jt, path = jax_ckpt
    port = _port_trainer(seed=5)
    port.train(1, log_every=1)
    port.load_params_only(path)
    assert port.update_count == 0
    _assert_same_tree(flax_tree(port.net), jax.tree.map(np.asarray,
                                                        jt.params))
    fresh = _port_opt_tree(port)
    assert int(fresh["1"]["0"]["count"]) == 0
    assert int(fresh["1"]["1"]["count"]) == 0
    assert all(not np.asarray(x).any()
               for x in jax.tree.leaves(fresh["1"]["0"]["mu"]))
    assert port.optimizer.adam.param_groups[0]["lr"] == LR


@pytest.mark.parametrize("run", [
    dict(flatten=True), dict(recurrent=True), dict(constant_lr=True),
], ids=["flat", "recurrent", "schedule"])
def test_load_refuses_another_optimizer_layout(jax_ckpt, tmp_path, run):
    jt, path = jax_ckpt
    step, params, opt_state, _ = ck.load_checkpoint(path)
    port = _port_trainer()
    if "flatten" in run:
        adam = opt_state["1"]["0"]
        adam["mu"] = np.concatenate([np.ravel(x) for x in
                                     jax.tree.leaves(adam["mu"])])
    elif "recurrent" in run:
        opt_state["1"]["0"]["mu"]["params"]["GRUCore_0"] = {
            "bias": np.zeros(3, np.float32)}
    else:
        port.optimizer.schedule = None
    bad = str(tmp_path / "bad.msgpack")
    ck.save_checkpoint(bad, step, params, opt_state)
    before = [p.detach().clone() for p in port.net.parameters()]
    with pytest.raises(ValueError, match="optimizer state is not"):
        port.load(bad)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 port.net.parameters()))
    assert port.update_count == 0


class _Recorder:
    """The events of a ``train`` call: logged steps and keys, saves."""

    def __init__(self):
        self.events = []

    def log(self, step, metrics):
        kind = "eval" if any(k.startswith("win%") for k in metrics) else \
            "metrics"
        self.events.append((kind, step))

    def save(self, path):
        self.events.append(("save", path))


@pytest.mark.parametrize("updates,log_every,save,test,chain", [
    (7, 2, 2, 3, 1), (12, 1, 5, 4, 1), (10, 2, 4, 3, 3), (9, 1, 2, 5, 4),
])
def test_train_cadence_matches_jax(updates, log_every, save, test, chain):
    """``{step}`` file names, the save and test intervals, and with
    ``chain_updates`` > 1 the rounded-up total and the quantised cadence,
    against the JAX trainer's ``train`` with its steps stubbed out."""
    run = dict(save_interval=save, test_interval=test, chain_updates=chain)
    jrec, prec = _Recorder(), _Recorder()
    jt = _jax_trainer(**run)
    jt.log_fn, jt.save = jrec.log, jrec.save
    jt.ensure_initialized = lambda: None
    jt._do_update = lambda key: {}
    jt._eval_step = lambda params, key: {"rand": 0.0}
    jt.train(updates, log_every=log_every, checkpoint_path="ck_{step}.mp")
    port = _port_trainer(**run)
    port.log_fn, port.save = prec.log, prec.save
    port.ensure_initialized = lambda: None
    port._do_update = lambda: {}
    port.evaluate = lambda: {"rand": 0.0}
    port.train(updates, log_every=log_every, checkpoint_path="ck_{step}.mp")
    assert prec.events == jrec.events
    assert port.update_count == jt.update_count >= updates
    assert port.update_count % chain == 0
