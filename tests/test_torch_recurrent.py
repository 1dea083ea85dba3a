"""The port's recurrent and bfloat16 nets against ``gymothelloenv_tpu``.

From the same flax params (converted by ``models.convert``): the GRU cell
(flax 0.12's ``nn.GRUCell``, no ``b_hr``/``b_hz``), the recurrent
``PolicyNet`` with the mask zeroing its hidden state, its
``features``/``core``/``heads`` split against its whole forward, and the
frame-stack cell against JAX's ``make_apply_fn_framestack``, all to 1e-5;
the committed recurrent checkpoints through both ``load_eval_policy``s
(ROADMAP's gate); recurrent checkpoints byte-identical with the JAX
trainer's both ways and one optimizer step after a load against optax to
1e-6; and the bfloat16 forward against JAX's bfloat16, to a tolerance
from bfloat16's 8-bit mantissa."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    policy_net_from_flax,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.nets import FrameStackCell, GRUCell
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig,
                                                       load_eval_policy)
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_states

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay")
ATOL = RTOL = 1e-5        # float32 sums in other orders
SMALL = dict(num_envs=16, num_steps=8, hidden_size=32, recurrent=True,
             test_interval=10 ** 9)
LR, UPDATES = 3e-4, 10


def _obs(n, seed=30):
    """Featurized reachable positions, then noise off the 0/1 lattice."""
    planes = np.asarray(JaxBitEngine().featurize(random_states(n, seed)))
    noise = np.random.RandomState(seed).rand(8, 4, 8, 8).astype(np.float32)
    return np.concatenate([planes, noise])


def _hidden(n, size, seed=1):
    rng = np.random.RandomState(seed)
    h = rng.uniform(-1, 1, (n, size)).astype(np.float32)
    mask = (rng.rand(n) < 0.7).astype(np.float32)
    return h, mask


def _jax_recurrent(hidden, width, seed=0, dtype=jnp.float32):
    jnet = JaxPolicyNet(num_actions=64, hidden_size=hidden, recurrent=True,
                        width_mult=width, dtype=dtype)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)),
                       jnp.zeros((1, hidden)), jnp.ones((1,)))
    params = jax.tree.map(np.array, params)
    # Lift the 0.01-gain logits head so the logits are O(1), not ~0.
    params["params"]["Dense_2"]["kernel"] *= 100.0
    return jnet, params


def test_gru_cell_matches_flax():
    cell = fnn.GRUCell(features=24)
    rng = np.random.RandomState(0)
    x = rng.randn(40, 16).astype(np.float32)
    h = rng.uniform(-1, 1, (40, 24)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(3), jnp.asarray(h), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)["params"]
    for name in ("ir", "iz", "in", "hn"):      # non-zero biases
        params[name]["bias"] = rng.randn(24).astype(np.float32)
    want, _ = cell.apply({"params": params}, jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(16, 24)
    assert {n for n, _ in port.named_parameters()} == {
        "ir.weight", "ir.bias", "iz.weight", "iz.bias", "in_.weight",
        "in_.bias", "hr.weight", "hz.weight", "hn.weight", "hn.bias"}
    assert sorted(params) == ["hn", "hr", "hz", "in", "ir", "iz"]
    assert "bias" not in params["hr"] and "bias" not in params["hz"]
    with torch.no_grad():
        for name, leaves in params.items():
            layer = getattr(port, "in_" if name == "in" else name)
            layer.weight.copy_(torch.from_numpy(leaves["kernel"].T.copy()))
            if "bias" in leaves:
                layer.bias.copy_(torch.from_numpy(leaves["bias"]))
        got = port(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("hidden,width", [(16, 1), (32, 2)])
def test_recurrent_policy_net_matches_flax(hidden, width):
    """Logits, value and h' to 1e-5 with 30% of the rows masked (their
    hidden state zeroed before the step); the split forward equals the
    whole one exactly; the tree converts back leaf for leaf."""
    jnet, params = _jax_recurrent(hidden, width)
    x = _obs(40)
    h, mask = _hidden(len(x), hidden)
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(h),
                      jnp.asarray(mask))
    net = policy_net_from_flax(params, device="cpu")
    assert net.recurrent and net.hidden_size == hidden
    xt, ht, mt = map(torch.from_numpy, (x, h, mask))
    with torch.no_grad():
        got = net(xt, ht, mt)
        y, h_split = net.core(net.features(xt), ht, mt)
        split = (*net.heads(y), h_split)
        zeroed = net(xt, ht * 0, torch.ones_like(mt))
        masked_all = net(xt, ht, torch.zeros_like(mt))
    for name, a, b in zip(("logits", "value", "h"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    assert all(torch.equal(a, b) for a, b in zip(got, split))
    assert all(torch.equal(a, b) for a, b in zip(zeroed, masked_all))
    tree = flax_tree(net)
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(
                                    params)):
        assert ka == kb and np.array_equal(a, b), ka


def test_frame_stack_cell_matches_jax_apply_fn():
    """``FrameStackCell`` against JAX's ``make_apply_fn_framestack``:
    logits and value to 1e-5, the shifted window exactly."""
    cfg = JaxEnvConfig()
    jnet = JaxPolicyNet(num_actions=64, hidden_size=32)
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 12, 8, 8))))
    apply_fn = jtrainer.make_apply_fn_framestack(jnet, 3, cfg)
    x = _obs(24)
    h = (np.random.RandomState(4).rand(len(x), apply_fn.hidden_size)
         < 0.3).astype(np.float32)
    _, mask = _hidden(len(x), 1, seed=5)
    want = apply_fn(params, jnp.asarray(x), jnp.asarray(h),
                    jnp.asarray(mask))
    cell = FrameStackCell(policy_net_from_flax(params, device="cpu"), 3)
    assert cell.hidden_size == apply_fn.hidden_size == 2 * 256
    with torch.no_grad():
        got = cell(*map(torch.from_numpy, (x, h, mask)))
    for name, a, b in zip(("logits", "value"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("name", ["ppo_recurrent_2000.msgpack",
                                  "ppo_rec_wide2_2500.msgpack"])
def test_committed_recurrent_checkpoint_forward_matches_jax(name):
    """ROADMAP's gate: both loaders on the committed checkpoint give the
    same description, and two recurrent steps (the second from the
    first's h', with some rows reset) agree to 1e-5."""
    path = os.path.join(DATA, name)
    if not os.path.isfile(path):
        pytest.skip(f"checkpoint not in this checkout: {path}")
    params, apply_fn, jdesc = jtrainer.load_eval_policy(path,
                                                        JaxEnvConfig())
    net, desc = load_eval_policy(path, device="cpu")
    assert desc == jdesc and desc.endswith("recurrent")
    assert net.recurrent and net.hidden_size == apply_fn.hidden_size == 512
    x = _obs(32)
    h = np.zeros((len(x), 512), np.float32)
    _, mask = _hidden(len(x), 1, seed=7)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    for step, m in enumerate((np.ones_like(mask), mask)):
        want = apply_fn(params, jnp.asarray(x), jh, jnp.asarray(m))
        with torch.no_grad():
            got = net(torch.from_numpy(x), th, torch.from_numpy(m))
        for label, a, b in zip(("logits", "value", "h"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=RTOL,
                                       err_msg=f"{label} step {step}")
        jh, th = want[2], got[2]


def _jax_trainer(**run):
    return jtrainer.PPOSelfPlayTrainer(
        ppo_cfg=jppo.PPOConfig(lr=LR, num_updates=UPDATES),
        run_cfg=jtrainer.SelfPlayConfig(**{**SMALL, **run}),
        log_fn=lambda *a: None)


def _port_trainer(**run):
    return PPOSelfPlayTrainer(ppo_cfg=PPOConfig(lr=LR, num_updates=UPDATES),
                              run_cfg=SelfPlayConfig(**{**SMALL, **run}),
                              log_fn=lambda *a: None, device="cpu")


def _random_grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        params)


@pytest.fixture(scope="module")
def jax_recurrent_ckpt(tmp_path_factory):
    """A recurrent JAX trainer (hidden 32) whose params and optax state
    took two optimizer steps on seeded gradients, saved at update 2."""
    jt = _jax_trainer()
    opt = jt.optimizer
    for seed in (0, 1):
        updates, jt.opt_state = opt.update(_random_grads(jt.params, seed),
                                           jt.opt_state, jt.params)
        jt.params = optax.apply_updates(jt.params, updates)
    jt.update_count = 2
    path = str(tmp_path_factory.mktemp("jaxrec") / "rec.msgpack")
    jt.save(path)
    return jt, path


def test_recurrent_checkpoints_byte_identical_both_ways(jax_recurrent_ckpt,
                                                        tmp_path):
    """The JAX trainer's recurrent file loaded and saved again by the port
    is the same bytes; a port trainer's file after one update loads in the
    JAX trainer and saves again as the same bytes."""
    jt, path = jax_recurrent_ckpt
    port = _port_trainer()
    port.load(path)
    assert port.update_count == 2
    again = str(tmp_path / "again.msgpack")
    port.save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    port = _port_trainer(seed=3)
    port.train(1, log_every=1)
    mine = str(tmp_path / "port.msgpack")
    port.save(mine)
    back = _jax_trainer()
    back.load(mine)
    assert back.update_count == 1
    theirs = str(tmp_path / "jax_again.msgpack")
    back.save(theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_recurrent_one_step_after_load_agrees_with_optax(jax_recurrent_ckpt):
    """Seeded gradients through optax and through the port's optimizer
    from the loaded state: params to 1e-6 (one Adam step of lr 3e-4)."""
    jt, path = jax_recurrent_ckpt
    port = _port_trainer()
    port.load(path)
    grads = _random_grads(jt.params, 9)
    updates, _ = jt.optimizer.update(grads, jt.opt_state, jt.params)
    want = jax.tree.map(np.asarray, optax.apply_updates(jt.params, updates))
    for p, g in zip(port.net.parameters(), tensors_from_flax(
            port.net, jax.tree.map(np.asarray, grads))):
        p.grad = g
    port.optimizer.step()
    got = flax_tree(port.net)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    assert any("GRUCore_0" in str(k) for k, _ in got_l)
    for (key, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=str(key))
    state = port.optimizer.to_optax_state(
        lambda ts: flax_tree(port.net, ts))
    assert int(state["1"]["0"]["count"]) == 3


# bfloat16 keeps 8 significant bits: one rounding is within 2^-9 of the
# value.  Both frameworks round every layer's output to bfloat16 but sum in
# other orders, so a layer may round one step (2^-8) apart and the step
# carries into the later layers: the outputs are held to 2^-7 (two steps)
# of their largest magnitude (measured: at most 0.7 of a step).
BF16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("recurrent", [False, True])
def test_bf16_forward_matches_jax_bf16(recurrent):
    """The port's bfloat16 net against flax's ``PolicyNet(dtype=bfloat16)``
    from the same float32 params: outputs float32 within ``BF16_RTOL`` of
    their largest magnitude and closer to JAX's than the float32 net's
    are; the recurrent state stays float32 (flax promotes the GRU) and
    agrees to 1e-5."""
    hidden, width = 32, 2
    x = _obs(48)
    if recurrent:
        jnet, params = _jax_recurrent(hidden, width, dtype=jnp.bfloat16)
        h, mask = _hidden(len(x), hidden)
        args = (jnp.asarray(h), jnp.asarray(mask))
        targs = (torch.from_numpy(h), torch.from_numpy(mask))
    else:
        jnet = JaxPolicyNet(num_actions=64, hidden_size=hidden,
                            width_mult=width, dtype=jnp.bfloat16)
        params = jax.tree.map(np.array, jnet.init(
            jax.random.PRNGKey(1), jnp.zeros((1, 4, 8, 8))))
        params["params"]["Dense_2"]["kernel"] *= 100.0
        args = targs = ()
    want = jnet.apply(params, jnp.asarray(x), *args)
    net = policy_net_from_flax(params, device="cpu", dtype=torch.bfloat16)
    f32 = policy_net_from_flax(params, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x), *targs)
        ref32 = f32(torch.from_numpy(x), *targs)
    for name, a, b, c in zip(("logits", "value"), got, want, ref32):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        scale = float(np.abs(b).max())
        err = float(np.abs(a.numpy() - b).max())
        assert err <= BF16_RTOL * scale, (name, err, scale)
        assert float(np.abs(c.numpy() - b).max()) > err, name
    if recurrent:
        assert got[2].dtype == torch.float32
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=ATOL, rtol=RTOL)
