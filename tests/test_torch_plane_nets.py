"""``PolicyNet`` at board sizes other than 8 against flax's: the forward at
B = 4 (flax's empty trunk output: the fc sees 0 features), 6, 7 (odd: the
fc width is ``ceil(B/2) - 2`` squared) and 10 of JAX's ``make_network``
after ``load_flax_params`` (atol 1e-5), recurrent and frame-stacked at
B = 6, the param tree back to
flax unchanged at B = 6 and 7 (the NHWC flatten), and one board-6
``ppo_update`` from the same params, rollout and epoch key words against
JAX's (deltas to atol 5e-7, the tolerance of tests/test_torch_ppo.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train.ppo_trainer import (make_apply_fn,
                                                 make_apply_fn_framestack,
                                                 make_apply_fn_recurrent,
                                                 make_network)
from gymothelloenv_tpu_torch.agents import ppo
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    policy_net_from_flax)
from gymothelloenv_tpu_torch.models.nets import FrameStackCell
from torch_port_helpers import one_torch_thread  # noqa: F401

HIDDEN = 32


def _flax(b, width=1, recurrent=False, channels=4, seed=0):
    jnet = make_network(JaxEnvConfig(board_size=b), recurrent=recurrent,
                        hidden_size=HIDDEN, width_mult=width)
    args = (jnp.zeros((1, channels, b, b)),)
    if recurrent:
        args += (jnp.zeros((1, HIDDEN)), jnp.ones((1,)))
    params = jnet.init(jax.random.PRNGKey(seed), *args)
    head = params["params"]["Dense_2"]
    head["kernel"] = head["kernel"] * 100.0   # O(1) logits, not ~0
    return jnet, params


def _obs(b, n=16, channels=4, seed=1):
    return (np.random.RandomState(seed).rand(n, channels, b, b)
            < 0.4).astype(np.float32)


@pytest.mark.parametrize("b,width", ((4, 1), (6, 2), (7, 1), (10, 1)))
def test_forward_matches_flax(b, width):
    jnet, params = _flax(b, width)
    x = _obs(b)
    want_logits, want_value, _ = make_apply_fn(jnet)(params, jnp.asarray(x))
    net = policy_net_from_flax(params, device="cpu")
    assert net.board_size == b and net.fc.in_features == (
        64 * width * max((b + 1) // 2 - 2, 0) ** 2)
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    assert logits.shape == (16, b * b)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=1e-5, rtol=0)
    if b == 4:
        # 0 features: every row is the fc's bias through the heads.
        assert torch.equal(logits, logits[:1].expand_as(logits))


def test_recurrent_and_frame_stack_forward_match_flax_on_6x6():
    b = 6
    jnet, params = _flax(b, recurrent=True)
    x = _obs(b)
    h = np.random.RandomState(2).randn(16, HIDDEN).astype(np.float32)
    mask = (np.arange(16) % 3 != 0).astype(np.float32)
    want = make_apply_fn_recurrent(jnet)(params, jnp.asarray(x),
                                         jnp.asarray(h), jnp.asarray(mask))
    net = policy_net_from_flax(params, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(h),
                  torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)

    jnet, params = _flax(b, channels=12)
    apply_fn = make_apply_fn_framestack(jnet, 3, JaxEnvConfig(board_size=b))
    cell = FrameStackCell(policy_net_from_flax(params, device="cpu"), 3, b)
    assert cell.hidden_size == apply_fn.hidden_size == 2 * 4 * 36
    h = (np.random.RandomState(3).rand(16, cell.hidden_size)
         < 0.4).astype(np.float32)
    want = apply_fn(params, jnp.asarray(x), jnp.asarray(h),
                    jnp.asarray(mask))
    with torch.no_grad():
        got = cell(torch.from_numpy(x), torch.from_numpy(h),
                   torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("b", (6, 7))
def test_param_tree_round_trips(b):
    _, params = _flax(b, width=2)
    back = dict(flax_leaves(flax_tree(policy_net_from_flax(params,
                                                           device="cpu"))))
    want = dict(flax_leaves(params))
    assert back.keys() == want.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(back[key], np.asarray(leaf),
                                      err_msg="/".join(key))


def test_board6_ppo_update_matches_jax():
    """One update (4 epochs x 4 minibatches of 64) on a 6x6 rollout."""
    b, t, n = 6, 8, 32
    rng = np.random.RandomState(6)
    legal = rng.rand(t, n, b * b) < 0.25
    legal[..., 7] = True
    action = np.array([[rng.choice(np.nonzero(legal[i, j])[0])
                        for j in range(n)] for i in range(t)], np.int32)
    done = rng.rand(t, n) < 0.15
    d = dict(obs=(rng.rand(t, n, 4, b, b) < 0.4).astype(np.int8),
             action=action, reward=np.where(done, rng.randint(
                 -36, 37, (t, n)), 0).astype(np.float32),
             done=done, legal=legal)
    jnet, params = _flax(b)
    apply_fn = make_apply_fn(jnet)
    logits, values, _ = apply_fn(params, jnp.asarray(
        d["obs"].reshape(-1, 4, b, b), jnp.float32))
    lp = jax.nn.log_softmax(jnp.where(jnp.asarray(legal.reshape(-1, b * b)),
                                      logits, -1e9))
    lp = np.take_along_axis(np.asarray(lp), action.reshape(-1, 1), 1)
    d["logp"] = (lp.reshape(t, n) + rng.randn(t, n) * 0.1).astype(
        np.float32)
    d["value"] = (np.asarray(values).reshape(t, n)
                  + rng.randn(t, n)).astype(np.float32)
    boot = rng.randn(n).astype(np.float32)
    kw = dict(lr=3e-4, entropy_coef=0.01, num_updates=10)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    key = jax.random.PRNGKey(11)
    jopt = jppo.make_optimizer(jcfg)
    new_params, _, jmetrics = jax.jit(
        jppo.ppo_update, static_argnums=(5, 6, 7))(
        params, jopt.init(params),
        jppo.Transition(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.asarray(boot), key, apply_fn, jopt, jcfg)
    words = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                      for k in jax.random.split(key, jcfg.ppo_epochs)])

    net = policy_net_from_flax(params, device="cpu").train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rollout = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    rollout["action"] = rollout["action"].to(torch.int64)
    metrics = ppo.ppo_update(net, ppo.make_optimizer(cfg, net.parameters()),
                             ppo.Transition(**rollout),
                             torch.from_numpy(boot),
                             torch.from_numpy(words.astype(np.int64)), cfg)
    want = policy_net_from_flax(new_params, device="cpu").state_dict()
    biggest = 0.0
    for name, value in net.state_dict().items():
        want_delta = (want[name] - before[name]).numpy()
        biggest = max(biggest, float(np.abs(want_delta).max()))
        np.testing.assert_allclose((value - before[name]).numpy(),
                                   want_delta, rtol=0, atol=5e-7,
                                   err_msg=name)
    assert biggest > 1e-3
    for name in ("value_loss", "action_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-4,
                                   err_msg=name)
