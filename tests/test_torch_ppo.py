"""The port's PPO pieces against ``gymothelloenv_tpu.agents.ppo`` on the same
numpy-seeded inputs: GAE (exact), the loss terms (rtol 1e-5), the optimizer
against optax, and one full ``ppo_update`` from converted params, the same
rollout and the same epoch key words (parameter deltas to fp32 tolerance,
stated below)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train.ppo_trainer import make_apply_fn
from gymothelloenv_tpu_torch.agents import ppo
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from torch_port_helpers import one_torch_thread  # noqa: F401

T, N, HIDDEN = 8, 32, 32


def _rollout(seed):
    """A (T, N) rollout of plausible values: {0,1} int8 planes, random
    legal masks with >= 1 legal move, legal actions, terminal rewards."""
    rng = np.random.RandomState(seed)
    legal = rng.rand(T, N, 64) < 0.2
    legal[..., 19] = True
    action = np.array([[rng.choice(np.nonzero(legal[t, n])[0])
                        for n in range(N)] for t in range(T)])
    done = rng.rand(T, N) < 0.15
    reward = np.where(done, rng.randint(-64, 65, (T, N)), 0)
    return dict(
        obs=(rng.rand(T, N, 4, 8, 8) < 0.4).astype(np.int8),
        action=action.astype(np.int32),
        logp=(-rng.rand(T, N) * 3).astype(np.float32),
        value=(rng.randn(T, N) * 5).astype(np.float32),
        reward=reward.astype(np.float32), done=done, legal=legal)


def _jax_rollout(d):
    return jppo.Transition(**{k: jnp.asarray(v) for k, v in d.items()})


def _port_rollout(d):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    t["action"] = t["action"].to(torch.int64)
    return ppo.Transition(**t)


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_jax_exactly(seed):
    cfg = ppo.PPOConfig(gamma=0.99, gae_lambda=0.95)
    jcfg = jppo.PPOConfig(gamma=0.99, gae_lambda=0.95)
    d = _rollout(seed)
    d["reward"] = np.random.RandomState(seed + 9).randn(T, N).astype(
        np.float32)
    boot = np.random.RandomState(seed + 5).randn(N).astype(np.float32)
    want_adv, want_ret = jax.jit(jppo.compute_gae, static_argnums=2)(
        _jax_rollout(d), jnp.asarray(boot), jcfg)
    adv, ret = ppo.compute_gae(_port_rollout(d), torch.from_numpy(boot), cfg)
    np.testing.assert_array_equal(adv.numpy(), np.asarray(want_adv))
    np.testing.assert_array_equal(ret.numpy(), np.asarray(want_ret))


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    d = _rollout(seed)
    flat = {k: v.reshape((T * N,) + v.shape[2:]) for k, v in d.items()}
    logits = (rng.randn(T * N, 64) * 2).astype(np.float32)
    values = (flat["value"] + rng.randn(T * N) * 0.2).astype(np.float32)
    adv = rng.randn(T * N).astype(np.float32)
    ret = (flat["value"] + rng.randn(T * N)).astype(np.float32)
    return flat, logits, values, adv, ret


@pytest.mark.parametrize("clipped", [True, False])
def test_loss_terms_match_jax(clipped):
    """rtol 1e-5: means over 256 rows and log-softmax sum in different
    orders in the two frameworks."""
    flat, logits, values, adv, ret = _loss_inputs(3)
    kw = dict(entropy_coef=0.01, use_clipped_value_loss=clipped)
    want_total, want = jppo.ppo_loss_terms(
        jnp.asarray(logits), jnp.asarray(values),
        jppo.Transition(**{k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(adv), jnp.asarray(ret), jppo.PPOConfig(**kw))
    batch = _port_rollout(flat)
    total, got = ppo.ppo_loss_terms(
        torch.from_numpy(logits), torch.from_numpy(values), batch,
        torch.from_numpy(adv), torch.from_numpy(ret), ppo.PPOConfig(**kw))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    for name in ("value_loss", "action_loss", "entropy"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)


def test_optimizer_matches_optax_on_a_clipped_and_an_unclipped_step():
    """Clip + Adam + linear decay against optax on fixed gradients: the
    first step's norm is above max_norm, the second's below it.
    Tolerance on the deltas: rtol 1e-6 and atol 2.4e-7, one float32 ulp
    of the parameters (|w| < 4): the two optimizers round the update in
    other orders, which can move the stored parameter by an ulp."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32),
             (rng.randn(5, 3) * 0.01).astype(np.float32)]
    cfg = ppo.PPOConfig(lr=3e-4, num_updates=1, ppo_epochs=1,
                        num_mini_batch=4)
    jopt = jppo.make_optimizer(jppo.PPOConfig(
        lr=3e-4, num_updates=1, ppo_epochs=1, num_mini_batch=4))
    jw = jnp.asarray(w0)
    state = jopt.init(jw)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = ppo.make_optimizer(cfg, [w])
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy() - w0,
                                   np.asarray(jw) - w0, rtol=1e-6,
                                   atol=2.4e-7)
    assert np.abs(w0).max() < 4
    assert opt.adam.param_groups[0]["lr"] == pytest.approx(3e-4 * 0.5)


def _flax_params(seed):
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN, width_mult=1)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)))
    head = params["params"]["Dense_2"]
    head["kernel"] = head["kernel"] * 100.0   # O(1) logits, not ~0
    return jnet, params


def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_ppo_update_matches_jax():
    """One full update (4 epochs x 4 minibatches of 64, hash shuffle) from
    the same params, rollout and epoch key words.  lr 3e-4 so the step is
    visible; the deltas are compared, not only the values.  Tolerance:
    atol 5e-7 on deltas of up to ~5e-3, a few float32 ulps of the
    parameters (|w| < 1): XLA and torch sum the fp32 gradients in other
    orders, and 16 Adam steps round each update.  Measured on the CPU:
    at most 9e-8.  rtol 1e-4 on the metrics."""
    jnet, params = _flax_params(0)
    apply_fn = make_apply_fn(jnet)
    kw = dict(lr=3e-4, entropy_coef=0.01, num_updates=10)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    d = _rollout(6)
    # Behaviour log-probs near the net's own, so the ratio clip is live.
    obs = jnp.asarray(d["obs"].reshape(-1, 4, 8, 8), jnp.float32)
    logits, values, _ = apply_fn(params, obs)
    lp = jax.nn.log_softmax(jnp.where(jnp.asarray(d["legal"].reshape(-1, 64)),
                                      logits, -1e9))
    lp = np.take_along_axis(np.asarray(lp), d["action"].reshape(-1, 1), 1)
    rng = np.random.RandomState(7)
    d["logp"] = (lp.reshape(T, N) + rng.randn(T, N) * 0.1).astype(np.float32)
    d["value"] = (np.asarray(values).reshape(T, N)
                  + rng.randn(T, N)).astype(np.float32)
    boot = rng.randn(N).astype(np.float32)

    key = jax.random.PRNGKey(11)
    jopt = jppo.make_optimizer(jcfg)
    new_params, _, jmetrics = jax.jit(
        jppo.ppo_update, static_argnums=(5, 6, 7))(
        params, jopt.init(params), _jax_rollout(d), jnp.asarray(boot), key,
        apply_fn, jopt, jcfg)
    words = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                      for k in jax.random.split(key, jcfg.ppo_epochs)])

    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu").train()
    before = _state(net)
    opt = ppo.make_optimizer(cfg, net.parameters())
    metrics = ppo.ppo_update(net, opt, _port_rollout(d),
                             torch.from_numpy(boot),
                             torch.from_numpy(words.astype(np.int64)), cfg)
    want = _state(policy_net_from_flax(new_params, 1, HIDDEN, device="cpu"))
    biggest = 0.0
    for name, value in _state(net).items():
        got_delta = (value - before[name]).numpy()
        want_delta = (want[name] - before[name]).numpy()
        biggest = max(biggest, float(np.abs(want_delta).max()))
        np.testing.assert_allclose(got_delta, want_delta, rtol=0, atol=5e-7,
                                   err_msg=name)
    assert biggest > 1e-3           # the update really moved the params
    for name in ("value_loss", "action_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-4,
                                   err_msg=name)


def test_ppo_update_sort_shuffle_and_bad_words():
    """The non-power-of-two batch takes the permutation path."""
    d = {k: v[:, :24] for k, v in _rollout(8).items()}
    _, params = _flax_params(1)
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu").train()
    before = _state(net)
    cfg = ppo.PPOConfig(lr=3e-4, num_updates=2)
    opt = ppo.make_optimizer(cfg, net.parameters())
    g = torch.Generator().manual_seed(0)
    rollout = _port_rollout(d)
    boot = torch.zeros(24)
    m = ppo.ppo_update(net, opt, rollout, boot, draw_words(g, 4), cfg)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert any(not torch.equal(v, before[k])
               for k, v in _state(net).items())
    with pytest.raises(ValueError):
        ppo.ppo_update(net, opt, rollout, boot, draw_words(g, 3), cfg)


@pytest.mark.parametrize("field", ["shuffle"])
def test_ppo_config_rejects_unported(field):
    with pytest.raises(ValueError):
        ppo.PPOConfig(**{field: "radix"})
