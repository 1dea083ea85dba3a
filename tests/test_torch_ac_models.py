"""The port's actor-critic model family (``models/nets.py``
``ActorCriticNet``, ``MLPBase``, ``DiagGaussianHead``, ``BernoulliHead``;
``models/distributions.py`` ``DiagNormal``, ``BernoulliDist``) against
flax's: every forward to 1e-6 (of the output's largest, for the conv net)
after ``models/convert.py``, the port's own tree equal to flax's leaf for
leaf, the distributions' ``log_prob``/``entropy``/``mode`` to 1e-6, and
``sample`` with JAX's uniforms injected exactly, with its normals to one
float32 spacing (torch's and XLA's ``exp`` differ in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.models import nets as jnets
from gymothelloenv_tpu_torch.models import nets
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    load_flax_params)
from gymothelloenv_tpu_torch.models.distributions import (BernoulliDist,
                                                          DiagNormal)
from torch_port_helpers import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_tree(net, params):
    mine = dict(flax_leaves(flax_tree(net)))
    theirs = dict(flax_leaves(params))
    assert set(mine) == set(theirs)
    for k, leaf in theirs.items():
        np.testing.assert_array_equal(mine[k], np.asarray(leaf),
                                      err_msg=str(k))


@pytest.mark.parametrize("b", [8, 6])
def test_actor_critic_net_equals_flax(b):
    jnet = jnets.ActorCriticNet(num_actions=b * b)
    x = (np.random.RandomState(b).rand(12, 4, b, b) < 0.4).astype(
        np.float32)
    params = jnet.init(jax.random.PRNGKey(b), jnp.asarray(x))
    want = jnet.apply(params, jnp.asarray(x))
    net = load_flax_params(nets.ActorCriticNet(num_actions=b * b,
                                               board_size=b), params)
    got = net(_t(x))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))
    assert got[0].shape == (12, b * b) and got[1].shape == (12,)
    _same_tree(net, params)


def test_actor_critic_net_init_is_torch_default():
    """Kaiming-uniform kernels (bound sqrt(6 / ((1 + 5) fan_in))) and zero
    biases, as flax's ``torch_default_init``."""
    net = nets.ActorCriticNet()
    net.reset_parameters(torch.Generator().manual_seed(0))
    for layer in (net.fc, net.logits, net.value, net.trunk.conv0):
        fan_in = layer.weight[0].numel()
        bound = 1.0 / np.sqrt(fan_in)
        assert float(layer.weight.detach().abs().max()) <= bound
        assert not layer.bias.detach().any()


def test_mlp_base_equals_flax():
    jnet = jnets.MLPBase(num_actions=9, hidden_size=16)
    x = np.random.RandomState(0).randn(10, 20).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jnet.apply(params, jnp.asarray(x))
    net = load_flax_params(nets.MLPBase(20, 9, hidden_size=16), params)
    for g, w in zip(net(_t(x)), want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6)
    _same_tree(net, params)
    mine = nets.MLPBase(20, 9, hidden_size=16)
    mine.reset_parameters(torch.Generator().manual_seed(0))
    w = mine.actor0.weight.detach()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(16), atol=1e-5,
                               rtol=0)               # orthogonal, gain sqrt 2


def test_gaussian_and_bernoulli_heads_equal_flax():
    x = np.random.RandomState(2).randn(7, 12).astype(np.float32)
    jg = jnets.DiagGaussianHead(num_outputs=3)
    gp = jg.init(jax.random.PRNGKey(3), jnp.asarray(x))
    gp = jax.tree.map(np.array, gp)
    gp["params"]["log_std"] = np.array([0.3, -0.2, 0.1], np.float32)
    jd = jg.apply(gp, jnp.asarray(x))
    head = load_flax_params(nets.DiagGaussianHead(12, 3), gp)
    d = head(_t(x))
    np.testing.assert_allclose(d.mean.detach().numpy(), np.asarray(jd.mean),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.log_std.detach().numpy(),
                               np.asarray(jd.log_std), rtol=0, atol=0)
    _same_tree(head, gp)
    jb = jnets.BernoulliHead(num_outputs=5)
    bp = jb.init(jax.random.PRNGKey(4), jnp.asarray(x))
    head = load_flax_params(nets.BernoulliHead(12, 5), bp)
    np.testing.assert_allclose(head(_t(x)).logits.detach().numpy(),
                               np.asarray(jb.apply(bp, jnp.asarray(x)).logits),
                               rtol=0, atol=1e-6)
    _same_tree(head, bp)


def test_diag_normal_equals_jax():
    rng = np.random.RandomState(5)
    mean = rng.randn(9, 4).astype(np.float32)
    log_std = (rng.randn(9, 4) * 0.5).astype(np.float32)
    actions = rng.randn(9, 4).astype(np.float32)
    jd = jdist.DiagNormal(mean=jnp.asarray(mean), log_std=jnp.asarray(log_std))
    d = DiagNormal(mean=_t(mean), log_std=_t(log_std))
    for got, want in ((d.log_prob(_t(actions)), jd.log_prob(
            jnp.asarray(actions))), (d.entropy(), jd.entropy()),
            (d.mode(), jd.mode())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, mean.shape))
    want = np.asarray(jd.sample(key))
    # One float32 spacing: torch's and XLA's exp differ in the last bit on
    # a few of these log-stds; mean + std * eps is otherwise the same.
    np.testing.assert_allclose(d.sample(_t(eps)).numpy(), want, rtol=0,
                               atol=2.0 ** -23 * np.abs(want).max())
    shared = DiagNormal(mean=_t(mean), log_std=_t(log_std[0]))
    jshared = jdist.DiagNormal(mean=jnp.asarray(mean),
                               log_std=jnp.asarray(log_std[0]))
    np.testing.assert_allclose(shared.entropy().numpy(),
                               np.asarray(jshared.entropy()), atol=1e-6)
    drawn = d.sample(generator=torch.Generator().manual_seed(0))
    assert drawn.shape == mean.shape and bool(torch.isfinite(drawn).all())


def test_bernoulli_equals_jax():
    rng = np.random.RandomState(7)
    logits = (rng.randn(11, 6) * 3).astype(np.float32)
    bits = (rng.rand(11, 6) < 0.5).astype(np.float32)
    jd = jdist.BernoulliDist(logits=jnp.asarray(logits))
    d = BernoulliDist(logits=_t(logits))
    for got, want in ((d.log_prob(_t(bits)), jd.log_prob(jnp.asarray(bits))),
                      (d.entropy(), jd.entropy()), (d.mode(), jd.mode()),
                      (d.probs(), jd.probs())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    key = jax.random.PRNGKey(8)
    u = np.asarray(jax.random.uniform(key, logits.shape))
    np.testing.assert_array_equal(d.sample(_t(u)).numpy(),
                                  np.asarray(jd.sample(key)))
    drawn = d.sample(generator=torch.Generator().manual_seed(0))
    assert set(np.unique(drawn.numpy())) <= {0.0, 1.0}
