"""Port distribution and network against the JAX ones: identical sampled
actions on the same uniforms, and the wide2 ``PolicyNet`` forward equal to
flax's after ``policy_net_from_flax``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.engine import BitEngine as JaxBitEngine
from gymothelloenv_tpu.models.distributions import \
    MaskedCategorical as JaxMaskedCategorical
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.models.nets import make_policy_net
from gymothelloenv_tpu_torch.utils.device import resolve_device
from torch_port_helpers import random_states

# fp32 forward on the CPU, both sides: the two frameworks sum the conv and
# matmul products in different orders, a few ulp apart.
ATOL = RTOL = 1e-5

CKPT = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay",
                    "ppo_wide2_4k.msgpack")


def _dist_inputs(n=512, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, 64) * 3).astype(np.float32)
    mask = rng.rand(n, 64) < rng.rand(n, 1)
    mask[:8] = False                         # empty rows
    mask[8:16] = False
    mask[8:16, rng.randint(0, 64, 8)] = True  # single legal move
    return logits, mask


def test_sample_matches_jax_on_same_uniforms():
    logits, mask = _dist_inputs()
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxMaskedCategorical(jnp.asarray(logits),
                                           jnp.asarray(mask)).sample(key))
    u = 1.0 - np.asarray(jax.random.uniform(key, (logits.shape[0],),
                                            dtype=jnp.float32))
    dist = MaskedCategorical(torch.from_numpy(logits), torch.from_numpy(mask))
    got = dist.sample(u=torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:8] == 0).all()
    legal_rows = mask.any(-1)
    assert mask[np.arange(len(got))[legal_rows], got[legal_rows]].all()


def test_sample_from_generator_is_legal():
    logits, mask = _dist_inputs(seed=1)
    dist = MaskedCategorical(torch.from_numpy(logits), torch.from_numpy(mask))
    g = torch.Generator().manual_seed(0)
    got = dist.sample(generator=g).numpy()
    rows = mask.any(-1)
    assert mask[np.arange(len(got))[rows], got[rows]].all()


def test_log_prob_entropy_mode_match_jax():
    logits, mask = _dist_inputs(seed=2)
    rng = np.random.RandomState(4)
    actions = rng.randint(0, 65, logits.shape[0]).astype(np.int32)
    jd = JaxMaskedCategorical(jnp.asarray(logits), jnp.asarray(mask))
    pd = MaskedCategorical(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_allclose(pd.log_prob(torch.from_numpy(actions)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(actions))),
                               rtol=1e-6, atol=1e-6)
    illegal = ~mask[np.arange(len(actions)), actions.clip(0, 63)]
    illegal |= actions == 64
    assert (pd.log_prob(torch.from_numpy(actions)).numpy()[illegal] == 0).all()
    np.testing.assert_allclose(pd.entropy_full().numpy(),
                               np.asarray(jd.entropy_full()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pd.mode().numpy(), np.asarray(jd.mode()))


def _net_inputs(n=48):
    planes = np.asarray(JaxBitEngine().featurize(random_states(n, seed=30)))
    rng = np.random.RandomState(5)
    noise = rng.rand(8, 4, 8, 8).astype(np.float32)   # off the 0/1 lattice
    return np.concatenate([planes, noise])


def _compare_forward(flax_params, width_mult, hidden_size):
    jnet = JaxPolicyNet(num_actions=64, hidden_size=hidden_size,
                        width_mult=width_mult)
    x = _net_inputs()
    want_logits, want_value, _ = jnet.apply(flax_params, jnp.asarray(x))
    numpy_params = jax.tree.map(np.asarray, flax_params)
    net = policy_net_from_flax(numpy_params, width_mult, hidden_size,
                               device="cpu")
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=ATOL, rtol=RTOL)


def test_policy_net_from_flax_wide2_seeded_init():
    """wide2 = ``--width-mult 2 --hidden-size 1024`` (RESULTS.md), the
    capacity of data/selfplay/ppo_wide2_4k.msgpack."""
    jnet = JaxPolicyNet(num_actions=64, hidden_size=1024, width_mult=2)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)))
    # Lift the 0.01-gain logits head so the logits are O(1), not ~0.
    head = params["params"]["Dense_2"]
    head["kernel"] = head["kernel"] * 100.0
    _compare_forward(params, 2, 1024)


def test_policy_net_from_flax_committed_wide2_checkpoint():
    if not os.path.isfile(CKPT):
        pytest.skip(f"checkpoint not in this checkout: {CKPT}")
    from gymothelloenv_tpu.utils.checkpoint import load_checkpoint
    _, raw, _, _ = load_checkpoint(CKPT)
    p = raw["params"]
    width_mult = p["ConvTrunk_0"]["Conv_0"]["kernel"].shape[-1] // 32
    hidden = p["Dense_0"]["kernel"].shape[-1]
    assert (width_mult, hidden) == (2, 1024)
    _compare_forward({"params": p}, width_mult, hidden)


def test_policy_net_from_flax_rejects_wrong_width():
    jnet = JaxPolicyNet(num_actions=64, hidden_size=64, width_mult=1)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                                jnp.zeros((1, 4, 8, 8))))
    with pytest.raises(ValueError):
        policy_net_from_flax(params, 2, 64, device="cpu")


def test_make_policy_net_seeded_and_shaped():
    a = make_policy_net(2, 1024, seed=7, device="cpu")
    b = make_policy_net(2, 1024, seed=7, device="cpu")
    assert a.trunk.conv0.weight.shape == (64, 4, 3, 3)
    assert a.fc.weight.shape == (1024, 512)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    logits, value = a(torch.zeros(3, 4, 8, 8))
    assert logits.shape == (3, 64) and value.shape == (3,)


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
