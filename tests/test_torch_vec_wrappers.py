"""``envs/vec_wrappers.py``, ``compute_gae_time_limits``, the time-limited
``ppo_update`` and the weighted loss against ``gymothelloenv_tpu`` on the
same numpy-seeded inputs: the frame stack and the time limit bit for bit;
the running statistics and the normalised observations and rewards to
rtol 1e-6 (XLA on the CPU sums a batch axis in row order and multiplies
by 1/N, torch sums in another order: the sums differ in the last bit);
proper-time-limit GAE bit for bit (and equal to ``compute_gae`` where
nothing is truncated); one time-limited update step to 1e-6; the weighted
loss terms to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.envs import vec_wrappers as jvw
from gymothelloenv_tpu.train.ppo_trainer import make_apply_fn
from gymothelloenv_tpu_torch.agents import ppo
from gymothelloenv_tpu_torch.envs import vec_wrappers as vw
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from test_torch_ppo import (HIDDEN, N, T, _flax_params, _jax_rollout,
                            _loss_inputs, _port_rollout, _rollout)
from torch_port_helpers import one_torch_thread  # noqa: F401


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=msg)


def _close(got, want, msg=""):
    """To rtol 1e-6, a few float32 steps (see the module docstring)."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0, err_msg=msg)


def _same_rms(got, want, msg):
    for f in ("mean", "var"):
        _close(getattr(got, f), getattr(want, f), f"{msg} {f}")
    _eq(got.count, want.count, f"{msg} count")


def test_running_mean_std_matches_jax():
    """Three batches merged, plain and masked, then the normaliser."""
    rng = np.random.RandomState(0)
    j, p = jvw.rms_init((3, 2)), vw.rms_init((3, 2))
    jm, pm = j, p
    for k in range(3):
        batch = (rng.randn(24, 3, 2) * (k + 1) + k).astype(np.float32)
        w = (rng.rand(24) < 0.6).astype(np.float32)
        j = jax.jit(jvw.rms_update)(j, jnp.asarray(batch))
        p = vw.rms_update(p, torch.from_numpy(batch))
        jm = jax.jit(jvw.rms_update_masked)(jm, jnp.asarray(batch),
                                            jnp.asarray(w))
        pm = vw.rms_update_masked(pm, torch.from_numpy(batch),
                                  torch.from_numpy(w))
        _same_rms(p, j, f"batch {k}")
        _same_rms(pm, jm, f"masked batch {k}")
    x = (rng.randn(5, 3, 2) * 40).astype(np.float32)
    _close(vw.rms_normalize(p, torch.from_numpy(x), 2.0),
           jax.jit(jvw.rms_normalize, static_argnums=2)(j, jnp.asarray(x),
                                                        2.0))


def test_vecnorm_matches_jax():
    """Observation filter (training then frozen) and the return-scaled
    reward with resets, over four steps."""
    rng = np.random.RandomState(1)
    j = jvw.vecnorm_init((4,), 16, gamma=0.9, clipob=3.0, cliprew=2.0)
    p = vw.vecnorm_init((4,), 16, gamma=0.9, clipob=3.0, cliprew=2.0)
    obs_j = jax.jit(jvw.vecnorm_obs, static_argnums=2)
    rew_j = jax.jit(jvw.vecnorm_reward, static_argnums=3)
    for k in range(4):
        training = k < 3
        obs = (rng.randn(16, 4) * 5).astype(np.float32)
        reward = (rng.randn(16) * 3).astype(np.float32)
        done = rng.rand(16) < 0.3
        j, jo = obs_j(j, jnp.asarray(obs), training)
        p, po = vw.vecnorm_obs(p, torch.from_numpy(obs), training)
        _close(po, jo, f"obs {k}")
        j, jr = rew_j(j, jnp.asarray(reward), jnp.asarray(done), training)
        p, pr = vw.vecnorm_reward(p, torch.from_numpy(reward),
                                  torch.from_numpy(done), training)
        _close(pr, jr, f"reward {k}")
        _eq(p.ret, j.ret, f"ret {k}")
        _same_rms(p.ob_rms, j.ob_rms, f"ob_rms {k}")
        _same_rms(p.ret_rms, j.ret_rms, f"ret_rms {k}")


def test_frame_stack_and_time_limit_match_jax():
    """Five steps of the frame window (resets zero it) and of the step
    cap (a cap hit on the step the task also ended is flagged)."""
    rng = np.random.RandomState(2)
    obs = (rng.rand(12, 4, 8, 8) < 0.5).astype(np.float32)
    j, p = jvw.frame_stack_init(jnp.asarray(obs), 3), vw.frame_stack_init(
        torch.from_numpy(obs), 3)
    _eq(p.stacked, j.stacked, "init")
    jt, pt = jvw.time_limit_init(12, 3), vw.time_limit_init(12, 3)
    flagged = 0
    for k in range(5):
        obs = (rng.rand(12, 4, 8, 8) < 0.5).astype(np.float32)
        done = rng.rand(12) < 0.25
        j = jvw.frame_stack_step(j, jnp.asarray(obs), jnp.asarray(done))
        p = vw.frame_stack_step(p, torch.from_numpy(obs),
                                torch.from_numpy(done))
        _eq(p.stacked, j.stacked, f"stack {k}")
        jt, jd, jb = jvw.time_limit_step(jt, jnp.asarray(done))
        pt, pd, pb = vw.time_limit_step(pt, torch.from_numpy(done))
        for name, a, b in (("elapsed", pt.elapsed, jt.elapsed),
                           ("done", pd, jd), ("bad", pb, jb)):
            _eq(a, b, f"{name} {k}")
        flagged += int((pb & torch.from_numpy(done)).sum())
    assert flagged > 0     # the cap and the task's end on one step


def _bad(seed, p=0.1):
    return np.random.RandomState(seed).rand(T, N) < p


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_time_limits_matches_jax_exactly(seed):
    cfg, jcfg = ppo.PPOConfig(), jppo.PPOConfig()
    d = _rollout(seed)
    d["reward"] = np.random.RandomState(seed + 9).randn(T, N).astype(
        np.float32)
    boot = np.random.RandomState(seed + 5).randn(N).astype(np.float32)
    bad = _bad(seed)
    fn = jax.jit(jppo.compute_gae_time_limits, static_argnums=3)
    want = fn(_jax_rollout(d), jnp.asarray(bad), jnp.asarray(boot), jcfg)
    got = ppo.compute_gae_time_limits(_port_rollout(d),
                                      torch.from_numpy(bad),
                                      torch.from_numpy(boot), cfg)
    for a, b in zip(got, want):
        _eq(a, b)
    assert (got[0].numpy()[bad] == 0).all()
    plain = ppo.compute_gae(_port_rollout(d), torch.from_numpy(boot), cfg)
    none = ppo.compute_gae_time_limits(_port_rollout(d),
                                       torch.zeros(T, N, dtype=torch.bool),
                                       torch.from_numpy(boot), cfg)
    for a, b in zip(none, plain):
        assert torch.equal(a, b)


def test_time_limited_update_step_matches_jax():
    """One optimizer step (1 epoch, 1 minibatch) with ``bad_transition``:
    parameter deltas to 1e-6 of JAX's (lr 3e-4); metrics to rtol 1e-5."""
    jnet, params = _flax_params(0)
    kw = dict(lr=3e-4, num_updates=1, ppo_epochs=1, num_mini_batch=1)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    d = _rollout(4)
    boot = np.random.RandomState(3).randn(N).astype(np.float32)
    bad = _bad(6, 0.2)
    key = jax.random.PRNGKey(3)
    jopt = jppo.make_optimizer(jcfg)
    new, _, jm = jax.jit(jppo.ppo_update, static_argnums=(5, 6, 7))(
        params, jopt.init(params), _jax_rollout(d), jnp.asarray(boot), key,
        make_apply_fn(jnet), jopt, jcfg, None, None, jnp.asarray(bad))
    words = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                      for k in jax.random.split(key, 1)]).astype(np.int64)
    net = policy_net_from_flax(params, 1, HIDDEN, device="cpu").train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    m = ppo.ppo_update(net, ppo.make_optimizer(cfg, net.parameters()),
                       _port_rollout(d), torch.from_numpy(boot),
                       torch.from_numpy(words), cfg,
                       bad_transition=torch.from_numpy(bad))
    want = policy_net_from_flax(jax.tree.map(np.asarray, new), 1, HIDDEN,
                                device="cpu").state_dict()
    for name, value in net.state_dict().items():
        np.testing.assert_allclose((value - before[name]).numpy(),
                                   (want[name] - before[name]).numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in m:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="exclusive"):
        ppo.ppo_update(net, ppo.make_optimizer(cfg, net.parameters()),
                       _port_rollout(d), torch.from_numpy(boot),
                       torch.from_numpy(words), cfg,
                       weights=torch.ones(T, N),
                       bad_transition=torch.from_numpy(bad))


def test_weighted_loss_terms_match_jax():
    """Weight-0 rows leave every mean (``weights``, JAX's ``wmean``)."""
    flat, logits, values, adv, ret = _loss_inputs(5)
    w = (np.random.RandomState(8).rand(len(adv)) < 0.6).astype(np.float32)
    cfg = dict(entropy_coef=0.01)
    want_total, want = jppo.ppo_loss_terms(
        jnp.asarray(logits), jnp.asarray(values),
        jppo.Transition(**{k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(adv), jnp.asarray(ret), jppo.PPOConfig(**cfg),
        jnp.asarray(w))
    total, got = ppo.ppo_loss_terms(
        torch.from_numpy(logits), torch.from_numpy(values),
        _port_rollout(flat), torch.from_numpy(adv), torch.from_numpy(ret),
        ppo.PPOConfig(**cfg), torch.from_numpy(w))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
