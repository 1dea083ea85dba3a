"""The port's K-FAC and ACKTR (``agents/kfac.py``, ``train/acktr_trainer.py``,
``cli/acktr_train.py``) against JAX's: ``_patch_rows`` against
``conv_general_dilated_patches`` (exact), ``stack_apply`` on the MLP and
conv towers with its layer inputs (1e-6 of the largest), the
zero-perturbation gradients of the Fisher losses with JAX's draws
injected (1e-6 of the largest), ``update_fisher_stats`` (1e-6), the
natural gradient of ``kfac_step`` on given factors (per leaf 1e-5 of the
largest) and its step (1e-5), one ``acktr_update`` on a
refresh step and then on a non-refresh step (each parameter's step within
1e-4 of the leaf's largest plus one float32 spacing of the parameter), the
committed ``acktr_ent05_200`` checkpoint's forward (1e-5), checkpoints
byte for byte both ways, the trainer's refusals and the CLI with both
towers.

``acktr_update`` in JAX draws the Fisher sample's actions and the
critic's noise from one key (``1 - uniform(key)`` and ``normal(key)``);
the port takes the same numbers as ``InjectedDraws`` uniforms and
normals.  The eigenvectors of LAPACK and XLA differ by sign and by
rotations within near-degenerate eigenspaces, so only what the
preconditioner makes of them is compared."""

import contextlib
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gymothelloenv_tpu.agents import kfac as jkfac
from gymothelloenv_tpu.agents.ppo import Transition as JaxTransition
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import acktr_trainer as jacktr
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu_torch.agents import kfac
from gymothelloenv_tpu_torch.cli import acktr_train
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train.acktr_trainer import ACKTRSelfPlayTrainer
from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay")
K = 48      # rows of an update
CFG = kfac.ACKTRConfig(entropy_coef=0.05)
JCFG = jkfac.ACKTRConfig(entropy_coef=0.05)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_params(jparams):
    return [{"w": _t(p["w"]), "b": _t(p["b"])} for p in jparams]


def _specs(jspecs):
    """JAX's layer specs as the port's."""
    return tuple((kfac.ConvSpec if isinstance(s, jkfac.ConvSpec)
                  else kfac.DenseSpec)(**vars(s)) for s in jspecs)


def _planes(n, b=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 4, b, b) < 0.4).astype(np.float32)


def _rows(seed, b=8):
    """An update's flat rows: {0,1} planes, legal masks with >= 1 legal
    move, legal actions, returns."""
    rng = np.random.RandomState(seed)
    legal = rng.rand(K, b * b) < 0.2
    legal[:, 3] = True
    action = np.array([rng.choice(np.nonzero(row)[0]) for row in legal])
    return dict(obs=_planes(K, b, seed), legal=legal,
                action=action.astype(np.int32),
                returns=rng.uniform(-1, 1, K).astype(np.float32))


@functools.cache
def _jax_agent(net, b=8, seed=0):
    key = jax.random.PRNGKey(seed)
    if net == "conv":
        return jkfac.acktr_conv_init(key, board_size=b, num_actions=b * b)
    return jkfac.acktr_init(key, obs_dim=4 * b * b, num_actions=b * b)


def _port_agent(jagent, net, b=8):
    agent = (kfac.acktr_conv_init(b, b * b, device="cpu") if net == "conv"
             else kfac.acktr_init(4 * b * b, b * b, device="cpu"))
    agent.load_flax_tree(jax.tree.map(np.array,
                                      serialization.to_state_dict(jagent)))
    return agent


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() <= rtol * scale, what


def _step_close(got, want, old, rtol, what):
    """A parameter's step (``got``/``want`` less ``old``) within ``rtol`` of
    the leaf's largest, plus one float32 spacing of the parameter, which
    each side's ``p - lr * buf`` rounds to."""
    got, want, old = (np.asarray(a) for a in (got, want, old))
    wd = want - old
    assert np.abs(wd).max() > 0, what
    assert (np.abs(got - old - wd) <= rtol * np.abs(wd).max()
            + 2.0 ** -23 * np.abs(want)).all(), what


@pytest.mark.parametrize("b", [8, 6])
def test_patch_rows_equal_jax(b):
    for spec in kfac.conv_trunk_specs(b)[:3]:
        jspec = jkfac.ConvSpec(**vars(spec))
        x = np.random.RandomState(spec.c_in).randn(
            5, spec.c_in, spec.h, spec.w).astype(np.float32)
        want = np.asarray(jkfac._patch_rows(jspec, jnp.asarray(x)))
        got = kfac._patch_rows(spec, _t(x)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_stack_apply_and_inputs_equal_jax(net):
    """Both towers' outputs and every layer's K-FAC input rows within 1e-6
    of their largest."""
    jagent = _jax_agent(net)
    x = _planes(16, seed=1)
    if net == "mlp":
        x = x.reshape(16, -1)
    for jp, jspecs in ((jagent.actor, jagent.actor_specs),
                       (jagent.critic, jagent.critic_specs)):
        want, want_in = jkfac.stack_apply(jp, jspecs, jnp.asarray(x))
        got, got_in = kfac.stack_apply(_port_params(jp), _specs(jspecs),
                                       _t(x))
        _close(got.numpy(), want, 1e-6, "out")
        for i, (g, w) in enumerate(zip(got_in, want_in, strict=True)):
            _close(g.numpy(), w, 1e-6, f"input {i}")
    if net == "mlp":      # mlp_stack_apply is stack_apply on mlp_specs
        want, _ = jkfac.mlp_stack_apply(jagent.actor, jnp.asarray(x))
        got, _ = kfac.mlp_stack_apply(_port_params(jagent.actor), _t(x))
        _close(got.numpy(), want, 1e-6, "mlp_stack_apply")


def test_stack_init_is_orthogonal_at_the_specs_gains():
    """``mlp_stack_init``/``stack_init``: each kernel ``(in, out)`` with
    orthonormal columns (rows where out > in) times the spec's gain, and
    zero biases, as JAX's ``orthogonal(gain)``."""
    gen = torch.Generator().manual_seed(0)
    sizes = [256, 64, 64, 64]
    for params, specs in ((kfac.mlp_stack_init(sizes, gen),
                           kfac.mlp_specs(sizes)),
                          (kfac.stack_init(kfac.conv_trunk_specs(8), gen),
                           kfac.conv_trunk_specs(8))):
        for p, spec in zip(params, specs, strict=True):
            w = p["w"]
            gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
            torch.testing.assert_close(
                gram, spec.gain ** 2 * torch.eye(gram.shape[0]), rtol=0,
                atol=1e-4 * max(1.0, spec.gain ** 2))
            assert not p["b"].any()
    assert [s.gain for s in kfac.mlp_specs(sizes)][-1] == 0.01


def _fisher_draws(key):
    u = 1.0 - np.asarray(jax.random.uniform(key, (K,)))
    noise = np.asarray(jax.random.normal(key, (K, 1)))[:, 0]
    return sp.InjectedDraws((), [_t(u)], normals=[_t(noise)])


def _jax_fisher(jagent, rows, key, cfg=JCFG):
    """JAX's Fisher gradients and layer inputs, as ``acktr_update`` makes
    them."""
    obs = jnp.asarray(rows["obs"])
    if jagent.actor_specs[0].__class__ is jkfac.DenseSpec:
        obs = obs.reshape(K, -1)
    legal = jnp.asarray(rows["legal"])

    def actor_fisher(pert):
        logits, _ = jkfac.stack_apply(jagent.actor, jagent.actor_specs, obs,
                                      pert)
        dist = jkfac.MaskedCategorical(logits=logits, mask=legal)
        return -dist.log_prob(dist.sample(key)).mean()

    def critic_fisher(pert):
        values, _ = jkfac.stack_apply(jagent.critic, jagent.critic_specs,
                                      obs, pert)
        target = jax.lax.stop_gradient(
            values + jax.random.normal(key, values.shape))
        return -cfg.value_loss_coef * ((values - target) ** 2).mean()
    g_a = jax.grad(actor_fisher)(jkfac.stack_zero_perturb(
        jagent.actor, jagent.actor_specs, K))
    g_c = jax.grad(critic_fisher)(jkfac.stack_zero_perturb(
        jagent.critic, jagent.critic_specs, K))
    _, a_in = jkfac.stack_apply(jagent.actor, jagent.actor_specs, obs)
    _, c_in = jkfac.stack_apply(jagent.critic, jagent.critic_specs, obs)
    return obs, a_in, g_a, c_in, g_c


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_fisher_gradients_and_stats_equal_jax(net):
    """The zero-perturbation gradients dL/dz of both Fisher losses with
    JAX's sample and noise (each layer within 1e-6 of its largest), then
    the running factors after ``update_fisher_stats`` (1e-6)."""
    jagent = _jax_agent(net)
    rows = _rows(3)
    key = jax.random.PRNGKey(4)
    obs, a_in, g_a, c_in, g_c = _jax_fisher(jagent, rows, key)
    agent = _port_agent(jagent, net)
    got = kfac.fisher_grads(agent, _t(obs), _t(rows["legal"]), CFG,
                            _fisher_draws(key))
    for g, w, what in ((got[0], a_in, "actor in"), (got[1], g_a, "actor g"),
                       (got[2], c_in, "critic in"),
                       (got[3], g_c, "critic g")):
        for i, (gi, wi) in enumerate(zip(g, w, strict=True)):
            _close(gi.detach().numpy(), wi, 1e-6, f"{what} {i}")
    ka = jkfac.update_fisher_stats(jagent.kfac_actor, JCFG, a_in, g_a)
    kfac.update_fisher_stats(agent.kfac_actor, CFG, got[0], got[1])
    for ls, jls in zip(agent.kfac_actor.layers, ka.layers):
        _close(ls.m_aa.numpy(), jls.m_aa, 1e-6, "m_aa")
        _close(ls.m_gg.numpy(), jls.m_gg, 1e-6, "m_gg")


def test_kfac_step_natural_gradient_equals_jax():
    """On factors made by one Fisher sample (the first update's), each
    layer's natural gradient within 1e-5 of its largest, and the step of
    every parameter within 1e-5 of the leaf's largest plus one float32
    spacing of the parameter."""
    jagent = _jax_agent("mlp")
    rows = _rows(5)
    key = jax.random.PRNGKey(6)
    obs, a_in, g_a, _, _ = _jax_fisher(jagent, rows, key)
    ka = jkfac.refresh_eigendecomp(jkfac.update_fisher_stats(
        jagent.kfac_actor, JCFG, a_in, g_a), jnp.bool_(True))
    rng = np.random.RandomState(7)
    grads = [{"w": rng.randn(*np.shape(p["w"])).astype(np.float32) * 1e-2,
              "b": rng.randn(*np.shape(p["b"])).astype(np.float32) * 1e-2}
             for p in jagent.actor]
    new, _ = jkfac.kfac_step(jagent.actor, ka, JCFG,
                             jax.tree.map(jnp.asarray, grads))
    state = kfac.KFACState(layers=[kfac.KFACLayerState(**{
        k: _t(getattr(jls, k)) for k in kfac._LAYER_LEAVES})
        for jls in ka.layers])
    kfac.refresh_eigendecomp(state)
    tgrads = [{k: _t(v) for k, v in g.items()} for g in grads]
    nat = kfac.natural_gradients(state, CFG, tgrads)
    for i, (jls, g) in enumerate(zip(ka.layers, grads)):
        g_aug = np.concatenate([g["w"], g["b"][None]], 0)
        v1 = np.asarray(jls.q_g).T @ g_aug.T @ np.asarray(jls.q_a)
        v2 = v1 / (np.asarray(jls.d_g)[:, None] * np.asarray(jls.d_a)[None]
                   + JCFG.damping)
        want = (np.asarray(jls.q_g) @ v2 @ np.asarray(jls.q_a).T).T
        _close(nat[i].numpy(), want, 1e-5, f"natural gradient {i}")
    params = _port_params(jagent.actor)
    kfac.kfac_step(params, state, CFG, tgrads)
    assert state.step == 1
    for i, (p, jp, old) in enumerate(zip(params, new, jagent.actor)):
        for k in ("w", "b"):
            _step_close(p[k].numpy(), jp[k], old[k], 1e-5, f"step {i} {k}")


def _steps_close(agent, jnew, jold, rtol):
    """Each tower parameter's step within ``rtol`` of the leaf's largest,
    plus one float32 spacing of the parameter."""
    got = agent.flax_tree()
    new = jax.tree.map(np.array, serialization.to_state_dict(jnew))
    old = jax.tree.map(np.array, serialization.to_state_dict(jold))
    for tower in ("actor", "critic"):
        for i, layer in new[tower].items():
            for k, w in layer.items():
                _step_close(got[tower][i][k], w, old[tower][i][k], rtol,
                            (tower, i, k))
        for i, layer in new[f"kfac_{tower}"]["layers"].items():
            for k in ("m_aa", "m_gg"):
                _close(got[f"kfac_{tower}"]["layers"][i][k], layer[k], 1e-5,
                       (tower, i, k))


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_two_updates_equal_jax_through_a_refresh(net):
    """``acktr_update`` twice from the same agent: update 0 refreshes the
    eigendecompositions (step 0 % t_inv), update 1 reuses them; JAX's
    draws injected.  After each, every tower parameter's step within 1e-4
    of the leaf's largest plus one float32 spacing of the parameter, the
    factors within 1e-5 of their largest, the metrics to rtol 1e-5."""
    jagent = _jax_agent(net)
    agent = _port_agent(jagent, net)
    update = jax.jit(functools.partial(jkfac.acktr_update, cfg=JCFG))
    for step in range(2):
        rows = _rows(10 + step)
        key = jax.random.PRNGKey(20 + step)
        obs = rows["obs"] if net == "conv" else rows["obs"].reshape(K, -1)
        roll = JaxTransition(obs=jnp.asarray(obs),
                             action=jnp.asarray(rows["action"]),
                             logp=None, value=None, reward=None, done=None,
                             legal=jnp.asarray(rows["legal"]))
        jnew, jm = update(jagent, roll, jnp.asarray(rows["returns"]), key)
        m = kfac.acktr_update(agent, _t(obs), _t(rows["legal"]),
                              _t(rows["action"]).to(torch.int64),
                              _t(rows["returns"]), CFG, _fisher_draws(key))
        _steps_close(agent, jnew, jagent, 1e-4)
        for k in ("value_loss", "action_loss", "entropy"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
        assert agent.kfac_actor.step == int(jnew.kfac_actor.step) == step + 1
        # Carry on from JAX's state: the next update's comparison starts
        # level, and its eigendecompositions stay those of update 0.
        jagent = jnew
        agent.load_flax_tree(jax.tree.map(
            np.array, serialization.to_state_dict(jnew)))


def test_committed_checkpoint_forward():
    """``acktr_ent05_200`` (conv towers, update 200) on 32 planes: logits
    and values to 1e-5 of the largest."""
    step, params, opt_state, _ = load_checkpoint(
        os.path.join(DATA, "acktr_ent05_200.msgpack"))
    assert step == 200 and opt_state == {}
    jagent = serialization.from_state_dict(_jax_agent("conv"), params)
    obs = _planes(32, seed=200)
    want = jacktr.make_conv_apply_fn()(jagent, jnp.asarray(obs))
    agent = kfac.acktr_conv_init(8, 64, device="cpu")
    agent.load_flax_tree(params)
    got = agent(_t(obs))
    for g, w in zip(got, want[:2]):
        _close(g.detach().numpy(), w, 1e-5, "forward")
    assert agent.kfac_actor.step == 200


def _trainer_cfgs(**kw):
    run = dict(num_envs=8, num_steps=4, num_test_games=4, seed=2, **kw)
    return jppo_trainer.SelfPlayConfig(**run), SelfPlayConfig(**run)


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_save_load_bytes_equal_jax_both_ways(net, tmp_path):
    jrun, run = _trainer_cfgs()
    jtr = jacktr.ACKTRSelfPlayTrainer(
        env_cfg=JaxEnvConfig(num_disk_as_reward=True), run_cfg=jrun,
        net=net, log_fn=lambda *a: None)
    jtr.update_count = 3
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jtr.save(str(jax_path))
    tr = ACKTRSelfPlayTrainer(run_cfg=run, net=net, log_fn=lambda *a: None,
                              device="cpu")
    tr.load(str(jax_path))
    assert tr.update_count == 3
    tr.save(str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    tr.train(1, log_every=100)
    assert tr.agent.kfac_actor.step == 1
    tr.save(str(port_path))
    jtr.load(str(port_path))
    assert jtr.update_count == 4 and int(jtr.agent.kfac_actor.step) == 1
    jtr.save(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    other = "conv" if net == "mlp" else "mlp"
    with pytest.raises(ValueError, match="ACKTR"):
        ACKTRSelfPlayTrainer(run_cfg=run, net=other,
                             device="cpu").load(str(port_path))


@pytest.mark.parametrize("field", (dict(recurrent=True),
                                   dict(frame_stack=2),
                                   dict(max_episode_plies=8)))
def test_trainer_refuses_what_jax_refuses(field):
    jrun, run = _trainer_cfgs(**field)
    with pytest.raises(ValueError) as jerr:
        jacktr.ACKTRSelfPlayTrainer(run_cfg=jrun)
    with pytest.raises(ValueError) as err:
        ACKTRSelfPlayTrainer(run_cfg=run, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_mesh_and_unknown_towers_raise():
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        ACKTRSelfPlayTrainer(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mlp"):
        ACKTRSelfPlayTrainer(net="resnet", device="cpu")


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_cli_runs_with_either_tower(net, tmp_path):
    ckpt = str(tmp_path / "acktr_{step}.msgpack")
    argv = ["--device", "cpu", "--num-envs", "8", "--num-steps", "4",
            "--num-updates", "3", "--num-test-games", "4", "--log-every",
            "1", "--save-interval", "2", "--checkpoint", ckpt, "--net", net,
            "--entropy-coef", "0.05"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = acktr_train.main(argv)
    text = out.getvalue()
    assert tr.update_count == 3 and "final eval:" in text
    assert "device: cpu; float32" in text
    assert tr.agent.conv == (net == "conv")
    assert tr.acktr_cfg.entropy_coef == 0.05
    for step in (2, 3):
        assert os.path.exists(ckpt.format(step=step))
