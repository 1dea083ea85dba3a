"""The port's GAIL agent (``agents/gail.py``) and expert-data script
(``scripts/make_expert_dataset.py``) against JAX's: the discriminator's
forward, ``RunningMeanStd`` and ``gail_predict_reward`` over a few steps
(1e-6), one ``gail_discriminator_update`` with JAX's mixup ``alpha``
injected (the penalty's double backward; each parameter's step within
1e-5 of the leaf's largest), ``ExpertDataset`` rows and samples exactly
from an npz and from an h5 written with ``h5py``, the h5 branch's
``ImportError`` without ``h5py``, the script's npz equal to JAX's for a
few games at depth 1, the committed ``gail_bc_clean_3k`` policy's
forward (1e-5), and ``scripts/family_strength.py``'s GAIL and simple-PPO
families rehearsed on the CPU."""

import builtins
import contextlib
import functools
import io
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import gail as jgail
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import ppo_trainer as jppo_trainer
from gymothelloenv_tpu_torch.agents import gail
from gymothelloenv_tpu_torch.models.convert import load_flax_params
from gymothelloenv_tpu_torch.scripts import make_expert_dataset
from gymothelloenv_tpu_torch.train.ppo_trainer import load_eval_policy
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
GAIL_BC = os.path.join(ROOT, "data", "selfplay", "gail_bc_clean_3k.msgpack")
D, M, N = 40, 16, 6      # input width, batch rows, envs


@functools.cache
def _jax_state(seed=0):
    cfg = jgail.GAILConfig(hidden_dim=24)
    return cfg, jgail.gail_init(cfg, D, N, jax.random.PRNGKey(seed))


def _port_state(jstate, cfg):
    st = gail.gail_init(gail.GAILConfig(hidden_dim=cfg.hidden_dim), D, N,
                        device="cpu")
    load_flax_params(st.net, jax.tree.map(np.array, jstate.params))
    return st


def _sa(seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(2, M, D) < 0.4).astype(np.float32)
    return x[0], x[1]


def test_discriminator_forward_and_init_equal_flax():
    cfg, js = _jax_state()
    st = _port_state(js, cfg)
    x = np.random.RandomState(1).randn(9, D).astype(np.float32)
    want = np.asarray(jgail.Discriminator(cfg.hidden_dim).apply(js.params,
                                                                x))
    with torch.no_grad():
        got = st.net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # flax Dense's init: lecun-normal kernels, zero biases.
    w = gail.gail_init(gail.GAILConfig(), 300, 4, seed=3,
                       device="cpu").net.fc0.weight
    assert abs(float(w.std()) - (1 / 300) ** 0.5) < 0.05 * (1 / 300) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 300) ** 0.5 / .8796 + 1e-6


def test_running_moments_and_rewards_equal_jax():
    """Four relabel steps with masks and a non-zero accumulator: rewards,
    the accumulator and the running moments within 1e-6."""
    cfg, js = _jax_state()
    st = _port_state(js, cfg)
    rng = np.random.RandomState(2)
    sa = (rng.rand(4, N, D) < 0.4).astype(np.float32)
    masks = (rng.rand(4, N) < 0.7).astype(np.float32)
    js = js.replace(returns=jnp.full((N,), 3.0))
    st.returns = torch.full((N,), 3.0)
    step = jax.jit(lambda s, x, m: jgail.gail_predict_reward(s, cfg, x, m))
    for t in range(4):
        js, want = step(js, sa[t], masks[t])
        st, got = gail.gail_predict_reward(st, cfg, torch.from_numpy(sa[t]),
                                           torch.from_numpy(masks[t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    for got, want in ((st.returns, js.returns),
                      (st.ret_rms.mean, js.ret_rms.mean),
                      (st.ret_rms.var, js.ret_rms.var),
                      (st.ret_rms.count, js.ret_rms.count)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert st.ret_rms.count.dtype == torch.float32
    _, frozen = gail.gail_predict_reward(st, cfg, torch.from_numpy(sa[0]),
                                         torch.ones(N), update_rms=False)
    assert frozen.shape == (N,)


def test_discriminator_update_equals_jax_with_its_alpha():
    """One step from the same params on the same rows, JAX's ``alpha``
    injected: the loss to rtol 1e-6, each parameter's Adam step within
    1e-5 of the leaf's largest plus one float32 spacing of the parameter
    (the gradient flows through the input gradient of the penalty: a
    double backward)."""
    cfg, js = _jax_state()
    st = _port_state(js, cfg)
    e, p = _sa(3)
    key = jax.random.PRNGKey(4)
    alpha = np.asarray(jax.random.uniform(key, (M, 1)))[:, 0]
    new, jloss = jax.jit(lambda s: jgail.gail_discriminator_update(
        s, cfg, jnp.asarray(e), jnp.asarray(p), key))(js)
    start = {k: v.clone() for k, v in st.net.state_dict().items()}
    from gymothelloenv_tpu_torch.train.self_play import InjectedDraws
    draws = InjectedDraws((), (), mix_uniforms=[torch.from_numpy(alpha)])
    st, loss = gail.gail_discriminator_update(st, cfg, torch.from_numpy(e),
                                              torch.from_numpy(p), draws)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    want = gail.Discriminator(D, cfg.hidden_dim)
    load_flax_params(want, jax.tree.map(np.array, new.params))
    for k, w in want.state_dict().items():
        wd = w - start[k]
        gd = st.net.state_dict()[k] - start[k]
        big = float(wd.abs().max())
        assert big > 0, k
        # Plus one float32 spacing of the parameter, which each side's
        # p + u rounds to.
        assert bool(((gd - wd).abs() <= 1e-5 * big
                     + 2.0 ** -23 * w.abs()).all()), k
    # Without the penalty's graph the update would differ.
    no_gp = gail.GAILConfig(hidden_dim=cfg.hidden_dim, grad_pen_lambda=0.0)
    st2 = _port_state(js, cfg)
    gp = (gail.discriminator_loss(st2.net, cfg, torch.from_numpy(e),
                                  torch.from_numpy(p), torch.from_numpy(alpha))
          - gail.discriminator_loss(st2.net, no_gp, torch.from_numpy(e),
                                    torch.from_numpy(p),
                                    torch.from_numpy(alpha)))
    assert float(gp.detach()) > 0


def _trajectories(tmp_path):
    rng = np.random.RandomState(3)
    k, t, d = 7, 30, 6
    states = rng.randn(k, t, d).astype(np.float32)
    actions = rng.randint(0, 64, (k, t)).astype(np.int64)
    lengths = rng.randint(10, t + 1, k).astype(np.int64)
    npz = str(tmp_path / "trajs.npz")
    np.savez(npz, states=states, actions=actions, lengths=lengths)
    return npz, states, actions, lengths


@pytest.mark.parametrize("seed", [0, 5])
def test_expert_dataset_rows_and_samples_equal_jax(tmp_path, seed):
    npz = _trajectories(tmp_path)[0]
    want = jgail.ExpertDataset(npz, num_trajectories=4,
                               subsample_frequency=3, seed=seed)
    got = gail.ExpertDataset(npz, num_trajectories=4, subsample_frequency=3,
                             seed=seed)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.states, want.states)
    np.testing.assert_array_equal(got.actions, want.actions)
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(3):
        for a, b in zip(got.sample(r1, 5), want.sample(r2, 5)):
            np.testing.assert_array_equal(a, b)


def test_expert_dataset_reads_h5_like_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    _, states, actions, lengths = _trajectories(tmp_path)
    h5 = str(tmp_path / "trajs.h5")
    with h5py.File(h5, "w") as f:
        f["obs_B_T_Do"] = states
        f["a_B_T_Da"] = actions
        f["len_B"] = lengths
    want = jgail.ExpertDataset(h5, num_trajectories=5, subsample_frequency=2)
    got = gail.ExpertDataset(h5, num_trajectories=5, subsample_frequency=2)
    np.testing.assert_array_equal(got.states, want.states)
    np.testing.assert_array_equal(got.actions, want.actions)


def test_h5_without_h5py_raises_naming_it(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        gail.ExpertDataset(str(tmp_path / "x.h5"))


@pytest.mark.parametrize("openings", [False, True])
def test_expert_script_npz_equals_jax(tmp_path, openings):
    """Three maximin-1 games (random openings of up to 10 plies from
    ``RandomState(3)``): the port's npz equals JAX's array for array."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_expert", os.path.join(ROOT, "scripts",
                                        "make_expert_dataset.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    argv = ["--games", "3", "--search-depth", "1", "--seed", "3"]
    argv += ["--include-openings"] if openings else []
    jscript.main(argv + ["--out", str(tmp_path / "jax.npz")])
    make_expert_dataset.main(argv + ["--device", "cpu", "--out",
                                     str(tmp_path / "port.npz")])
    want, got = (np.load(tmp_path / f"{n}.npz") for n in ("jax", "port"))
    for k in ("states", "actions", "lengths"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["lengths"].sum()) > 100


def test_gail_bc_checkpoint_forward_equals_jax():
    if not os.path.isfile(GAIL_BC):
        pytest.skip(f"checkpoint not in this checkout: {GAIL_BC}")
    net, desc = load_eval_policy(GAIL_BC, device="cpu")
    params, apply_fn, jdesc = jppo_trainer.load_eval_policy(GAIL_BC,
                                                            JaxEnvConfig())
    assert desc == jdesc
    x = (np.random.RandomState(0).rand(16, 4, 8, 8) < 0.4).astype(
        np.float32)
    want_logits, want_value, _ = apply_fn(params, jnp.asarray(x))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", ["gail", "gail_only", "simple_ppo"])
def test_family_strength_rehearses_on_the_cpu(tmp_path, monkeypatch, family):
    """``scripts/family_strength.py --chunks 1 --num-envs 8 --device cpu
    --bc-updates 2`` with 8 games a reading, the GAIL families on a
    two-game expert file: their rows read against JAX's job 12 (BC and
    final); simple PPO's carry no JAX figure."""
    from gymothelloenv_tpu_torch.scripts import family_strength as fs
    monkeypatch.setattr(fs, "GAIL_GAMES", 8)
    expert = str(tmp_path / "expert.npz")
    if family != "simple_ppo":          # a small file in place of 256 games
        with contextlib.redirect_stdout(io.StringIO()):
            make_expert_dataset.main(["--games", "2", "--search-depth", "1",
                                      "--device", "cpu", "--out", expert])
    with contextlib.redirect_stdout(io.StringIO()):
        rows = fs.main(["--family", family, "--chunks", "1", "--num-envs",
                        "8", "--device", "cpu", "--expert", expert,
                        "--bc-updates", "2"])
    readings = ["bc", "bc", "final", "final"] if family == "gail" else [
        "final", "final"]
    assert [r["reading"] for r in rows] == readings
    for r in rows:
        assert r["games"] == 8 and 0 <= r["wins"] <= 8
        want = (fs.JAX_BC if r["reading"] == "bc"
                else fs.JAX[family])[r["opponent"]]
        if family == "simple_ppo":
            assert want is None and "p" not in r
        else:
            assert (r["jax_wins"], r["jax_games"]) == want
            assert 0.0 <= r["p"] <= 1.0 and r["seed"] == 41
