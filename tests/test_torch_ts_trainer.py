"""The port's teacher-vs-student collector on 6x6 planes with random
openings, its trainer (``TeacherStudentTrainer``) and CLI
(``cli/teacher_vs_student.py``) against JAX's: ``collect_ts_rollout``
over five rollouts with JAX's draws injected, then one trainer chunk
(the collection and both roles' weighted PPO updates) per leaf with the
same draws and JAX's shuffle words (the helpers of
test_torch_teacher_student.py, one JAX recording for both);
``save``/``load`` byte for byte with JAX's trainer both ways; and the CLI
on the CPU."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import teacher_student as jts
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import teacher_vs_student as cli
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (load_flax_params,
                                                    policy_net_from_flax)
from gymothelloenv_tpu_torch.train import teacher_student as ts
from test_torch_teacher_student import (HIDDEN, INIT, N, T, _draws,
                                        _jax_rollouts, _ranked,
                                        check_rollout)
from torch_port_helpers import one_torch_thread  # noqa: F401

B = 6


def test_rollout_equals_jax_on_planes():
    check_rollout(B)


def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_trainer_chunk_updates_equal_jax(monkeypatch):
    """The port trainer's first chunk (6x6, lr 3e-4, entropy 0.01, 4
    epochs x 4 minibatches, the trainer's default, from the ranked params,
    with the draws of ``test_rollout_equals_jax``) collects JAX's first
    rollout; its two weighted updates, with JAX's shuffle words injected,
    against JAX's ``ppo_update`` on that rollout: both roles' parameter
    deltas per leaf within 1e-3 of the leaf's largest delta plus 1e-7
    (measured: 4.1e-5), and the metrics to 1e-4."""
    kw = dict(lr=3e-4, entropy_coef=0.01, num_updates=10, ppo_epochs=4,
              num_mini_batch=4)
    jcfg = JaxPPOConfig(**kw)
    (jnet, pt), (_, ps) = _ranked(1, B), _ranked(2, B)
    apply_fn = jtrainer.make_apply_fn(jnet)
    (jroll_t, jroll_s), _ = _jax_rollouts(B)[0][0], None
    opt = jppo.make_optimizer(jcfg)
    update = jax.jit(jppo.ppo_update, static_argnums=(5, 6, 7))
    jm, words, new = {}, [], []
    for role, params, (roll, w, boot), k in (
            ("teacher", pt, jroll_t, 1), ("student", ps, jroll_s, 2)):
        key = jax.random.PRNGKey(k)
        params2, _, m = update(params, opt.init(params), roll, boot, key,
                               apply_fn, opt, jcfg, weights=w)
        new.append(params2)
        jm.update({f"{role}_{n}": v for n, v in m.items()})
        words.append(torch.from_numpy(np.stack([
            np.asarray(jax.random.bits(kk, (4,), jnp.uint32))
            for kk in jax.random.split(key, jcfg.ppo_epochs)]).astype(
                np.int64)))
    monkeypatch.setattr(ts, "draw_words", lambda g, rows: words.pop(0))

    run = ts.TeacherStudentConfig(num_envs=N, num_steps=T,
                                  hidden_size=HIDDEN, init_rand_steps=INIT[B])
    tr = ts.TeacherStudentTrainer(
        env_cfg=EnvConfig(board_size=B, num_disk_as_reward=True),
        ppo_cfg=PPOConfig(**kw), run_cfg=run, device="cpu")
    load_flax_params(tr.net_t, pt)
    load_flax_params(tr.net_s, ps)
    tr.draws = _draws(B)
    tr.ensure_initialized()
    tr.win_avg["rand"] = 0.25            # the teacher's reward signal
    before = (_state(tr.net_t), _state(tr.net_s))
    metrics = tr.train_step()
    assert not words
    for net, params2, old in ((tr.net_t, new[0], before[0]),
                              (tr.net_s, new[1], before[1])):
        want = _state(policy_net_from_flax(params2, device="cpu"))
        for name, value in _state(net).items():
            gd = (value - old[name]).numpy()
            wd = (want[name] - old[name]).numpy()
            bound = 1e-3 * np.abs(wd).max() + 1e-7
            assert np.abs(gd - wd).max() <= bound, name
    for name, value in jm.items():
        np.testing.assert_allclose(float(metrics[name]), float(value),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(metrics["episodes"]) == 0      # no game ends in 4 slots


def test_save_load_bytes_equal_jax_both_ways(tmp_path):
    """JAX's pair of files loaded by the port and written again are the
    same files; after a port chunk, the port's pair loaded by JAX's
    trainer and written again, too."""
    run = dict(num_envs=N, num_steps=T, hidden_size=HIDDEN, seed=1)
    kw = dict(lr=3e-4, num_updates=10)
    jtr = jts.TeacherStudentTrainer(ppo_cfg=JaxPPOConfig(**kw),
                                    run_cfg=jts.TeacherStudentConfig(**run))
    jtr.chunk_count = 3
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr.save(jax_path)
    tr = ts.TeacherStudentTrainer(ppo_cfg=PPOConfig(**kw),
                                  run_cfg=ts.TeacherStudentConfig(**run),
                                  device="cpu")
    tr.load(jax_path)
    assert tr.chunk_count == 3
    tr.save(port_path)
    for role in (".teacher", ".student"):
        with open(port_path + role, "rb") as a, open(jax_path + role,
                                                     "rb") as b:
            assert a.read() == b.read(), role
    tr.train_step()
    tr.chunk_count = 4
    tr.save(port_path)
    jtr.load(port_path)
    assert jtr.chunk_count == 4
    jtr.save(jax_path)
    for role in (".teacher", ".student"):
        with open(port_path + role, "rb") as a, open(jax_path + role,
                                                     "rb") as b:
            assert a.read() == b.read(), role


def test_cli_runs_warm_starts_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--num-envs", "8", "--num-steps", "4",
            "--hidden-size", "32", "--num-test-games", "4",
            "--test-interval", "1", "--log-every", "1", "--board-size", "6",
            "--checkpoint", str(tmp_path / "ts")]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = cli.main(argv + ["--num-chunks", "2"])
    text = out.getvalue()
    assert tr.chunk_count == 2 and "final student eval:" in text
    assert "win avg(greedy)" in text and "device: cpu; float32" in text
    assert tr.teacher_reward == pytest.approx(
        sum(tr.win_avg[k] - tr.last_win_avg[k] for k in tr.win_avg))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr2 = cli.main(argv + ["--num-chunks", "1", "--load",
                               str(tmp_path / "ts"), "--teacher-load",
                               str(tmp_path / "ts.teacher"),
                               "--no-train-teacher"])
    assert tr2.chunk_count == 3 and "warm-started" in out.getvalue()
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        ts.TeacherStudentTrainer(mesh=object(), device="cpu")
