"""The port's entry points compute the net in float32: each one that runs
the net switches TF32 off for matmuls and cuDNN convolutions
(``utils.device.use_float32``), whatever the flags were before.  The flags
are process-wide, so every test starts from both on and restores them."""

import contextlib
import io
import os

import pytest
import torch

from gymothelloenv_tpu_torch.cli import eval_checkpoint
from gymothelloenv_tpu_torch.cli import ppo_self_play as cli
from gymothelloenv_tpu_torch.models.nets import make_policy_net
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.tournament import net_tournament_policy
from gymothelloenv_tpu_torch.utils.device import FLOAT32, use_float32
from torch_port_helpers import one_torch_thread  # noqa: F401

REC2000 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "selfplay",
    "ppo_recurrent_2000.msgpack")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    before = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        before


def test_use_float32_turns_both_flags_off(tf32_on):
    assert _flags() == (True, True)
    assert use_float32() == FLOAT32 == "float32, TF32 off for matmul and cuDNN"
    assert _flags() == (False, False)


def test_cli_leaves_tf32_off_and_prints_the_fp32_line(tf32_on):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", "--num-envs", "4", "--num-steps", "2",
                  "--num-updates", "1", "--hidden-size", "8",
                  "--num-test-games", "2", "--log-every", "1"])
    assert _flags() == (False, False)
    first = out.getvalue().splitlines()[0]
    assert first == f"device: cpu; {FLOAT32}"


def test_trainer_constructor_leaves_tf32_off(tf32_on):
    PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(num_envs=4, num_steps=2,
                                              hidden_size=8),
                       device="cpu")
    assert _flags() == (False, False)


def test_net_tournament_policy_leaves_tf32_off(tf32_on):
    net_tournament_policy(make_policy_net(1, 8, seed=0, device="cpu"))
    assert _flags() == (False, False)


def test_stateful_eval_checkpoint_leaves_tf32_off(tf32_on):
    """F2: the recurrent checkpoint through ``eval_checkpoint`` (its
    stateful path, ``load_eval_policy`` -> ``play_games_recurrent`` ->
    ``net_sampling_cell``) leaves both flags off."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_checkpoint.main(["--load", REC2000, "--opponent", "greedy",
                              "--games", "2", "--device", "cpu"])
    assert "recurrent" in out.getvalue().splitlines()[0]
    assert _flags() == (False, False)


WIDE2 = os.path.join(os.path.dirname(REC2000), "ppo_wide2_4k.msgpack")


@pytest.mark.parametrize("entry", ["replay", "enjoy"])
def test_replay_and_enjoy_leave_tf32_off(tf32_on, entry, tmp_path):
    """The replay and enjoy CLIs load their nets through
    ``load_eval_policy``, which switches TF32 off."""
    from gymothelloenv_tpu_torch.cli import enjoy, replay
    with contextlib.redirect_stdout(io.StringIO()):
        if entry == "replay":
            replay.main(["--black", f"net:{WIDE2}", "--white", "greedy",
                         "--device", "cpu", "--deterministic",
                         "--out", str(tmp_path / "r.html")])
        else:
            enjoy.main(["--load", WIDE2, "--device", "cpu",
                        "--deterministic"])
    assert _flags() == (False, False)


def test_mesh_trainer_leaves_tf32_off(tf32_on):
    """Each rank's trainer under a mesh switches TF32 off as the
    single-process one does."""
    from gymothelloenv_tpu_torch.parallel import make_mesh
    PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(num_envs=4, num_steps=2,
                                              hidden_size=8),
                       mesh=make_mesh(backend="gloo", device="cpu"))
    assert _flags() == (False, False)


def test_sharded_train_step_leaves_tf32_off(tf32_on):
    """``parallel.dp.make_sharded_train_step`` builds no trainer, and
    switches TF32 off itself."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.parallel import make_mesh
    from gymothelloenv_tpu_torch.parallel.dp import make_sharded_train_step
    make_sharded_train_step(make_mesh(backend="gloo", device="cpu"),
                            EnvConfig(), PPOConfig(), 2)
    assert _flags() == (False, False)

