"""The port's PPO self-play trainer and its CLI on the CPU at a small size:
two updates give finite metrics and move the params, evaluation gives win
rates in [0, 1], the metrics logger writes JSONL, the checkpoint, pool and
chain flags work; the recurrent, frame-stacked, time-limited and bfloat16
trainers run through the CLI (the pool with recurrent anchors too) and
refuse what JAX's trainer refuses, with its messages; ``--board-size``
other than 8 trains on planes, where the lookahead collection raises."""

import contextlib
import io
import json
import os

import pytest
import torch

from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import ppo_self_play as cli
from gymothelloenv_tpu_torch.ops.legal_mask import legal_mask
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger
from torch_port_helpers import one_torch_thread  # noqa: F401

SMALL = dict(num_envs=16, num_steps=8, hidden_size=32, width_mult=1,
             num_test_games=8, test_interval=2)


def test_trainer_two_updates_on_cpu():
    logged = []
    trainer = PPOSelfPlayTrainer(
        ppo_cfg=PPOConfig(lr=2.5e-4, entropy_coef=0.01, num_updates=2),
        run_cfg=SelfPlayConfig(**SMALL),
        log_fn=lambda step, m: logged.append((step, m)), device="cpu")
    assert trainer.net.training
    before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
    launches = legal_mask.launches
    trainer.train(2, log_every=1)
    assert legal_mask.launches == launches      # no kernel on the CPU
    assert trainer.update_count == 2
    updates = [m for _, m in logged if "value_loss" in m]
    assert len(updates) == 2
    for m in updates:
        for key in ("value_loss", "action_loss", "entropy",
                    "transitions_per_sec", "collect_seconds",
                    "update_seconds"):
            assert torch.isfinite(torch.tensor(m[key])), key
        assert m["collect_syncs"] >= 2 * SMALL["num_steps"]
    wins = [m for step, m in logged if "win%(rand)" in m]
    assert len(wins) == 1 and 0.0 <= wins[0]["win%(greedy)"] <= 1.0
    after = trainer.net.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    rates = trainer.evaluate()
    assert set(rates) == {"rand", "greedy"}


# Each option of the last slice: with what JAX's trainer refuses in its
# company, and its message (None: it builds).
_GUARDS = {
    "bf16": ({}, None),
    "recurrent": ({"frame_stack": 2}, "recurrent and frame_stack are "
                  "mutually exclusive (both thread policy state)"),
    "frame_stack": ({"num_envs": 6}, "recurrent/frame-stack PPO needs "
                    "num_envs (6) divisible by num_mini_batch (4)"),
    "max_episode_plies": ({"recurrent": True},
                          "max_episode_plies is feed-forward only"),
}


@pytest.mark.parametrize("field,value", [
    ("bf16", True), ("recurrent", True),
    ("frame_stack", 2), ("max_episode_plies", 30),
])
def test_trainer_rejects_unported_features(field, value):
    """Formerly unported, now each option builds (bf16: a bfloat16 net
    with float32 params) or raises JAX's own guard, in its words, as the
    JAX trainer does with the same config."""
    extra, message = _GUARDS[field]
    run = dict(hidden_size=16, **{field: value}, **extra)
    if message is None:
        trainer = PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(**run),
                                     device="cpu")
        assert trainer.net.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32
                   for p in trainer.net.parameters())
        return
    with pytest.raises(ValueError) as want:
        jtrainer.PPOSelfPlayTrainer(run_cfg=jtrainer.SelfPlayConfig(**run),
                                    log_fn=lambda *a: None)
    with pytest.raises(ValueError) as got:
        PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(**run), device="cpu")
    assert str(got.value) == str(want.value) == message


def test_trainer_rejects_mesh_and_a_missing_card(monkeypatch):
    with pytest.raises(TypeError, match="mesh must be a DataMesh"):
        PPOSelfPlayTrainer(mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOSelfPlayTrainer(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOSelfPlayTrainer()


def test_cli_runs_on_cpu_and_logs_jsonl(tmp_path):
    trainer = cli.main(["--device", "cpu", "--num-envs", "16",
                        "--num-steps", "8", "--num-updates", "2",
                        "--hidden-size", "32", "--num-test-games", "4",
                        "--lr", "2.5e-4", "--entropy-coef", "0.01",
                        "--log-every", "1", "--log-dir", str(tmp_path)])
    assert trainer.update_count == 2
    assert trainer.ppo_cfg.lr == 2.5e-4
    assert trainer.optimizer.adam.param_groups[0]["lr"] < 2.5e-4
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all("transitions_per_sec" in r for r in records)


@pytest.mark.parametrize("flag", ["--bf16", "--recurrent",
                                  "--frame-stack=2",
                                  "--max-episode-plies=30",
                                  "--board-size=6"])
def test_cli_rejects_unported_flags(flag):
    """The flags of the last slices parse, with JAX's defaults when
    absent; ``--board-size 6`` parses, and the lookahead collection on
    that board takes an update."""
    if flag == "--board-size=6":
        assert cli.build_parser().parse_args([flag]).board_size == 6
        trainer = cli.main(CLI_SMALL + [flag, "--lookahead-collect",
                                        "--num-updates", "1"])
        assert trainer.update_count == 1
        assert trainer.env_cfg.board_size == 6
        return
    name, _, value = flag[2:].replace("-", "_").partition("=")
    default = vars(cli.build_parser().parse_args([]))[name]
    got = vars(cli.build_parser().parse_args([flag]))[name]
    assert default in (False, 1, 0)
    assert got == (int(value) if value else True) != default


CLI_SMALL = ["--device", "cpu", "--num-envs", "16", "--num-steps", "8",
             "--hidden-size", "32", "--num-test-games", "4",
             "--log-every", "1"]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = cli.main(CLI_SMALL + argv)
    return trainer, out.getvalue().splitlines()


def test_cli_checkpoint_then_resume(tmp_path):
    """``--checkpoint`` with ``{step}`` and ``--save-interval``, then
    ``--load`` (JAX's "resumed from" line) and ``--load --reset-opt``
    ("warm-started")."""
    pattern = str(tmp_path / "ck_{step}.msgpack")
    trainer, _ = _cli(["--num-updates", "3", "--save-interval", "2",
                       "--checkpoint", pattern])
    assert sorted(os.listdir(tmp_path)) == ["ck_2.msgpack", "ck_3.msgpack"]
    last = pattern.format(step=3)
    resumed, lines = _cli(["--num-updates", "1", "--load", last])
    assert lines[1] == f"resumed from {last} at update 3"
    assert resumed.update_count == 4
    before = [p.detach().clone() for p in trainer.net.parameters()]
    warm, lines = _cli(["--num-updates", "1", "--load", last,
                        "--reset-opt"])
    assert lines[1] == f"warm-started params from {last} (fresh optimizer)"
    assert warm.update_count == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(before, warm.net.parameters()))


def test_cli_pool_and_chain_flags(tmp_path):
    anchor = str(tmp_path / "anchor.msgpack")
    _cli(["--num-updates", "1", "--checkpoint", anchor])
    trainer, _ = _cli(["--num-updates", "3", "--opponent-pool", "2",
                       "--pool-interval", "1", "--pool-anchor", anchor,
                       "--pool-anchors", anchor])
    assert len(trainer.anchors) == 2 and len(trainer.pool) == 2
    assert trainer.run_cfg.pool_interval == 1
    trainer, lines = _cli(["--num-updates", "3", "--chain-updates", "2"])
    assert trainer.update_count == 4
    assert [line.split()[1] for line in lines
            if line.startswith("[update")] == ["2]", "4]"]


@pytest.mark.parametrize("flags", [["--recurrent"], ["--frame-stack", "4"],
                                   ["--max-episode-plies", "8"],
                                   ["--bf16"]])
def test_cli_state_paths_run_on_cpu(flags):
    """The acceptance commands (N 16, T 8, 2 updates, hidden 32): finite
    losses, the path's collector (truncations with the time limit), an
    evaluation, and under ``--bf16`` the first line's precision."""
    trainer, lines = _cli(["--num-updates", "2"] + flags)
    assert trainer.update_count == 2
    updates = [line for line in lines if line.startswith("[update")]
    assert len(updates) == 2
    for line in updates:
        metrics = dict(kv.split("=") for kv in line.split()[2:])
        for key in ("value_loss", "action_loss", "entropy"):
            assert torch.isfinite(torch.tensor(float(metrics[key]))), key
        assert ("truncations" in metrics) == ("--max-episode-plies" in flags)
    assert lines[-1].startswith("final eval:")
    if flags == ["--bf16"]:
        assert lines[0] == ("device: cpu; bfloat16 net compute, float32 "
                            "parameters; TF32 off for matmul and cuDNN in "
                            "the float32 parts")
    else:
        assert lines[0] == "device: cpu; float32, TF32 off for matmul and cuDNN"
    assert trainer.policy.recurrent == (flags[0] in ("--recurrent",
                                                     "--frame-stack"))


def test_cli_recurrent_with_frame_stack_fails_with_jax_message():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _cli(["--num-updates", "1", "--recurrent", "--frame-stack", "2"])


def test_recurrent_pool_and_anchors(tmp_path):
    """A recurrent run with an opponent pool: a recurrent anchor joins the
    draw and the pool holds frozen recurrent snapshots; a feed-forward
    anchor does not fit the recurrent net and raises JAX's message."""
    rec, ff = str(tmp_path / "rec.msgpack"), str(tmp_path / "ff.msgpack")
    _cli(["--num-updates", "1", "--recurrent", "--checkpoint", rec])
    _cli(["--num-updates", "1", "--checkpoint", ff])
    trainer, _ = _cli(["--num-updates", "2", "--recurrent",
                       "--opponent-pool", "2", "--pool-interval", "1",
                       "--pool-anchor", rec])
    assert len(trainer.anchors) == 1 and len(trainer.pool) == 2
    for opp in trainer.anchors + trainer.pool:
        assert opp.recurrent and not any(p.requires_grad
                                         for p in opp.parameters())
    with pytest.raises(ValueError, match="does not match the training net "
                       "architecture"):
        _cli(["--num-updates", "1", "--recurrent", "--opponent-pool", "2",
              "--pool-anchor", ff])


@pytest.mark.parametrize("run", [dict(opponent_pool=2, pool_interval=0),
                                 dict(pool_anchors=("a.msgpack",)),
                                 dict(opponent_pool=2, chain_updates=2)])
def test_trainer_rejects_bad_pool_settings(run):
    with pytest.raises(ValueError):
        PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(**run), device="cpu")


def test_metrics_logger_appends(tmp_path):
    with MetricsLogger(str(tmp_path), also_print=False) as log:
        log.log(1, {"a": 1.5})
    with MetricsLogger(str(tmp_path), also_print=False) as log:
        log.log(2, {"a": 2.5})
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["a"] for x in lines] == [1.5, 2.5]
