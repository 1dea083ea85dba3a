"""The port's PPO self-play trainer and its CLI on the CPU at a small size:
two updates give finite metrics and move the params, evaluation gives win
rates in [0, 1], the metrics logger writes JSONL, the checkpoint, pool and
chain flags work, and every feature of the JAX trainer that is not ported
yet raises (the trainer's config, the collector, and an argparse error for
the CLI flag)."""

import contextlib
import io
import json
import os

import pytest
import torch

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


@pytest.mark.parametrize("field,value", [
    ("init_rand_steps", 2), ("bf16", True), ("recurrent", True),
    ("frame_stack", 2), ("max_episode_plies", 30),
    ("lookahead_collect", True),
])
def test_trainer_rejects_unported_features(field, value):
    with pytest.raises(NotImplementedError, match=field):
        PPOSelfPlayTrainer(run_cfg=SelfPlayConfig(**{field: value}),
                           device="cpu")


def test_trainer_rejects_mesh_and_a_missing_card(monkeypatch):
    with pytest.raises(NotImplementedError):
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
                                  "--init-rand-steps=2", "--frame-stack=2",
                                  "--max-episode-plies=30",
                                  "--lookahead-collect", "--distill",
                                  "--board-size=6"])
def test_cli_rejects_unported_flags(flag):
    with pytest.raises(SystemExit) as err:
        cli.build_parser().parse_args([flag])
    assert err.value.code == 2


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
