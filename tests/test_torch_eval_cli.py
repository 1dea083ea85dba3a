"""The port's ``eval_checkpoint`` and ``tournament`` CLIs on the CPU, and
``load_eval_policy`` against JAX's.

A tiny port-written checkpoint plays rand, greedy, maximin-1 and itself
(``ckpt:``) with JAX's printed lines; the tournament prints its rows and
table; ``load_eval_policy`` gives JAX's description and knobs for the
committed wide2 checkpoint, and its net's forward agrees with JAX's
``apply`` to 1e-5; recurrent and frame-stacked checkpoints load with JAX's
descriptions and play every recurrent branch of the CLI (raw and armed at
depth 1, as protagonist and as ``ckpt:`` opponent, the roles swapped for
a feed-forward protagonist), with JAX's refusals; ``.pth`` checkpoints
and other board sizes are refused."""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.cli import eval_checkpoint, tournament
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.engine import PlaneEngine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.scripts import ladder
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig,
                                                       load_eval_policy,
                                                       make_network,
                                                       net_lookahead_policy)
from gymothelloenv_tpu_torch.utils import checkpoint as ck
from torch_port_helpers import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "selfplay")
WIDE2 = os.path.join(DATA, "ppo_wide2_4k.msgpack")
RECURRENT = os.path.join(DATA, "ppo_recurrent_2000.msgpack")
RESULT = re.compile(
    r"^checkpoint vs (\S+): (\d+) / (\d+) / (\d+) \(W/D/L over (\d+) games, "
    r"half each color\)  win%=(\d\.\d{3})  \[\d+\.\ds\]$")


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    trainer = PPOSelfPlayTrainer(
        ppo_cfg=PPOConfig(num_updates=1),
        run_cfg=SelfPlayConfig(num_envs=8, num_steps=4, hidden_size=32),
        log_fn=lambda *a: None, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.msgpack")
    trainer.save(path)
    return path


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue().splitlines()


@pytest.mark.parametrize("opponent", ["rand", "greedy", "maximin-1",
                                      "ckpt"])
def test_eval_checkpoint_lines(tiny_ckpt, opponent):
    spec = f"ckpt:{tiny_ckpt}" if opponent == "ckpt" else opponent
    (w, d, l), lines = _run(eval_checkpoint.main, [
        "--device", "cpu", "--load", tiny_ckpt, "--opponent", spec,
        "--games", "9", "--init-rand-steps", "4", "--seed", "1"])
    assert lines[0] == (f"loaded {tiny_ckpt} (step 0, width_mult=1, "
                        "hidden=32)")
    if opponent == "ckpt":
        assert lines[1] == (f"opponent checkpoint {tiny_ckpt} (step 0, "
                            "width_mult=1, hidden=32)")
    m = RESULT.match(lines[-1])
    assert m, lines[-1]
    assert m.group(1) == spec and m.group(5) == "8"
    assert (int(m.group(2)), int(m.group(3)), int(m.group(4))) == (w, d, l)
    assert w + d + l == 8
    assert float(m.group(6)) == pytest.approx(w / 8, abs=5e-4)


def test_eval_checkpoint_same_seed_same_games(tiny_ckpt):
    argv = ["--device", "cpu", "--load", tiny_ckpt, "--opponent",
            "maximin-1", "--games", "12", "--seed", "3"]
    assert _run(eval_checkpoint.main, argv)[0] == \
        _run(eval_checkpoint.main, argv + ["--expand-chunk", "2"])[0]


@pytest.mark.parametrize("flag", ["--board-size=6"])
def test_eval_checkpoint_refuses_unported_flags(flag, tiny_ckpt):
    """``--board-size 6`` parses; the value-lookahead search runs on that
    board (on planes) and plays legal moves at depths 1, 2 and beam-3;
    and an 8x8 checkpoint on a 6x6 board is refused."""
    args = eval_checkpoint.build_parser().parse_args(["--load", "x.msgpack",
                                                      flag])
    assert args.board_size == 6
    cfg6 = EnvConfig(board_size=6, num_disk_as_reward=True)
    net = make_network(cfg6, hidden_size=32, seed=1, device="cpu").eval()
    states = core.reset(cfg6, 5, "cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):
        states = core.step(states, PlaneEngine().random_legal(
            states, generator=gen), cfg6).state
    for depth in (1, 2, 3):
        act = net_lookahead_policy(net, cfg6, depth=depth, beam_k=3)(states)
        assert act.shape == (5,)
        live = ~states.terminated
        assert bool(states.legal[torch.arange(5), act][live].all()), depth
    with pytest.raises(ValueError, match="8x8 board"):
        eval_checkpoint.main(["--device", "cpu", "--load", tiny_ckpt, flag])


def test_tournament_pairing_and_round_robin():
    results, lines = _run(tournament.main, [
        "--device", "cpu", "--black", "greedy", "--white", "maximin-1",
        "--games", "6", "--init-rand-steps", "4"])
    assert re.match(r"^    greedy \(B\) vs maximin-1  \(W\):  +\d+ / +\d+ / "
                    r"+\d+   \[ *\d+\.\d\ds\]$", lines[0]), lines[0]
    assert sum(results[("greedy", "maximin-1")]) == 6
    results, lines = _run(tournament.main, [
        "--device", "cpu", "--lineup", "rand,greedy,maximin-2", "--games",
        "4", "--expand-chunk", "3"])
    assert len(results) == 9 and all(sum(v) == 4 for v in results.values())
    assert lines[9] == "" and lines[10].split() == ["rand", "greedy",
                                                    "maximin-2"]
    for line, black in zip(lines[11:], ("rand", "greedy", "maximin-2")):
        cells = line.split()
        assert cells[0] == black and len(cells) == 4
    with pytest.raises(ValueError, match="unknown scripted policy"):
        tournament.policy_from_spec("minimax-2")


def test_load_eval_policy_matches_jax():
    if not os.path.isfile(WIDE2):
        pytest.skip(f"checkpoint not in this checkout: {WIDE2}")
    net, desc = load_eval_policy(WIDE2, device="cpu")
    params, apply_fn, jdesc = jtrainer.load_eval_policy(WIDE2,
                                                        JaxEnvConfig())
    assert desc == jdesc == "step 4000, width_mult=2, hidden=1024"
    assert net.trunk.conv0.out_channels == 64 and net.fc.out_features == 1024
    x = np.random.RandomState(0).rand(16, 4, 8, 8).astype(np.float32)
    want_logits, want_value, _ = apply_fn(params, jnp.asarray(x))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=1e-5, rtol=1e-5)


def test_load_eval_policy_refusals(tmp_path):
    """``.pth``/``.pt`` stay refused (queue 1 item 12); the committed
    recurrent checkpoint and a frame-stack-2 one now load, with JAX's
    descriptions, as a recurrent net and a frame-stack cell."""
    with pytest.raises(NotImplementedError, match="item 12"):
        load_eval_policy(str(tmp_path / "ref.pth"), device="cpu")
    if os.path.isfile(RECURRENT):
        net, desc = load_eval_policy(RECURRENT, device="cpu")
        assert desc == "step 2000, recurrent"
        assert net.recurrent and net.hidden_size == 512
    path = _stateful_ckpt(tmp_path, frame_stack=2)
    cell, desc = load_eval_policy(path, device="cpu")
    assert desc == jtrainer.load_eval_policy(path, JaxEnvConfig())[2] == (
        "step 0, width_mult=1, hidden=32, frame_stack=2")
    assert cell.recurrent and cell.nstack == 2 and cell.hidden_size == 256
    assert cell.net.trunk.conv0.in_channels == 8


def _stateful_ckpt(tmp_path, **run):
    trainer = PPOSelfPlayTrainer(
        ppo_cfg=PPOConfig(num_updates=1),
        run_cfg=SelfPlayConfig(num_envs=8, num_steps=4, hidden_size=32,
                               **run),
        log_fn=lambda *a: None, device="cpu")
    path = str(tmp_path / ("_".join(f"{k}{v}" for k, v in run.items())
                           + ".msgpack"))
    trainer.save(path)
    return path


@pytest.mark.parametrize("case", ["raw", "lookahead", "self-armed",
                                  "ff-vs-recurrent", "framestack"])
def test_eval_checkpoint_recurrent_branches(tmp_path, tiny_ckpt, case):
    """JAX's branches (eval_checkpoint.py:150-210) on tiny checkpoints: a
    recurrent protagonist raw or with ``--lookahead`` (depth 1), against
    itself as a ``ckpt:`` opponent armed at depth 1, a feed-forward
    protagonist against the recurrent opponent (the roles swapped), and a
    frame-stacked protagonist; each prints JAX's lines and plays every
    game."""
    rec = _stateful_ckpt(tmp_path, recurrent=True)
    load, opp, flags = {
        "raw": (rec, "greedy", []),
        "lookahead": (rec, "rand", ["--lookahead"]),
        "self-armed": (rec, f"ckpt:{rec}", ["--opp-lookahead-depth", "1"]),
        "ff-vs-recurrent": (tiny_ckpt, f"ckpt:{rec}", []),
        "framestack": (_stateful_ckpt(tmp_path, frame_stack=3), "greedy",
                       []),
    }[case]
    (w, d, l), lines = _run(eval_checkpoint.main, [
        "--device", "cpu", "--load", load, "--opponent", opp, *flags,
        "--games", "6", "--init-rand-steps", "4", "--seed", "2"])
    assert w + d + l == 6
    m = RESULT.match(lines[-1])
    assert m and m.group(1) == opp, lines[-1]
    assert (int(m.group(2)), int(m.group(3)), int(m.group(4))) == (w, d, l)
    if opp.startswith("ckpt:"):
        assert lines[1].endswith("(step 0, width_mult=1, hidden=32, "
                                 "recurrent)")


def test_eval_checkpoint_recurrent_refusals(tmp_path):
    """A recurrent opponent armed deeper than 1 is a ``parser.error``; a
    recurrent protagonist at ``--lookahead-depth 2`` raises the cell's
    ``NotImplementedError`` (JAX eval_checkpoint.py:107-108,
    ppo_trainer.py:226-229)."""
    rec = _stateful_ckpt(tmp_path, recurrent=True)
    with pytest.raises(SystemExit) as err:
        _run(eval_checkpoint.main, [
            "--device", "cpu", "--load", rec, "--opponent", f"ckpt:{rec}",
            "--opp-lookahead-depth", "2", "--games", "2"])
    assert err.value.code == 2
    with pytest.raises(NotImplementedError, match="depth 1 only"):
        _run(eval_checkpoint.main, [
            "--device", "cpu", "--load", rec, "--lookahead-depth", "2",
            "--games", "2"])


def test_port_checkpoint_loads_in_jax_eval_loader(tmp_path):
    """A port checkpoint gets the same description from both loaders."""
    trainer = PPOSelfPlayTrainer(
        run_cfg=SelfPlayConfig(num_envs=8, num_steps=4, hidden_size=48,
                               width_mult=2),
        log_fn=lambda *a: None, device="cpu")
    path = str(tmp_path / "wide.msgpack")
    trainer.save(path)
    _, _, jdesc = jtrainer.load_eval_policy(path, JaxEnvConfig())
    _, desc = load_eval_policy(path, device="cpu")
    assert desc == jdesc == "step 0, width_mult=2, hidden=48"


def test_ladder_two_proportion_test():
    """The pooled z-test of scripts/ladder.py on hand-worked cases: equal
    rates give z 0 and p 1; 700/1000 against 291/400 gives z -1.0222 and
    p 0.3067 (scipy.stats.norm.sf, two-sided)."""
    assert ladder.two_proportion(291, 400, 291, 400) == (0.0, 1.0)
    z, p = ladder.two_proportion(700, 1000, 291, 400)
    assert z == pytest.approx(-1.0221819930820653, rel=1e-12)
    assert p == pytest.approx(0.3066947717413323, rel=1e-9)
    assert [c[1] for c in ladder.CELLS] == [
        "maximin-2", "maximin-2", f"ckpt:{ladder.WIDE2_4K}", "maximin-2",
        "maximin-2", "maximin-2", f"ckpt:{ladder.WIDE2_4K}", "maximin-2",
        "maximin-2", f"ckpt:{ladder.REC2000}", "maximin-2",
        f"ckpt:{ladder.WIDE2_4K}"]
    assert [c[3:5] for c in ladder.CELLS[3:]] == [
        (963, 1000), (991, 1000), (993, 1000), (891, 1000), (289, 400),
        (271, 400), (114, 400), (271, 400), (322, 400)]
    assert [c[0] for c in ladder.CELLS[7:]] == [
        ladder.REC2000, ladder.REC_WIDE2, ladder.LA3500, ladder.TS_STUDENT,
        ladder.TS_STUDENT]
