"""The three CLIs on boards other than 8, on the CPU at a small size:
``ppo_self_play --board-size 6`` (feed-forward with the opponent pool or
chained updates, recurrent, frame-stacked) writes checkpoints that
``eval_checkpoint --board-size 6`` plays against scripted opponents,
and ``tournament --board-size 10`` plays every game to its end."""

import contextlib
import io
import re

import pytest

from gymothelloenv_tpu_torch.cli import eval_checkpoint, tournament
from gymothelloenv_tpu_torch.cli import ppo_self_play as cli
from gymothelloenv_tpu_torch.core.state import OthelloState
from torch_port_helpers import one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--num-envs", "8", "--num-steps", "6",
         "--num-updates", "2", "--hidden-size", "16", "--num-test-games",
         "4", "--log-every", "1", "--board-size", "6"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def board6_ckpts(tmp_path_factory):
    """A feed-forward and a recurrent 6x6 checkpoint from the CLI."""
    root = tmp_path_factory.mktemp("b6")
    paths = {}
    for kind, extra in (("ff", ["--opponent-pool", "2", "--pool-interval",
                                "1"]),
                        ("rec", ["--recurrent", "--num-mini-batch", "2"])):
        paths[kind] = str(root / f"{kind}.msgpack")
        trainer, lines = _run(cli.main, SMALL + extra + [
            "--checkpoint", paths[kind]])
        assert trainer.update_count == 2
        assert isinstance(trainer.sp_state.env, OthelloState)
        assert trainer.sp_state.pending.obs.shape[-2:] == (6, 6)
        assert trainer.sp_state.pending.legal.shape[-1] == 36
        assert lines[-1].startswith("final eval:")
    return paths


@pytest.mark.parametrize("extra", (["--chain-updates", "2"],
                                   ["--frame-stack", "2",
                                    "--num-mini-batch", "2"]))
def test_ppo_self_play_board6(extra):
    trainer, lines = _run(cli.main, SMALL + extra)
    assert trainer.update_count == 2
    assert trainer.net.logits.out_features == 36
    assert any("value_loss=" in line for line in lines)


@pytest.mark.parametrize("kind,opponent", (("ff", "maximin-1"),
                                           ("rec", "greedy")))
def test_eval_checkpoint_board6(board6_ckpts, kind, opponent):
    (w, d, l), lines = _run(eval_checkpoint.main, [
        "--device", "cpu", "--board-size", "6", "--load", board6_ckpts[kind],
        "--opponent", opponent, "--games", "6", "--seed", "2"])
    assert w + d + l == 6
    assert re.search(r"W/D/L over 6 games", lines[-1]), lines[-1]


def test_tournament_board10():
    results, lines = _run(tournament.main, [
        "--device", "cpu", "--board-size", "10", "--lineup",
        "rand,greedy,maximin-1", "--games", "3", "--init-rand-steps", "4"])
    assert len(results) == 9 and all(sum(v) == 3 for v in results.values())
    assert lines[10].split() == ["rand", "greedy", "maximin-1"]
