"""The port's ``cli/replay.py`` and ``cli/enjoy.py`` against JAX's on the
CPU.

Deterministic players only, since the two packages' seeded random draws
differ: greedy, maximin-k and a net playing its mode.  JAX's replay has no
deterministic net player, so its ``MaskedCategorical.sample`` is patched
to return the mode while it runs.  The replay's HTML page (frames,
captions, title) equals JAX's byte for byte; the enjoy transcript (every
printed line) equals JAX's, for the wide2 net and a recurrent one.
Random players are checked for legality and the game's accounting."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from gymothelloenv_tpu.cli import enjoy as jenjoy
from gymothelloenv_tpu.cli import replay as jreplay
from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu_torch.cli import enjoy, replay
from gymothelloenv_tpu_torch.core.state import EnvConfig
from torch_port_helpers import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "selfplay")
WIDE2 = os.path.join(DATA, "ppo_wide2_4k.msgpack")
REC = os.path.join(DATA, "ppo_recurrent_2000.msgpack")


@contextlib.contextmanager
def _jax_mode_sampling():
    real = jdist.MaskedCategorical.sample
    jdist.MaskedCategorical.sample = lambda self, key: self.mode()
    try:
        yield
    finally:
        jdist.MaskedCategorical.sample = real


def _frames_json(page: str):
    return json.loads(re.search(r"const frames = (.*);\n", page).group(1))


@pytest.mark.parametrize("black,white", [
    ("greedy", "maximin-2"),
    (f"net:{WIDE2}", "maximin-1"),
], ids=["greedy-maximin2", "wide2-maximin1"])
def test_replay_page_equals_jax(black, white, tmp_path):
    """The whole HTML page, and so every frame's SVG and caption, equals
    JAX's; the port plays with ``--deterministic``."""
    jax_out, port_out = tmp_path / "jax.html", tmp_path / "port.html"
    argv = ["--black", black, "--white", white, "--seed", "3"]
    with contextlib.redirect_stdout(io.StringIO()) as jtext, \
            _jax_mode_sampling():
        jreplay.main(argv + ["--out", str(jax_out)])
    with contextlib.redirect_stdout(io.StringIO()) as text:
        frames = replay.main(argv + ["--out", str(port_out), "--device",
                                     "cpu", "--deterministic"])
    page, jpage = port_out.read_text(), jax_out.read_text()
    assert _frames_json(page) == _frames_json(jpage)
    assert page == jpage
    assert text.getvalue() == jtext.getvalue().replace(str(jax_out),
                                                       str(port_out))
    assert frames[-1][3].startswith("final: ")


def test_replay_random_players_are_legal_and_counted(tmp_path):
    """rand vs rand with random openings: every move is legal in its
    frame, the final caption's disk counts are the last board's, and the
    game ran to its end."""
    out = tmp_path / "r.html"
    with contextlib.redirect_stdout(io.StringIO()):
        frames = replay.main(["--black", "rand", "--white", "rand",
                              "--init-rand-steps", "6", "--seed", "5",
                              "--out", str(out), "--device", "cpu"])
    moves = frames[:-1]
    assert len(moves) >= 9 and any("random opening" in c
                                   for *_, c in moves)
    for board, legal, turn, caption in moves:
        action = int(re.search(r"\(action (\d+)\)", caption).group(1))
        assert action in legal
        assert ("BLACK" if turn == -1 else "WHITE") in caption
    board = frames[-1][0]
    m = re.search(r"black (\d+) - white (\d+)", frames[-1][3])
    assert (int(m.group(1)), int(m.group(2))) == (
        int((board == -1).sum()), int((board == 1).sum()))
    assert len(_frames_json(out.read_text())) == len(frames)


def test_replay_plies_go_through_core_step(monkeypatch):
    """Each ply of an 8x8 game is one ``core.state.step`` (the ply
    kernel's wrapper on the card; its plain version here)."""
    calls = []
    real = replay.core.step
    monkeypatch.setattr(replay.core, "step",
                        lambda s, a, cfg: calls.append(1) or real(s, a, cfg))
    gen = torch.Generator().manual_seed(0)
    frames = replay.play_one_game(
        EnvConfig(), replay.make_player("greedy", EnvConfig(), "cpu"),
        replay.make_player("maximin-1", EnvConfig(), "cpu"), gen, 0, "cpu")
    assert len(calls) == len(frames) - 1


@pytest.mark.parametrize("load,opponent", [
    (WIDE2, "greedy"),
    (REC, "maximin"),
], ids=["wide2-greedy", "recurrent-maximin1"])
def test_enjoy_transcript_equals_jax(load, opponent, tmp_path):
    """Every printed line of a deterministic episode equals JAX's (the
    recurrent net's state threaded through the agent's decisions), and
    the live HTML view is written and ends on the game-over page."""
    argv = ["--load", load, "--opponent", opponent, "--deterministic",
            "--opponent-search-depth", "1", "--seed", "2"]
    live = tmp_path / "live.html"
    with contextlib.redirect_stdout(io.StringIO()) as jtext:
        jenjoy.main(argv)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rewards = enjoy.main(argv + ["--device", "cpu", "--live-html",
                                     str(live)])
    lines = text.getvalue().splitlines()
    assert lines[1] == f"live board view: open {live} in a browser"
    del lines[1]
    assert lines == jtext.getvalue().splitlines()
    assert len(rewards) == 1 and lines[-1].startswith("episode 1:")
    page = live.read_text()
    assert "game over" in page and 'http-equiv="refresh"' not in page


def test_enjoy_agent_as_white_two_episodes_sampling():
    """Sampling from the seeded generator: two episodes as white end with
    rewards of the game's scale, and the same seed repeats them."""
    argv = ["--load", WIDE2, "--opponent", "rand", "--agent-plays-white",
            "--episodes", "2", "--seed", "4", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()) as a:
        first = enjoy.main(argv)
    with contextlib.redirect_stdout(io.StringIO()) as b:
        second = enjoy.main(argv)
    assert first == second and a.getvalue() == b.getvalue()
    assert len(first) == 2 and all(r in (-1, 0, 1) for r in first)
    assert np.isfinite(first).all()
