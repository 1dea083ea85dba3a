"""The port's measurement and evaluation tools (``gymothelloenv_tpu_torch/
scripts/``) on the CPU, against the JAX package's root ``scripts/`` where
the output is deterministic.

``tournament_ci`` prints JAX's report on the same log text;
``eval_snapshots`` equals JAX's ``scripts/eval_snapshots.py`` snapshot by
snapshot on two committed checkpoints against greedy, both nets playing
their mode and the openings JAX drew rebuilt from its keys; the chunked
``tournament_big`` equals one chunk's and JAX's on a deterministic
lineup, and ``cli/tournament``'s at ``chunk = games``.  Each trace,
profile and bench module runs at a tiny size on ``--device=cpu`` and
prints its JAX counterpart's fields (the kernel tables are empty on the
CPU, where no kernel runs); asked for the card without one, every tool
raises.  ``expert_seed_scan``'s lengths equal ``make_expert_dataset``'s
seed by seed, and ``family_strength``'s S1(b) and S3 options read as
documented."""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from gymothelloenv_tpu.models import distributions as jdist
from gymothelloenv_tpu.policies.scripted import random_action
from gymothelloenv_tpu.train.tournament import draw_max_rand_steps
from gymothelloenv_tpu_torch.cli import tournament as cli_tournament
from gymothelloenv_tpu_torch.models import distributions
from gymothelloenv_tpu_torch.scripts import (bench_batch_scaling,
                                             bench_replay,
                                             bench_replay_parts,
                                             bench_scaling, eval_snapshots,
                                             expert_seed_scan,
                                             family_strength,
                                             make_expert_dataset,
                                             profile_ppo_train,
                                             profile_recurrent,
                                             profile_update_breakdown,
                                             tournament_big, tournament_ci,
                                             trace_collect, trace_dqn_chunk,
                                             trace_rainbow_chunk,
                                             trace_train_step, trace_update)
from gymothelloenv_tpu_torch.train import self_play as sp
from gymothelloenv_tpu_torch.train import tournament
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(ROOT, "data", "logs", "queue", "01_tournament1000.log")
SNAPSHOTS = os.path.join(ROOT, "data", "selfplay",
                         "ppo_wide2_lappo_{step}.msgpack")
LINE = re.compile(r"\s*(\S+)\s+\(B\) vs (\S+)\s+\(W\):\s+"
                  r"(\d+)\s*/\s*(\d+)\s*/\s*(\d+)")


def _jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, *args):
    """``fn(*args)``'s result and printed text."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args)
    return result, out.getvalue()


def _tallies(text):
    return {(m.group(1), m.group(2)): tuple(map(int, m.group(3, 4, 5)))
            for m in LINE.finditer(text)}


def test_tournament_ci_prints_jax_report(tmp_path, monkeypatch):
    """The committed 1000-game log and a log with an all-draws cell and an
    unknown pair: the port's report equals JAX's line for line."""
    jci = _jax_script("tournament_ci")
    extra = tmp_path / "extra.log"
    extra.write_text(
        "      rand (B) vs greedy     (W):    0 /  10 /    0   [0.1s]\n"
        "    greedy (B) vs rand       (W):   90 /   2 /    8   [0.1s]\n"
        "  maximin-9 (B) vs rand      (W):    9 /   0 /    1   [0.1s]\n")
    for path in (LOG, str(extra)):
        monkeypatch.setattr("sys.argv", ["tournament_ci.py", path])
        _, want = _run(jci.main)
        rows, got = _run(tournament_ci.main, [path])
        assert got == want and got.count("\n") > 1
    assert tournament_ci.REFERENCE == jci.REFERENCE
    assert [r[1] for r in rows] == [("greedy", "rand")]


def _record_openings(events, real):
    """JAX's ``play_games_impl`` with each call's key, each ply's legal
    masks and the call's winners appended to ``events`` as the program
    runs (``io_callback``, in order), as ``(tag, array)``."""
    def record(tag, x):
        io_callback(lambda a: events.append((tag, np.array(a))), None, x,
                    ordered=True)

    def play_games_impl(key, cfg, act_black, act_white, num_games,
                        init_rand_steps=0, max_plies=0):
        record("key", key)

        def black(keys, states):
            record("legal", states.legal)
            if getattr(act_black, "batched", False):
                return act_black(keys, states)
            return jax.vmap(act_black)(keys, states)
        black.batched = True
        winners = real(key, cfg, black, act_white, num_games,
                       init_rand_steps, max_plies)
        record("winners", winners)
        return winners
    return play_games_impl


def _calls(events):
    """``events`` split into calls: ``{key, legal: [...], winners}``."""
    calls = []
    for tag, x in events:
        if tag == "key":
            calls.append({"key": x, "legal": []})
        elif tag == "legal":
            calls[-1]["legal"].append(x)
        else:
            calls[-1]["winners"] = x
    return calls


def _opening_draws(records, init_rand_steps):
    """The port's draws for JAX's recorded calls: each call's opening
    counts and each ply's random move, rebuilt from its key as
    ``play_games_impl`` splits it, as the rank among the legal moves."""
    rand_left, legal_index = [], []
    for call in records:
        n = len(call["winners"])
        keys = jax.random.split(jnp.asarray(call["key"]), n + 1)
        rand_left.append(torch.from_numpy(np.array(jax.vmap(
            draw_max_rand_steps, in_axes=(0, None))(keys[1:],
                                                    init_rand_steps))))
        key = keys[0]
        for legal in call["legal"]:
            key, k_rand, _, _ = jax.random.split(key, 4)
            move = np.array(jax.vmap(random_action)(
                jax.random.split(k_rand, n), jnp.asarray(legal)))
            legal_index.append(torch.tensor(
                [int(legal[i, :a].sum()) for i, a in enumerate(move)]))
    return sp.InjectedDraws([], [], rand_left, legal_index)


def test_eval_snapshots_equals_jax(monkeypatch):
    """Two committed snapshots of one run (``ppo_wide2_lappo_{500,
    1500}``) against greedy, 8 games each with 10 random opening plies:
    with both packages' nets playing their mode and JAX's openings
    injected, each snapshot's W/D/L equals JAX's, and every game's
    winner; a missing step is skipped with JAX's line."""
    jes = _jax_script("eval_snapshots")
    events = []
    monkeypatch.setattr(jes, "play_games_impl",
                        _record_openings(events, jes.play_games_impl))
    monkeypatch.setattr(jdist.MaskedCategorical, "sample",
                        lambda self, key: self.mode())
    argv = ["--glob", SNAPSHOTS, "--steps", "500,1500,7",
            "--opponent", "greedy", "--games", "8"]
    _, want = _run(jes.main, argv)
    jax.effects_barrier()
    records = _calls(events)
    assert len(records) == 4

    draws = _opening_draws(records, 10)
    winners, real = [], tournament.play_games

    def play_games(*args, **kwargs):
        winners.append(real(*args, **kwargs).numpy())
        return winners[-1]
    monkeypatch.setattr(tournament, "play_games", play_games)
    monkeypatch.setattr(tournament, "Draws", lambda generator: draws)
    monkeypatch.setattr(distributions.MaskedCategorical, "sample",
                        lambda self, u=None, generator=None: self.mode())
    got, text = _run(eval_snapshots.main, argv + ["--device", "cpu"])
    for call, w in zip(records, winners, strict=True):
        np.testing.assert_array_equal(w, call["winners"])
    jax_wdl = {int(m.group(1)): tuple(map(int, m.group(2, 3, 4)))
               for m in re.finditer(r"step (\d+): vs greedy (\d+)/(\d+)/"
                                    r"(\d+)", want)}
    assert got == jax_wdl and set(got) == {500, 1500}
    assert len(set(got.values())) > 1 or sum(got[500][1:]) > 0
    skipped = [ln for ln in text.splitlines() if "missing" in ln]
    assert skipped == [ln for ln in want.splitlines() if "missing" in ln]
    assert re.findall(r"step \d+: vs greedy \S+ win%=\S+", text) == \
        re.findall(r"step \d+: vs greedy \S+ win%=\S+", want)


def test_tournament_big_chunks_equal_one_chunk_and_jax(monkeypatch):
    """On a deterministic lineup (greedy, no random openings) the chunked
    tallies equal one chunk's and JAX's ``tournament_big``; with random
    openings and the random policy, at ``chunk = games`` the tallies equal
    ``cli/tournament``'s at the same seed."""
    jtb = _jax_script("tournament_big")
    monkeypatch.setattr(jtb, "LINEUP", ("greedy",))
    monkeypatch.setattr(tournament_big, "LINEUP", ("greedy",))
    argv = ["--games", "6", "--chunk", "2", "--init-rand-steps", "0"]
    _, jax_text = _run(jtb.main, argv)
    chunked, text = _run(tournament_big.main, argv + ["--device", "cpu"])
    one, _ = _run(tournament_big.main, argv[:2] + [
        "--chunk", "6", "--init-rand-steps", "0", "--device", "cpu"])
    assert chunked == one == _tallies(jax_text) == _tallies(text)
    assert sum(chunked[("greedy", "greedy")]) == 6

    monkeypatch.setattr(tournament_big, "LINEUP", ("rand",))
    seeded = ["--games", "4", "--seed", "5", "--device", "cpu"]
    big, _ = _run(tournament_big.main, seeded + ["--chunk", "4"])
    cli, _ = _run(cli_tournament.main, seeded + ["--lineup", "rand"])
    assert big == cli and sum(big[("rand", "rand")]) == 4


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _table(text):
    assert "kernel device total:" in text and "ms_total" in text
    assert "bit_step_kernel runs: 0" in text


def test_trace_tools_print_jax_fields(monkeypatch, tmp_path):
    """trace_update, trace_train_step, trace_collect (with --lookahead),
    trace_dqn_chunk and trace_rainbow_chunk at a tiny size: the trace
    directory, the kernel table and their own readings; on the CPU the
    plain ply runs, so no B1 launch is counted.  The traces go to the
    test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(trace_dqn_chunk, "CAPACITY", 4096)
    cpu = "--device=cpu"
    out, text = _run(trace_update.main, ["2", "8", cpu])
    assert "trace dir:" in text and "update T=2 N=8" in text
    _table(text)
    assert out["wall_s"] > 0 and os.path.dirname(out["trace_dir"]) == str(
        tmp_path)
    out, text = _run(trace_train_step.main, ["4", cpu])
    assert "trace dir:" in text and "train step N=4 T=64" in text
    _table(text)
    assert out["b1_launches"] == out["b1_traced"] == 0
    out, text = _run(trace_collect.main, ["2", "4", "--lookahead",
                                          "--hidden=16", cpu])
    assert re.search(r"collect T=2 N=4 bf16=False lookahead=True tau=0.0 "
                     r"wm=1: \S+ ms/rollout = \S+M trans/s", text)
    assert "kernels a slot (2 slots)" in text and "device time not" in text
    for module in (trace_dqn_chunk, trace_rainbow_chunk):
        out, text = _run(module.main, ["4", "--batch=8", "--interval=4",
                                       "--plies=2", cpu])
        assert "trace dir:" in text and "chunk: 2 plies" in text
        _table(text)
        assert out["plies"] == 2 and out["updates"] == 2


def test_profile_tools_print_jax_fields(monkeypatch):
    """profile_update_breakdown's JAX keys a line, profile_recurrent's
    collector and update lines (monolithic and split), profile_ppo_train's
    keys; every time positive and finite."""
    monkeypatch.setattr(profile_update_breakdown, "REPS", 1)
    monkeypatch.setattr(profile_recurrent, "REPS", 1)
    monkeypatch.setattr(profile_recurrent, "H", 16)
    monkeypatch.setattr(profile_recurrent, "MINI_BATCHES", (2,))
    _, text = _run(profile_update_breakdown.main, ["2", "8",
                                                   "--device=cpu"])
    keys = set()
    for row in _json_lines(text):
        assert row.pop("minibatch") == 4
        keys |= set(row)
        assert all(v > 0 and np.isfinite(v) for v in row.values())
    assert keys == {"fwd_ms", "loss_fwd_ms", "grad_ms", "opt_apply_ms",
                    "gather_ms", "gather4d_obs_ms", "gather2d_obs_ms",
                    "gather2d_int8_obs_ms", "gather_grad_ms", "perm_ms",
                    "gae_ms", "full_update_ms", "full_update_int8_ms",
                    "grad_steps_per_update"}
    rows, _ = _run(profile_recurrent.main, ["2", "4", "--device=cpu"])
    assert [r["what"] for r in rows] == [
        "collect_recurrent", "update_recurrent_monolithic",
        "update_recurrent_split"]
    assert all(r["sec"] > 0 for r in rows) and rows[1]["mini_batch"] == 2
    rows, text = _run(profile_ppo_train.main, ["4", "--num-steps=2",
                                               "--device=cpu"])
    assert set(rows[0]) == {
        "num_envs", "collect_bit_s", "collect_plane_s", "update_s",
        "full_s", "full_bf16_s", "collect_steps_per_s", "full_steps_per_s",
        "full_bf16_steps_per_s"}
    assert _json_lines(text) == rows and rows[0]["update_s"] > 0


def test_bench_tools_print_jax_fields(monkeypatch):
    """bench_replay's two replays with exact insert and sample counts,
    bench_replay_parts' keys at both capacities, bench_batch_scaling's
    line and bench_scaling at world 1."""
    monkeypatch.setattr(bench_replay, "REPS", 2)
    monkeypatch.setattr(bench_replay, "CAPACITY", 100)
    monkeypatch.setattr(bench_replay_parts, "REPS", 2)
    monkeypatch.setattr(bench_replay_parts, "K", 16)
    monkeypatch.setattr(bench_replay_parts, "CAPACITIES", (1000, 100))
    monkeypatch.setattr(bench_batch_scaling, "REPS", 1)
    rows, _ = _run(bench_replay.main, ["32", "8", "--device=cpu"])
    assert [r["prioritized"] for r in rows] == [False, True]
    for r in rows:
        assert r["inserted"] == r["inserted_want"] == 100     # wrapped
        assert r["write_pos"] == r["write_pos_want"]
        assert r["sampled"] == r["sampled_want"] == 16
        assert r["max_index"] < 100 and r["insert_ms"] > 0
    out, _ = _run(bench_replay_parts.main, ["--device=cpu"])
    assert set(out) == {"row_bytes", "pack_ms"} | {
        f"{part}_ms_C{c}" for c in (1000, 100)
        for part in ("scatter_data", "scatter_prio", "scatter_slotmath")}
    assert out["row_bytes"] == 139
    rows, _ = _run(bench_batch_scaling.main, ["--f32", "--num-steps=2",
                                              "--device=cpu", "4"])
    assert set(rows[0]) == {"num_envs", "bf16", "epochs", "mini_batch",
                            "ms_per_step", "trans_per_sec"}
    assert rows[0]["bf16"] is False and rows[0]["ms_per_step"] > 0
    out, text = _run(bench_scaling.main, ["4", "2", "--backend=gloo",
                                          "--device=cpu"])
    assert re.search(r"1 device\(s\): 4 envs x 2 slots -> .* transitions/s",
                     text)
    assert "single device only; scaling efficiency n/a" in text
    assert out[1] > 0


@pytest.mark.parametrize("module,argv", [
    (trace_update, []), (trace_train_step, []), (trace_collect, []),
    (trace_dqn_chunk, []), (trace_rainbow_chunk, []),
    (profile_update_breakdown, []), (profile_recurrent, []),
    (profile_ppo_train, []), (bench_replay, []), (bench_replay_parts, []),
    (bench_batch_scaling, []), (bench_scaling, []),
    (eval_snapshots, ["--glob", SNAPSHOTS, "--steps", "500"]),
    (tournament_big, []),
    (expert_seed_scan, []),
], ids=lambda x: getattr(x, "__name__", "argv").rsplit(".", 1)[-1])
def test_tools_refuse_a_missing_card(monkeypatch, module, argv):
    """Every tool defaults to the card and raises without one; none falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(module.main, argv)


def test_expert_seed_scan_equals_make_expert_dataset():
    """The scan's lengths equal ``make_expert_dataset``'s games seed by
    seed (three seeds in one batch), and its rows are
    ``ExpertDataset``'s count at subsample 4."""
    lengths = expert_seed_scan.expert_lengths([0, 1, 2], 3, search_depth=1,
                                              device="cpu")
    for seed in range(3):
        args = make_expert_dataset.build_parser().parse_args(
            ["--games", "3", "--search-depth", "1", "--seed", str(seed),
             "--device", "cpu", "--out", "unused"])
        (_, _, want), _ = _run(make_expert_dataset.make_dataset, args)
        np.testing.assert_array_equal(lengths[seed], want)
    rows, text = _run(expert_seed_scan.main, [
        "--seeds", "0:3", "--games", "3", "--search-depth", "1",
        "--rows", str(int((lengths[1] // 4).sum())), "--device", "cpu",
        "--block", "2"])
    assert [r["rows"] for r in rows] == [int((x // 4).sum())
                                         for x in lengths]
    assert json.loads(text.splitlines()[-1])["first_match"] in (0, 1)


def test_family_strength_s1b_and_s3_options(tmp_path, monkeypatch):
    """``--readings`` pools job 07's readings (426/800 and 542/800 at
    chunks 25-100), and is refused off rainbow; ``--chunks 0`` reads
    GAIL's BC warm-start alone, on the file of ``--expert-seed``."""
    assert family_strength.jax_07((25, 50, 75, 100)) == {
        "greedy": (426, 800), "rand": (542, 800)}
    assert family_strength.jax_07((200, 225, 250, 275, 300)) == \
        family_strength.JAX["rainbow"]
    with pytest.raises(SystemExit):
        _run(family_strength.main, ["--family", "acktr", "--readings",
                                    "200", "--device", "cpu"])
    monkeypatch.setattr(family_strength, "GAIL_GAMES", 4)
    expert, real, seen = str(tmp_path / "expert.npz"), \
        make_expert_dataset.main, []

    def small(argv):          # 256 maximin-2 games cut to 4 at depth 1
        seen.append(list(argv))
        argv = list(argv)
        argv[argv.index("--games") + 1] = "4"
        argv[argv.index("--search-depth") + 1] = "1"
        return real(argv)
    monkeypatch.setattr(make_expert_dataset, "main", small)
    rows, _ = _run(family_strength.main, [
        "--family", "gail", "--chunks", "0", "--num-envs", "4",
        "--bc-updates", "2", "--expert", expert, "--expert-seed", "5",
        "--device", "cpu"])
    assert seen[0][seen[0].index("--seed") + 1] == "5"
    assert seen[0][seen[0].index("--games") + 1] == "256"
    assert [r["reading"] for r in rows] == ["bc", "bc"]
    assert all((r["jax_wins"], r["jax_games"]) == family_strength.JAX_BC[
        r["opponent"]] for r in rows)
