"""The port's remaining utilities against JAX's on the CPU: the SVG and
live-HTML renderers byte for byte, ``MetricsLogger``'s TensorBoard writer
(a stub ``torch.utils.tensorboard`` in ``sys.modules``, so the calls are
read whatever is installed), ``StepTimer``'s summaries on injected times,
``summarize_trace`` on a small Chrome trace, the sweep's commands and
files, ``visualize``'s ``load_run``/``smooth`` on the port logger's JSONL
and its plot (or the ``ImportError`` that names matplotlib), and the h5
converter's npz against JAX's script's from the same arrays."""

import builtins
import contextlib
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from gymothelloenv_tpu.cli import sweep as jsweep
from gymothelloenv_tpu.cli import visualize as jvisualize
from gymothelloenv_tpu.utils import profiling as jprofiling
from gymothelloenv_tpu.utils import render as jrender
from gymothelloenv_tpu_torch.agents.gail import ExpertDataset
from gymothelloenv_tpu_torch.cli import sweep, visualize
from gymothelloenv_tpu_torch.scripts import convert_expert_h5
from gymothelloenv_tpu_torch.utils import logging as plogging
from gymothelloenv_tpu_torch.utils import profiling, render
from gymothelloenv_tpu_torch.utils.logging import MetricsLogger
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boards(n=6, seed=0):
    rng = np.random.default_rng(seed)
    for b in (6, 8, 10):
        for _ in range(n):
            board = rng.integers(-1, 2, (b, b)).astype(np.int8)
            legal = sorted(rng.choice(b * b, rng.integers(0, 9),
                                      replace=False).tolist())
            yield board, legal, int(rng.choice([-1, 1]))


def test_render_equals_jax_byte_for_byte(tmp_path):
    for i, (board, legal, turn) in enumerate(_boards()):
        assert render.board_svg(board, legal, turn) == jrender.board_svg(
            board, legal, turn)
        for done, keep in ((False, False), (True, False), (True, True)):
            args = (board, legal, turn, [f"line {i}", "x"], 0.5, done, keep)
            assert render.live_html(*args) == jrender.live_html(*args)
        a, b = tmp_path / f"p{i}.svg", tmp_path / f"j{i}.svg"
        render.save_board_svg(str(a), board, legal, turn)
        jrender.save_board_svg(str(b), board, legal, turn)
        assert a.read_bytes() == b.read_bytes()
        a, b = tmp_path / f"p{i}.html", tmp_path / f"j{i}.html"
        render.save_live_html(str(a), board, legal, turn, ["s"], done=True)
        jrender.save_live_html(str(b), board, legal, turn, ["s"], done=True)
        assert a.read_bytes() == b.read_bytes()
        assert not os.path.exists(str(a) + ".tmp")


class _StubWriter:
    made = []

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.scalars = []
        self.closed = False
        _StubWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


def test_metrics_logger_writes_tensorboard_scalars(tmp_path, monkeypatch):
    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = _StubWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", stub)
    _StubWriter.made.clear()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        with MetricsLogger(str(tmp_path)) as log:
            log.log(3, {"loss": 0.5, "episodes": 7,
                        "name": "abc", "flag": True})
            log.log(4, {"win%(rand)": 1})
    (writer,) = _StubWriter.made
    assert writer.log_dir == str(tmp_path) and writer.closed
    assert writer.scalars == [("loss", 0.5, 3), ("episodes", 7.0, 3),
                              ("flag", 1.0, 3), ("win%(rand)", 1.0, 4)]
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [3, 4]
    assert "[step 4] win%(rand)=1" in out.getvalue()


def test_metrics_logger_without_tensorboard(tmp_path, monkeypatch):
    """Where ``torch.utils.tensorboard`` does not import, the JSONL is
    written alone."""
    real = builtins.__import__

    def no_tb(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise ImportError("TensorBoard logging requires TensorBoard")
        return real(name, *args, **kwargs)
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard",
                        raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tb)
    assert plogging._summary_writer(str(tmp_path)) is None
    log = MetricsLogger(str(tmp_path), also_print=False)
    log.log(1, {"a": 1.0})
    log.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


def test_step_timer_summaries_equal_jax(monkeypatch):
    """The same injected clock readings give the same summaries."""
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.5, 3.0, 4.0, 5.0, 5.125]
    timers = []
    for mod in (profiling, jprofiling):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        t = mod.StepTimer(warmup=2)
        for _ in range(5):
            with t.measure():
                pass
        timers.append(t)
    monkeypatch.undo()
    port, jax_ = timers
    assert port.times == jax_.times == [0.5, 1.0, 0.125]
    assert port.summary() == jax_.summary()
    empty = profiling.StepTimer().summary()
    assert np.isnan(empty["mean_s"]) and empty["n"] == 0


def test_step_timer_syncs_the_tree(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "force_sync", calls.append)
    t = profiling.StepTimer(warmup=0)
    tree = {"a": [torch.zeros(2)]}
    with t.measure(tree):
        pass
    with t.measure():
        pass
    assert calls == [tree] and len(t.times) == 2
    profiling.force_sync(tree)      # CPU tensors: nothing to wait for


# The ply kernel's name in a card's trace (csrc/step.cu's anonymous
# namespace).
B1 = "(anonymous namespace)::bit_step_kernel(StepIn, long const*)"


def _write_chrome_trace(path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 40,
         "ts": 0, "args": {"External id": 5}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9,
         "ts": 50, "args": {"External id": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 5, "ts": 1, "args": {"External id": 5}},
        {"ph": "X", "cat": "kernel", "name": B1, "dur": 100, "ts": 10,
         "args": {"External id": 0}},
        {"ph": "X", "cat": "kernel", "name": B1, "dur": 50, "ts": 200,
         "args": {"External id": 0}},
        {"ph": "X", "cat": "kernel", "name": "sgemm_128x64", "dur": 30,
         "ts": 300, "args": {"External id": 5}},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "dur": 2,
         "ts": 400, "args": {"External id": 6}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 700,
         "ts": 500, "args": {}},
        {"ph": "X", "cat": "python_function", "name": "train.py(3)",
         "dur": 900, "ts": 0, "args": {}},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace_keeps_device_kernels(tmp_path):
    d = tmp_path / "sub"
    d.mkdir()
    _write_chrome_trace(d / "host.1.pt.trace.json")
    ops = profiling.summarize_trace(str(tmp_path))
    assert [(o.name, o.total_us, o.count, o.op) for o in ops] == [
        (B1, 150.0, 2, ""),
        ("sgemm_128x64", 30.0, 1, "aten::mm"),
        ("add_kernel", 2.0, 1, "aten::add")]
    table = profiling.format_op_table(ops)
    assert "kernel device total: 0.2 ms" in table
    assert "bit_step_kernel" in table and "Memcpy" not in table
    assert "train.py" not in table


def test_trace_writes_a_chrome_trace_that_summarizes(tmp_path):
    """On the CPU the trace holds host ops only: it is written and
    summarizes to no device kernel."""
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".trace.json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert profiling.summarize_trace(str(tmp_path)) == []


def test_sweep_commands_match_jax_but_the_package(tmp_path, monkeypatch):
    extra = ["--num-updates", "7"]
    got = sweep.build_commands("a2c_train", 3, 5, "/o", extra)
    want = jsweep.build_commands("a2c_train", 3, 5, "/o", extra)
    assert [[a.replace("gymothelloenv_tpu_torch.", "gymothelloenv_tpu.")
             for a in c] for c in got] == want
    assert sweep.TRAINERS == jsweep.TRAINERS
    for trainer in sweep.TRAINERS:
        assert os.path.exists(os.path.join(
            ROOT, "gymothelloenv_tpu_torch", "cli", f"{trainer}.py"))
    monkeypatch.setenv("PYTHONPATH", "/repo")
    with contextlib.redirect_stdout(io.StringIO()):
        sweep.main(["--trainer", "dqn_train", "--num-seeds", "2",
                    "--out-dir", str(tmp_path / "s"), "--", "--board-size",
                    "6"])
        sweep.main(["--trainer", "ppo_self_play", "--num-seeds", "3",
                    "--settle-seconds", "2.5", "--output",
                    str(tmp_path / "p.sh"), "--out-dir",
                    str(tmp_path / "s")])
    script = (tmp_path / "s" / "run_all.sh").read_text().splitlines()
    assert script[:3] == ["#!/bin/sh", "set -e", "export PYTHONPATH=/repo"]
    assert len(script) == 5 and not any("sleep" in x for x in script)
    assert all("gymothelloenv_tpu_torch.cli.dqn_train" in x
               and x.endswith("--board-size 6") for x in script[3:])
    assert os.access(tmp_path / "s" / "run_all.sh", os.X_OK)
    paced = (tmp_path / "p.sh").read_text()
    assert paced.count("sleep 2.5\n") == 2


def test_sweep_yaml_and_run(tmp_path, monkeypatch):
    import yaml
    with contextlib.redirect_stdout(io.StringIO()):
        sweep.main(["--trainer", "a2c_train", "--num-seeds", "2",
                    "--base-seed", "3", "--format", "yaml", "--out-dir",
                    str(tmp_path)])
    config = yaml.safe_load((tmp_path / "run_all.yaml").read_text())
    assert config["session_name"] == "sweep-a2c_train"
    assert [w["window_name"] for w in config["windows"]] == ["seed-3",
                                                             "seed-4"]
    ran = []
    monkeypatch.setattr(sweep.subprocess, "run",
                        lambda cmd, check: ran.append(cmd))
    monkeypatch.setattr(sweep.time, "sleep", ran.append)
    with contextlib.redirect_stdout(io.StringIO()):
        cmds = sweep.main(["--format", "run", "--num-seeds", "2",
                           "--out-dir", str(tmp_path)])
    assert ran == cmds       # no pause at the default settle of 0


def _port_run(tmp_path, name, seed):
    d = tmp_path / name
    with MetricsLogger(str(d), also_print=False) as log:
        rng = np.random.default_rng(seed)
        for step in range(1, 9):
            log.log(step, {"value_loss": float(rng.random()),
                           "episodes": int(rng.integers(0, 9)),
                           "label": "x"})
            if step % 4 == 0:
                log.log(step, {"win%(rand)": float(rng.random())})
    return str(d)


def test_visualize_load_run_and_smooth_equal_jax(tmp_path):
    run = _port_run(tmp_path, "a", 0)
    got, want = visualize.load_run(run), jvisualize.load_run(run)
    assert got == want
    assert set(got) == {"value_loss", "episodes", "win%(rand)"}
    assert got["win%(rand)"][0] == [4, 8]
    for alpha in (0.0, 0.6, 0.95):
        for values in ([], [1.0, 2.0], got["value_loss"][1]):
            assert visualize.smooth(values, alpha) == jvisualize.smooth(
                values, alpha)


def test_visualize_plots_or_names_matplotlib(tmp_path, monkeypatch):
    runs = [_port_run(tmp_path, "a", 0), _port_run(tmp_path, "b", 1)]
    out = tmp_path / "c.png"
    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            assert visualize.main(runs + ["--out", str(out)]) == 0
        assert out.stat().st_size > 0 and "3 panels, 2 runs" in \
            text.getvalue()
    real = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.main(runs)


def _trajectories(seed=0):
    rng = np.random.default_rng(seed)
    k, t = 5, 40
    return {"states": rng.random((k, t, 256)).astype(np.float64),
            "actions": rng.integers(0, 64, (k, t, 1)),
            "lengths": np.array([40, 31, 22, 40, 12], np.int32)}


def test_h5_converter_npz_equals_jax(tmp_path, monkeypatch):
    """Both scripts on the same in-memory trajectories (their loaders
    patched) write the same arrays; ``ExpertDataset`` reads the port's
    back as it reads JAX's."""
    sys.path.insert(0, ROOT)
    try:
        from scripts import convert_expert_h5 as jconvert
    finally:
        sys.path.remove(ROOT)
    data = _trajectories()
    monkeypatch.setattr(jconvert, "_load_trajectories", lambda p: data)
    monkeypatch.setattr(convert_expert_h5, "_load_trajectories",
                        lambda p: data)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        assert convert_expert_h5.main(["x.h5", a]) == 0
        assert jconvert.main(["x.h5", b]) == 0
    lines = text.getvalue().splitlines()
    assert lines[0].replace(a, b) == lines[1]
    with np.load(a) as got, np.load(b) as want:
        assert sorted(got.files) == sorted(want.files) == [
            "actions", "lengths", "states"]
        for key in want.files:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    ds = ExpertDataset(a, num_trajectories=3, subsample_frequency=2)
    want_ds = ExpertDataset(b, num_trajectories=3, subsample_frequency=2)
    np.testing.assert_array_equal(ds.states, want_ds.states)
    assert len(ds) == len(want_ds) > 0


def test_h5_converter_without_h5py_names_it(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        convert_expert_h5.main([str(tmp_path / "t.h5")])
    with contextlib.redirect_stdout(io.StringIO()) as text:
        assert convert_expert_h5.main([]) == 1
    assert "Usage" in text.getvalue()
