"""Profiling utilities — the port of ``utils/profiling.py`` over
``torch.profiler``.

``trace`` records the enclosed block with ``torch.profiler`` (the card's
kernels through CUPTI where a card is present) and writes it as a Chrome
trace; ``StepTimer`` measures steady-state step times, each measured call
ended by a device synchronisation; ``summarize_trace``/``format_op_table``
turn a written trace into a per-kernel device-time table, the headless
reading JAX's ``summarize_trace`` gives of its XLA Ops track.  Card
kernels timed between CUDA events are ``utils/timing.py``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import json
import os
import socket
import time

import numpy as np
import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` and write it to
    ``log_dir/<host>.<pid>.pt.trace.json`` (Chrome trace format, viewable
    in Perfetto).  The block's queued card work is waited for before the
    profiler stops."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force_sync(tree) -> None:
    """Wait for the work queued on every card that holds a tensor of
    ``tree`` (tensors, and dicts, lists, tuples and dataclasses of them):
    ``torch.cuda.synchronize`` once a device."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Steady-state step timing: warmup iterations are discarded, each
    measured call ends in ``force_sync`` of its ``sync_tree``."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._calls = 0

    @contextlib.contextmanager
    def measure(self, sync_tree=None):
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            force_sync(sync_tree)
        dt = time.perf_counter() - t0
        self._calls += 1
        if self._calls > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def summary(self) -> dict:
        return {"mean_s": self.mean, "p50_s": self.p50,
                "n": len(self.times)}


@dataclasses.dataclass
class OpCost:
    """Aggregated device time of one kernel across a trace."""
    name: str
    total_us: float
    count: int
    op: str       # the host op that launched it (first seen), e.g. aten::mm


def _load_events(trace_dir: str) -> list:
    paths = sorted(glob.glob(f"{trace_dir}/**/*.trace.json", recursive=True)
                   + glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                               recursive=True))
    events = []
    for p in paths:
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            events.extend(json.load(f).get("traceEvents", []))
    return events


def summarize_trace(trace_dir: str) -> list[OpCost]:
    """Aggregate device time per kernel from the Chrome traces
    ``trace`` wrote under ``trace_dir`` (``*.trace.json``, optionally
    gzipped): only complete events of category ``kernel`` count (host
    frames, runtime calls and copies are dropped); each kernel is named
    with the host op whose launch it correlates with (``External id``).
    Returns kernels sorted by total device time."""
    events = _load_events(trace_dir)
    host_op = {}
    for ev in events:
        args = ev.get("args") or {}
        if (ev.get("ph") == "X" and ev.get("cat") == "cpu_op"
                and "External id" in args):
            host_op.setdefault(args["External id"], ev.get("name", ""))
    totals: dict[str, OpCost] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        name = ev["name"]
        cost = totals.get(name)
        if cost is None:
            args = ev.get("args") or {}
            totals[name] = OpCost(name=name, total_us=float(ev["dur"]),
                                  count=1,
                                  op=host_op.get(args.get("External id"),
                                                 ""))
        else:
            cost.total_us += float(ev["dur"])
            cost.count += 1
    return sorted(totals.values(), key=lambda c: -c.total_us)


# csrc/step.cu's ply kernel sits in an anonymous namespace, so a trace names
# it ``(anonymous namespace)::bit_step_kernel(...)``: match it anywhere.
B1_KERNEL = "bit_step_kernel"


def kernel_launches(ops: list[OpCost], name: str) -> int:
    """Runs of the kernels whose name contains ``name``."""
    return sum(o.count for o in ops if name in o.name)


def traced_call(fn, trace_dir: str):
    """``fn()`` once under ``trace(trace_dir)``; returns ``(out, wall
    seconds)``, the clock started after the card's earlier work and
    stopped after the work ``fn`` queued."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    sync()
    with trace(trace_dir):
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, wall


def report(name: str, ops: list[OpCost], wall_s: float, top: int = 8
           ) -> dict:
    """Print a traced phase's wall seconds, its kernels' summed device
    time and launches, the device's idle share (1 - device time / wall
    time, an upper bound on idleness where kernels overlap) and its
    ``top`` kernels by device time; returns ``{wall_s, device_s,
    launches, idle_share}``.  A trace with no kernel (a CPU run) has no
    device time: its device seconds and idle share are ``None``."""
    if not ops:
        print(f"[{name}] wall {wall_s:.4f} s; the trace holds no device "
              "kernel: device time not measured", flush=True)
        return dict(wall_s=wall_s, device_s=None, launches=0,
                    idle_share=None)
    device_s = sum(o.total_us for o in ops) / 1e6
    launches = sum(o.count for o in ops)
    idle = 1.0 - device_s / wall_s if wall_s > 0 else float("nan")
    print(f"[{name}] wall {wall_s:.4f} s, device {device_s:.4f} s in "
          f"{launches} kernels, device idle share {100 * idle:.1f}%",
          flush=True)
    for o in ops[:top]:
        print(f"[{name}]   {o.total_us / 1e3:9.3f} ms  x{o.count:6d}  "
              f"{o.name[:90]}", flush=True)
    return dict(wall_s=wall_s, device_s=device_s, launches=launches,
                idle_share=idle)


def format_op_table(ops: list[OpCost], top: int = 40) -> str:
    """Render ``summarize_trace`` output as an aligned text table."""
    lines = [f"kernel device total: "
             f"{sum(o.total_us for o in ops) / 1000:.1f} ms",
             f"{'ms_total':>9} {'n':>5}  {'kernel':48s} op"]
    for o in ops[:top]:
        lines.append(f"{o.total_us / 1000:9.3f} {o.count:5d}  "
                     f"{o.name[:48]:48s} {o.op}")
    return "\n".join(lines)
