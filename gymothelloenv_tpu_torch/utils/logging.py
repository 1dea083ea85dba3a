"""Metrics logging — the port of ``utils/logging.py``: an append-only
``metrics.jsonl`` in the log directory, one console line per record, and
TensorBoard event files through ``torch.utils.tensorboard.SummaryWriter``
where that module imports (it needs the ``tensorboard`` package)."""

from __future__ import annotations

import json
import os
import time


def _summary_writer(log_dir: str):
    """A ``SummaryWriter`` on ``log_dir``, or ``None`` when
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


class MetricsLogger:
    def __init__(self, log_dir: str, also_print: bool = True):
        self.log_dir = log_dir
        self.also_print = also_print
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = _summary_writer(log_dir)

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            # One scalar a metric that converts to a float, as JAX's.
            for k, v in metrics.items():
                try:
                    value = float(v)
                except (TypeError, ValueError):
                    continue
                self._tb.add_scalar(k, value, step)
        if self.also_print:
            text = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items()
                            if isinstance(v, (int, float)))
            print(f"[step {step}] {text}", flush=True)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
