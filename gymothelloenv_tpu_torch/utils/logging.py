"""Metrics logging — the port of ``utils/logging.py``: an append-only
``metrics.jsonl`` in the log directory plus one console line per record.
TensorBoard is not written."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, also_print: bool = True):
        self.log_dir = log_dir
        self.also_print = also_print
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.also_print:
            text = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items()
                            if isinstance(v, (int, float)))
            print(f"[step {step}] {text}", flush=True)

    def close(self) -> None:
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
