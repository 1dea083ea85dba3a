"""Micro-benchmark of kernel K2 (the legal-move flood) against its plain
PyTorch version on the card — the port of ``scripts/bench_pallas.py``.

Usage:  python -m gymothelloenv_tpu_torch.scripts.bench_legal_mask [batch]

The boards are the JAX script's: every cell drawn from U{0, 1, 2} (empty,
mine, the opponent's) by numpy's ``RandomState(0)``, 65,536 boards by
default.  K2 is checked against the plain flood first; then it prints the
kernel's device time a launch (launches queued behind a GPU spin), its
time a wrapper call, and the plain version's time a call.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gymothelloenv_tpu_torch.core import bitboard
from gymothelloenv_tpu_torch.ops.legal_mask import (legal_mask,
                                                    legal_mask_plain)
from gymothelloenv_tpu_torch.utils import timing

DEFAULT_BATCH = 65_536


def boards(n: int, seed: int = 0, device=None):
    """``(mine, opp)`` int64 words of ``n`` boards with U{0, 1, 2} cells
    from ``RandomState(seed)`` (``bench_pallas.py``'s boards)."""
    cells = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 3, (n, 8, 8)))
    return (bitboard.pack(cells == 1).to(device),
            bitboard.pack(cells == 2).to(device))


def parity(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """K2's legal masks for the boards; raises unless they equal the plain
    flood's."""
    got = legal_mask(mine, opp)
    if not torch.equal(got, legal_mask_plain(mine, opp)):
        raise RuntimeError("K2 disagrees with the plain legal flood")
    return got


def run(n: int, device, reps: int = 200, out=print) -> dict:
    """Parity, then the times in ms: ``ms`` (device, a launch),
    ``call_ms`` (a wrapper call), ``plain_ms`` (a plain call)."""
    mine, opp = boards(n, 0, device)
    parity(mine, opp)
    out(f"parity OK at batch {n}")
    res = dict(ms=timing.device_ms(lambda: legal_mask(mine, opp), reps),
               call_ms=timing.call_ms(lambda: legal_mask(mine, opp), reps),
               plain_ms=timing.call_ms(lambda: legal_mask_plain(mine, opp),
                                       10))
    for name, ms in (("plain", res["plain_ms"]), ("K2 call", res["call_ms"]),
                     ("K2", res["ms"])):
        out(f"{name:8s}: {ms * 1e3:9.2f} us -> {n / ms / 1e3:9.1f} "
            "M boards/s")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else DEFAULT_BATCH
    if not torch.cuda.is_available():
        raise SystemExit("bench_legal_mask times kernel K2 on the card; no "
                         "CUDA device is available")
    print(f"device: {torch.cuda.get_device_name()}", flush=True)
    return run(n, torch.device("cuda", torch.cuda.current_device()),
               out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
