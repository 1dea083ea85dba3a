"""Kernel timers on the card, between CUDA events (``call_ms`` and
``device_ms`` card only; ``mean_ms`` on either device)."""

from __future__ import annotations

import time

import torch


def call_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls after one
    warm-up call, between two CUDA events: the caller's view, which for a
    short kernel is the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, spin_cycles: int = 100_000_000) -> float:
    """Mean device ms per launch of ``fn``: the launches are queued behind
    a GPU spin, so they run back to back with the host's launch overhead
    hidden.  Raises if the host could not queue them within the spin."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(spin_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise RuntimeError(
            f"{reps} launches took {host_ms:.2f} ms to queue, longer than "
            "the GPU spin: the device time would include host gaps")
    return start.elapsed_time(end) / reps


def mean_ms(fn, reps: int, device) -> float:
    """Mean ms a call of ``fn`` over ``reps`` back-to-back calls after one
    warm-up call: between CUDA events on a card (``call_ms``), on the host
    clock on the CPU."""
    if torch.device(device).type == "cuda":
        return call_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps
