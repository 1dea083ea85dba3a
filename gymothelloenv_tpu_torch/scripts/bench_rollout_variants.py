"""Cost attribution inside the fused rollout kernel (K3).

Times kernel variants that stub out one component each, so the per-ply
budget (sampler vs flip flood vs the mover-again legal flood) is measured
rather than guessed, plus K1 at other block sizes and unroll factors.  The
variants change ONLY the stubbed component; they are not valid games
(except ``full``): this is a profiling tool.  Port of
``scripts/bench_rollout_variants.py`` (``main`` / ``run_config``).

Usage: python -m gymothelloenv_tpu_torch.scripts.bench_rollout_variants \
    [batch] [chunk]

Each configuration runs ``reps`` chunks back to back on the card, timed by
two CUDA events and one synchronisation at the end.  A configuration that
fails to build or launch raises.
"""

from __future__ import annotations

import sys

import torch

from gymothelloenv_tpu_torch.ops import rollout as ro

# name -> rollout_variant_chunk knobs.  The TPU script's grid of 2 and 4
# programs becomes 64 and 128 threads per block (1 program = 32 threads).
CONFIGS = (
    ("full", dict(variant="full")),
    ("nosample", dict(variant="nosample")),
    ("noflips", dict(variant="noflips")),
    ("nopass", dict(variant="nopass")),
    ("full-grid2", dict(variant="full", threads=64)),
    ("full-grid4", dict(variant="full", threads=128)),
    ("full-unroll2", dict(variant="full", unroll=2)),
    ("full-unroll4", dict(variant="full", unroll=4)),
)


def run_config(knobs: dict, batch: int, chunk_steps: int, reps: int,
               device=None) -> dict:
    """Time ``reps`` chunks of one configuration after one warm-up chunk.
    Returns ``ms`` per chunk, ``plies_per_s`` and the ``episodes`` of the
    timed chunks."""
    state = ro.rollout_init(batch, device)
    total = torch.zeros((), dtype=torch.int64, device=state.cur.device)
    ro.rollout_variant_chunk(state, 1, chunk_steps, episodes=total, **knobs)
    torch.cuda.synchronize(state.cur.device)
    total.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        ro.rollout_variant_chunk(state, 1000 + i, chunk_steps,
                                 episodes=total, **knobs)
    end.record()
    torch.cuda.synchronize(state.cur.device)
    ms = start.elapsed_time(end) / reps
    return dict(ms=ms, plies_per_s=batch * chunk_steps / (ms / 1e3),
                episodes=int(total.item()))


def run(batch: int = 4096, chunk_steps: int = 512, reps: int = 256,
        device=None, out=print) -> dict:
    """Every configuration of ``CONFIGS``; prints one line each and
    returns ``{name: run_config(...)}``."""
    results = {}
    for name, knobs in CONFIGS:
        r = run_config(knobs, batch, chunk_steps, reps, device)
        out(f"{name:13s}: {r['ms']:7.4f} ms/chunk -> "
            f"{r['plies_per_s'] / 1e6:9.1f} M plies/s")
        results[name] = r
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 4096
    chunk_steps = int(argv[1]) if len(argv) > 1 else 512
    if not torch.cuda.is_available():
        raise SystemExit("bench_rollout_variants times the kernels on a "
                         "CUDA card; none is available")
    print(f"device: {torch.cuda.get_device_name(0)}; batch {batch}, "
          f"{chunk_steps} plies per chunk", flush=True)
    run(batch, chunk_steps, out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
