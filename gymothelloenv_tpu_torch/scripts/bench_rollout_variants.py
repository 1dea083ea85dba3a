"""Cost attribution inside the fused rollout kernel (K3).

Times kernel variants that stub out one component each, so the per-ply
budget (sampler vs flip flood vs the mover-again legal flood) is measured
rather than guessed, plus K1 at other block sizes and unroll factors.  The
variants change ONLY the stubbed component; they are not valid games
(except ``full``): this is a profiling tool.  Port of
``scripts/bench_rollout_variants.py`` (``main`` / ``run_config``).

Usage: python -m gymothelloenv_tpu_torch.scripts.bench_rollout_variants \
    [batch] [chunk] [lanes]

Every configuration runs at ``lanes`` threads a game (default: what K1
runs at for ``batch``, ``ops.rollout.rollout_lanes``), so the profile
attributes the kernel K1 launches.  The stubbed variants and unroll 2/4
are built at lanes 1 and ``BENCH_LANES`` only (``ops.rollout.BUILT``): at
another lanes the tool stops before timing anything and names the lanes
that are built and the batches at which K1 runs them.  Each configuration
runs ``reps`` chunks back to back on the card, timed by two CUDA events and
one synchronisation at the end.  A configuration that fails to launch
raises.
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


def configs(lanes: int) -> tuple:
    """The (name, knobs) run at ``lanes`` threads a game."""
    return tuple((name, dict(knobs, lanes=lanes)) for name, knobs in CONFIGS)


def _batches(lanes: int) -> str:
    """The batches at which ``rollout_lanes`` picks ``lanes``."""
    lo = ro.SCHEDULER_THREADS // (2 * lanes) + 1
    hi = ro.SCHEDULER_THREADS // lanes
    if lanes == 1:
        return f"batch >= {lo}"
    if lanes == ro.LANES[-1]:
        return f"batch <= {hi}"
    return f"batch {lo}-{hi}"


def check_built(lanes: int) -> None:
    """Raise ``ValueError`` unless every configuration is built at
    ``lanes``, naming the lanes that are."""
    missing = [name for name, knobs in configs(lanes)
               if not ro.built(knobs["variant"], knobs.get("unroll", 1),
                               lanes)]
    if missing:
        have = [each for each in ro.LANES
                if all(ro.built(k["variant"], k.get("unroll", 1), each)
                       for _, k in CONFIGS)]
        raise ValueError(
            f"{', '.join(missing)} not built at lanes {lanes}; the profiler "
            "runs at lanes " + ", ".join(
                f"{each} (K1's at {_batches(each)})" for each in have)
            + "; pass one of them as the third argument")


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
        device=None, out=print, lanes: int | None = None) -> dict:
    """Every configuration of ``configs(lanes)`` (``lanes`` default:
    ``rollout_lanes(batch)``); prints one line each and returns
    ``{name: run_config(...)}``.  Raises ``ValueError`` before timing
    anything when a configuration is not built at ``lanes``."""
    if lanes is None:
        lanes = ro.rollout_lanes(batch)
    check_built(lanes)
    results = {}
    for name, knobs in configs(lanes):
        r = run_config(knobs, batch, chunk_steps, reps, device)
        out(f"{name:13s}: {r['ms']:7.4f} ms/chunk -> "
            f"{r['plies_per_s'] / 1e6:9.1f} M plies/s")
        results[name] = r
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 4096
    chunk_steps = int(argv[1]) if len(argv) > 1 else 512
    lanes = int(argv[2]) if len(argv) > 2 else ro.rollout_lanes(batch)
    if not torch.cuda.is_available():
        raise SystemExit("bench_rollout_variants times the kernels on a "
                         "CUDA card; none is available")
    try:
        check_built(lanes)
    except ValueError as e:
        raise SystemExit(f"bench_rollout_variants: {e}") from None
    print(f"device: {torch.cuda.get_device_name(0)}; batch {batch}, "
          f"{chunk_steps} plies per chunk, {lanes} threads a game",
          flush=True)
    run(batch, chunk_steps, out=lambda line: print(line, flush=True),
        lanes=lanes)


if __name__ == "__main__":
    main()
