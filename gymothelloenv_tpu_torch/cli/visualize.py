"""Training-curve plots from ``MetricsLogger`` JSONL runs — the port of
``cli/visualize.py`` (the reference's visualize.ipynb over
logs/*/0.monitor.csv).

Usage:
    python -m gymothelloenv_tpu_torch.cli.visualize RUN_DIR [RUN_DIR ...] \
        --metrics "win%(rand)" "win%(greedy)" --out curves.png

Each RUN_DIR is a ``--log-dir`` of a trainer CLI (it holds
``metrics.jsonl``).  Without ``--metrics`` every numeric metric of the
runs gets a panel; several runs (seeds) overlay in each panel with an
exponential smoothing (``--smooth``), the notebook's
``smooth_reward_curve``.  Drawing needs ``matplotlib``; without it
``main`` raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_run(run_dir: str) -> dict:
    """metrics.jsonl -> {metric: (steps list, values list)}."""
    path = os.path.join(run_dir, "metrics.jsonl")
    series: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = rec.get("step", 0)
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(
                        v, (int, float)):
                    continue
                series.setdefault(k, ([], []))
                series[k][0].append(step)
                series[k][1].append(float(v))
    return series


def smooth(values, alpha: float):
    if alpha <= 0 or len(values) < 3:
        return values
    out, acc = [], values[0]
    for v in values:
        acc = alpha * acc + (1 - alpha) * v
        out.append(acc)
    return out


def _pyplot():
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("cli.visualize draws with matplotlib, which is "
                          "not installed; load_run and smooth work "
                          "without it") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.visualize")
    parser.add_argument("runs", nargs="+", help="log dirs with "
                        "metrics.jsonl (one per run/seed)")
    parser.add_argument("--metrics", nargs="*", default=None,
                        help="metric names to plot (default: all numeric)")
    parser.add_argument("--smooth", type=float, default=0.6,
                        help="EMA smoothing factor in [0,1); 0 disables")
    parser.add_argument("--out", type=str, default="curves.png")
    parser.add_argument("--cols", type=int, default=3)
    args = parser.parse_args(argv)

    plt = _pyplot()

    if not 0.0 <= args.smooth < 1.0:
        parser.error(f"--smooth must be in [0, 1), got {args.smooth}")

    runs = {r: load_run(r) for r in args.runs}
    all_metrics = sorted({m for s in runs.values() for m in s})
    metrics = args.metrics or all_metrics
    missing = [m for m in metrics if m not in all_metrics]
    if missing:
        print(f"warning: metrics absent from every run: {missing}",
              file=sys.stderr)
    metrics = [m for m in metrics if m in all_metrics]
    if not metrics:
        print("no plottable metrics found", file=sys.stderr)
        return 1

    cols = max(1, min(args.cols, len(metrics)))
    rows = (len(metrics) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows),
                             squeeze=False)
    for i, metric in enumerate(metrics):
        ax = axes[i // cols][i % cols]
        for run_dir, series in runs.items():
            if metric not in series:
                continue
            steps, values = series[metric]
            label = os.path.basename(os.path.normpath(run_dir))
            ax.plot(steps, smooth(values, args.smooth), label=label,
                    linewidth=1.5)
            if args.smooth > 0:
                ax.plot(steps, values, alpha=0.2, linewidth=0.8,
                        color=ax.lines[-1].get_color())
        ax.set_title(metric)
        ax.set_xlabel("step")
        if len(runs) > 1:
            ax.legend(fontsize=7)
    for j in range(len(metrics), rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out} ({len(metrics)} panels, {len(runs)} runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
