"""Seed-sweep experiment launcher — the port of ``cli/sweep.py`` (the
reference's tmuxp generator, pytorch_a2c_ppo_acktr_gail/
generate_tmux_yaml.py + run_all.yaml): one of the port's trainer CLIs,
``--num-seeds`` times, written as

  * ``--format script`` (default): a shell script running the sweep
    sequentially, with ``--settle-seconds`` of pause between runs (0 by
    default: no pause);
  * ``--format yaml``: a tmuxp-style session file, a window a seed (needs
    the ``yaml`` package);
  * ``--format run``: the sweep run sequentially from here.

Each run gets ``--seed <s>`` and ``--log-dir <out>/<name>-<s>``, so
``cli.visualize`` can overlay the runs' JSONL curves.

Usage:
    python -m gymothelloenv_tpu_torch.cli.sweep --trainer ppo_self_play \
        --num-seeds 4 --out-dir data/sweeps/ppo -- --num-updates 2000
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time

TRAINERS = ("ppo_self_play", "dqn_train", "rainbow_train", "a2c_train",
            "acktr_train", "gail_train", "run_self_play",
            "teacher_vs_student")

# Seconds between runs; a sweep on the card needs no pause.
SETTLE_SECONDS = 0


def build_commands(trainer: str, num_seeds: int, base_seed: int,
                   out_dir: str, extra: list[str]) -> list[list[str]]:
    cmds = []
    for i in range(num_seeds):
        seed = base_seed + i
        log_dir = os.path.join(out_dir, f"{trainer}-{seed}")
        cmds.append([sys.executable, "-m",
                     f"gymothelloenv_tpu_torch.cli.{trainer}",
                     "--seed", str(seed), "--log-dir", log_dir] + extra)
    return cmds


def main(argv=None) -> list[list[str]]:
    """Writes (or runs) the sweep; returns its commands."""
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.sweep")
    parser.add_argument("--trainer", choices=TRAINERS,
                        default="ppo_self_play")
    parser.add_argument("--num-seeds", type=int, default=4)
    parser.add_argument("--base-seed", type=int, default=0)
    parser.add_argument("--out-dir", type=str, default="data/sweeps")
    parser.add_argument("--format", choices=("script", "yaml", "run"),
                        default="script")
    parser.add_argument("--output", type=str, default="",
                        help="script/yaml destination "
                             "(default <out-dir>/run_all.{sh,yaml})")
    parser.add_argument("--settle-seconds", type=float,
                        default=SETTLE_SECONDS,
                        help="pause between runs of the script or run "
                             "formats (0: none)")
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, extra = argv[:split], argv[split + 1:]
    args = parser.parse_args(argv)

    cmds = build_commands(args.trainer, args.num_seeds, args.base_seed,
                          args.out_dir, extra)
    os.makedirs(args.out_dir, exist_ok=True)
    settle = args.settle_seconds

    if args.format == "script":
        path = args.output or os.path.join(args.out_dir, "run_all.sh")
        lines = ["#!/bin/sh", "set -e"]
        # Freeze the launching environment's import path so the script
        # works from a fresh shell (the package is usually run via
        # PYTHONPATH, not installed).
        pythonpath = os.environ.get("PYTHONPATH")
        if pythonpath:
            lines.append(f"export PYTHONPATH={shlex.quote(pythonpath)}")
        for i, cmd in enumerate(cmds):
            if i and settle > 0:
                lines.append(f"sleep {settle:g}")
            lines.append(shlex.join(cmd))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.chmod(path, 0o755)
        print(f"wrote {path} ({len(cmds)} runs)")
    elif args.format == "yaml":
        import yaml
        config = {"session_name": f"sweep-{args.trainer}", "windows": []}
        for i, cmd in enumerate(cmds):
            config["windows"].append({
                "window_name": f"seed-{args.base_seed + i}",
                "panes": [shlex.join(cmd)],
            })
        path = args.output or os.path.join(args.out_dir, "run_all.yaml")
        with open(path, "w") as f:
            yaml.dump(config, f, default_flow_style=False)
        print(f"wrote {path} ({len(cmds)} runs)")
    else:
        for i, cmd in enumerate(cmds):
            if i and settle > 0:
                time.sleep(settle)
            print(f"[sweep {i + 1}/{len(cmds)}] {shlex.join(cmd)}",
                  flush=True)
            subprocess.run(cmd, check=True)
    return cmds


if __name__ == "__main__":
    main()
