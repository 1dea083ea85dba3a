"""Compare an n-game tournament log against the reference README table
with binomial confidence intervals — the port of
``scripts/tournament_ci.py``, pure Python, with its own copy of the
table.

Reads the ``cli.tournament`` per-pair lines from a log file (or stdin),
computes a 95% CI for each cell's black-win PROBABILITY (Wilson
interval, draws excluded from the trials the same way for both sides),
and checks whether the reference's 100-game point estimate
(README.md:46-50) falls inside.  Cells that don't contain the reference
point are listed with the z-distance.

The lines are ``cli/tournament.py``'s or ``tournament_big.py``'s.

Usage:
    python -m gymothelloenv_tpu_torch.scripts.tournament_ci \
        data/logs/queue/70_tournament1000.log
"""

from __future__ import annotations

import math
import re
import sys

# README.md:46-50 (rows play black): W/D/L per (black, white) pair.
REFERENCE = {
    ("rand", "rand"): (48, 6, 46),
    ("rand", "greedy"): (38, 1, 61),
    ("rand", "maximin-1"): (38, 1, 61),
    ("rand", "maximin-2"): (32, 4, 64),
    ("rand", "maximin-3"): (13, 2, 85),
    ("greedy", "rand"): (61, 5, 34),
    ("greedy", "greedy"): (42, 4, 54),
    ("greedy", "maximin-1"): (42, 4, 54),
    ("greedy", "maximin-2"): (27, 3, 70),
    ("greedy", "maximin-3"): (25, 1, 74),
    ("maximin-1", "rand"): (61, 5, 34),
    ("maximin-1", "greedy"): (42, 4, 54),
    ("maximin-1", "maximin-1"): (42, 4, 54),
    ("maximin-1", "maximin-2"): (27, 3, 70),
    ("maximin-1", "maximin-3"): (25, 1, 74),
    ("maximin-2", "rand"): (72, 1, 27),
    ("maximin-2", "greedy"): (67, 1, 32),
    ("maximin-2", "maximin-1"): (67, 1, 32),
    ("maximin-2", "maximin-2"): (35, 1, 64),
    ("maximin-2", "maximin-3"): (33, 2, 65),
    ("maximin-3", "rand"): (78, 3, 19),
    ("maximin-3", "greedy"): (66, 4, 30),
    ("maximin-3", "maximin-1"): (66, 4, 30),
    ("maximin-3", "maximin-2"): (63, 2, 35),
    ("maximin-3", "maximin-3"): (46, 1, 53),
}

LINE = re.compile(r"\s*(\S+)\s+\(B\) vs (\S+)\s+\(W\):\s+"
                  r"(\d+)\s*/\s*(\d+)\s*/\s*(\d+)")


def wilson(p_hat: float, n: int, z: float = 1.96):
    denom = 1 + z * z / n
    center = (p_hat + z * z / (2 * n)) / denom
    half = z * math.sqrt(p_hat * (1 - p_hat) / n
                         + z * z / (4 * n * n)) / denom
    return center - half, center + half


def main(argv=None) -> list:
    """Prints the report; returns its rows, ``(z, pair, ours, reference,
    (lo, hi), consistent)`` by descending z."""
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    cells = {}
    for m in LINE.finditer(text):
        b, w, bw, d, ww = m.group(1), m.group(2), *map(int, m.group(3, 4, 5))
        cells[(b, w)] = (bw, d, ww)
    if not cells:
        sys.exit("no tournament lines found")

    inside = outside = 0
    report = []
    for pair, (bw, d, ww) in sorted(cells.items()):
        ref = REFERENCE.get(pair)
        if ref is None:
            continue
        n = bw + ww                       # decisive games
        if n == 0:
            print(f"    {pair[0]:>10} vs {pair[1]:<10} all draws "
                  f"({d}), skipped")
            continue
        p = bw / n
        lo, hi = wilson(p, n)
        rn = ref[0] + ref[2]
        rp = ref[0] / rn
        # The reference point itself is a 100-game estimate: allow its
        # own binomial sd in the comparison (two-sample z).
        sd = math.sqrt(p * (1 - p) / n + rp * (1 - rp) / rn)
        z = abs(p - rp) / max(sd, 1e-9)
        ok = z < 1.96
        inside += ok
        outside += not ok
        report.append((z, pair, (bw, d, ww), ref, (lo, hi), ok))

    report.sort(reverse=True)
    print(f"{inside} cells consistent with README (two-sample z<1.96), "
          f"{outside} outside:")
    for z, pair, ours, ref, (lo, hi), ok in report:
        flag = "   " if ok else "***"
        print(f"{flag} {pair[0]:>10} vs {pair[1]:<10} ours={ours} "
              f"p_black={ours[0]/(ours[0]+ours[2]):.3f} "
              f"CI=({lo:.3f},{hi:.3f}) ref={ref} z={z:.2f}")
    return report


if __name__ == "__main__":
    main()
