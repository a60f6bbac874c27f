#!/usr/bin/env python3
"""Seconds per phase of ``chip_smoke.py`` runs, from their logs.

Every log line of ``chip_smoke.py`` is ``[tag] ... at_s=<elapsed>``. A
run of lines with one tag is charged the time from the previous line to
its last line; a tag's seconds are the sum over its runs. Given two logs
(parent, change) of runs made in one call, it prints both columns, the
difference, the whole script's seconds and each run's flagship step:

    python3 tools/phase_seconds.py PARENT_LOG [CHANGE_LOG] [--top N]
"""

import argparse
import re
import sys

LINE = re.compile(r"\[(\w+)\].*at_s=([\d.]+)")
STEP = re.compile(r"\[train_step\] batch=32 frames=240 ms_per_step=([\d.]+)")


def phase_seconds(path):
    """({tag: seconds}, the last line's at_s, the flagship step's ms)."""
    seconds, tag, last, step = {}, None, 0.0, None
    for line in open(path, encoding="utf-8", errors="replace"):
        m = STEP.match(line)
        if m:
            step = float(m.group(1))
        m = LINE.match(line)
        if not m:
            continue
        t = float(m.group(2))
        seconds[m.group(1)] = seconds.get(m.group(1), 0.0) + t - last
        tag, last = m.group(1), t
    return seconds, last, step


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--top", type=int, default=0,
                    help="only the N largest differences (0: every tag)")
    args = ap.parse_args(argv)
    runs = [phase_seconds(p) for p in args.logs]
    tags = list(dict.fromkeys(t for s, _, _ in runs for t in s))
    if len(runs) == 2:
        tags.sort(key=lambda t: -abs(runs[1][0].get(t, 0.0)
                                     - runs[0][0].get(t, 0.0)))
    if args.top:
        tags = tags[:args.top]
    for t in tags:
        cols = [s.get(t, 0.0) for s, _, _ in runs]
        diff = f" {cols[1] - cols[0]:+8.1f}" if len(cols) == 2 else ""
        print(f"{t:40s}" + "".join(f" {c:8.1f}" for c in cols) + diff)
    print(f"{'script (last at_s)':40s}" + "".join(f" {r[1]:8.1f}"
                                                 for r in runs))
    print(f"{'flagship step ms (phase 8)':40s}" + "".join(
        f" {r[2]:8.3f}" if r[2] is not None else "      --" for r in runs))


if __name__ == "__main__":
    main(sys.argv[1:])
