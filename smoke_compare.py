#!/usr/bin/env python3
"""Seconds each phase of ``chip_smoke.py`` takes, for checkouts of the
port, in turns, on one card.

Run from the repository root with the roots of the checkouts to compare,
for example a parent commit unpacked into a directory that ``.gitignore``
lists (``git archive``) and this tree, in the order parent, this, this,
parent:

    python3 smoke_compare.py build/parent . . build/parent

Each argument runs that checkout's own ``chip_smoke.py`` (its kernel build
included) in a process of its own and stamps each line of its standard
output with the seconds since the process started.  A phase begins at the
first line that matches its pattern in ``PHASES`` (in the order the script
runs them; a checkout that lacks a phase skips it) and ends at its last
line, so a phase's seconds run from the last line of the phase before it.
The lines go to ``chiprun_out/smoke_compare/<k>.log``; one JSON line per
run gives its exit code, its seconds in all and by phase, and a table of
the phases across runs ends the output.  A run that fails is reported and
the others go on; the script exits 1 if any failed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

#: (phase, the first line it prints), in the order chip_smoke.py runs them
PHASES = [
    ("1-2 card and build", r"^card: "),
    ("3 kernel checks", r"^calib_mape_grid "),
    ("4 E2 on the card", r"^E2 workload: "),
    ("5 E2 on the CPU", r"^CPU rerun: "),
    ("6 power_sim path", r"^power_sim on the E2 horizon"),
    ("7 what-if", r"^what-if "),
    ("8 LM serving paths", r"^LM prefill "),
    ("9 LM card vs CPU", r"^LM card vs CPU"),
    ("11 search and stage 3", r"^search "),
    ("12 serving", r"^serve \("),
    ("10 kernel timings", r"^launch floor"),
]
#: the first line after the timed phases
END = r"^(phase seconds: |chip_smoke: [0-9.]+ s in all)"


def split_phases(stamped: list[tuple[float, str]]) -> dict:
    """Seconds by phase from ``(seconds since start, line)`` pairs."""
    owner, k = [], -1
    for _, line in stamped:
        if k < len(PHASES) and re.match(END, line):
            k = len(PHASES)
        for j in range(k + 1, len(PHASES)):
            if re.match(PHASES[j][1], line):
                k = j
                break
        owner.append(k)
    last: dict[int, float] = {}
    for (t, _), k in zip(stamped, owner):
        if 0 <= k < len(PHASES):
            last[k] = t
    out, before = {}, 0.0
    for k in sorted(last):
        out[PHASES[k][0]] = last[k] - before
        before = last[k]
    return out


def run(root: pathlib.Path, log_path: pathlib.Path) -> dict:
    """``root``'s chip_smoke.py in a process of its own, lines stamped."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, bufsize=1,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    stamped = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
    rc = proc.wait()
    total = time.perf_counter() - t0
    log_path.write_text("".join(f"{t:9.2f}  {line}\n" for t, line in stamped))
    return dict(root=str(root), rc=rc, seconds=total, phases=split_phases(stamped))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=pathlib.Path,
                    help="checkouts whose chip_smoke.py to run, in this order")
    args = ap.parse_args()
    out_dir = HERE / "chiprun_out" / "smoke_compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for k, root in enumerate(args.roots):
        res = run(root.resolve(), out_dir / f"{k}.log")
        runs.append(res)
        print(json.dumps(res), flush=True)
    names = [p for p, _ in PHASES if any(p in r["phases"] for r in runs)]
    print(f"{'phase':24s}" + "".join(f"{f'{k}: ' + r['root'][-14:]:>22s}"
                                      for k, r in enumerate(runs)))
    for p in names + ["in all"]:
        cells = [r["seconds"] if p == "in all" else r["phases"].get(p) for r in runs]
        print(f"{p:24s}" + "".join(f"{'-' if c is None else f'{c:.1f}':>22s}" for c in cells))
    return 1 if any(r["rc"] != 0 for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
