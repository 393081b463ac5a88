"""The output check's control: the plain reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place at a
cell's own size, and judged by the same check as a run.

    python3 twinbench/control.py --workload <cell> --seeds 11,12,13 [--units N]

Prints one JSON line a seed with each compared number beside its limit; every
seed has to fail at least one of them.  ``--units`` is the number of
requests a run finishes; the check samples ``requests`` of them (a what-if
request's lanes, or a replay's every window).  It needs no card: the
reference runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seed: int, units: int):
    import torch

    from twinbench.drivers import replay, whatif
    from twinbench.harness import seeds, surf22

    cfg, tr = cell.config, cell.traffic
    weeks = [surf22.make_week(cfg["trace"], cfg["datacenter"], seeds.derive(seed, seeds.WEEKS, i))
             for i in range(tr["pool_weeks"])]
    n = min(units, tr["check"]["requests"])
    if tr["driver"] == "whatif":
        items = [(k, None, None, None, None) for k in range(n)]
        return whatif.check(items, weeks, whatif.lanes_of(tr), cfg, tr, seed,
                            control=torch.bfloat16)
    windows = weeks[0]["t_bins"] // cfg["twin"]["bins_per_window"]
    return replay.check([(k, None) for k in range(n)], weeks, windows, cfg, tr, seed,
                        dtype=torch.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from twinbench.harness import files

    cell = files.Cell(args.workload)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = readings(cell, seed, args.units)
        failed_all &= not checks.passed
        print(json.dumps({"workload": cell.name, "seed": seed, "control_passed": checks.passed,
                          "seconds": time.perf_counter() - t0, "checks": checks.items}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
