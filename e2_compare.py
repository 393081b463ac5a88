#!/usr/bin/env python3
"""Experiment E2's cost per window and per DES horizon, and a what-if call's,
for checkouts of the port, in turns, on one card.

Run from the repository root with the roots of the checkouts to compare,
for example a parent commit unpacked into a directory that ``.gitignore``
lists (``git archive``) and this tree, in the order parent, this, this,
parent:

    python3 e2_compare.py build/parent . . build/parent

Each argument runs in a process of its own, with that checkout's ``src/``
first on the path and its own kernel build: E2 at the paper's size (277
hosts x 16 cores, 7 days, seed 22) uncalibrated, calibrated and in joint
mode with one refine round, ``--runs`` times each.  One JSON line per
checkout gives, per mode and run, the mean and the median ms per window
over the 56 windows (``WindowRecord.sim_seconds``), the seconds of the
run's full-horizon DES (``TwinRunResult.des_seconds``, device-synchronized)
and the overall MAPE; then the what-if batch D of ``chip_smoke.py`` (E2's
week under 64 lanes, ``run_scenarios(fused_readout=True)``): the median
wall seconds a call and of its DES alone (``chip_smoke.call_and_des_seconds``,
``--runs`` turns after a warm-up call) and the schedule's sums, so that the
checkouts are seen to place alike.
The first run of a process carries its warm-up.  The script needs a card:
without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


HERE = pathlib.Path(__file__).resolve().parent


def one(root: pathlib.Path, runs: int) -> dict:
    """E2 through ``root``'s port, ``runs`` times in each mode, then the
    what-if batch D."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import dataclasses

    import torch

    import chip_smoke as cs

    from repro_torch.core import (
        CalibrationSpec, DigitalTwin, OrchestratorConfig, TraceGroundTruth)
    from repro_torch.kernels import _build
    from repro_torch.traces.schema import DatacenterConfig
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    _build.build(tuple(k for k in ("calib_mape", "des_readout", "des_place")
                       if k in _build.ENTRY_POINTS))
    dc = DatacenterConfig()
    t_bins = int(7 * BINS_PER_DAY)
    w = make_surf22_like(SurfTraceSpec(days=7.0, seed=22), dc, device="cuda")
    modes = (("uncalibrated", False, OrchestratorConfig()),
             ("calibrated", True, OrchestratorConfig()),
             ("joint", True, OrchestratorConfig(
                 calibration=CalibrationSpec(mode="joint", refine_iters=1))))
    out: dict = {"root": str(root)}
    for _ in range(runs):
        for name, calibrate, cfg in modes:
            cfg = dataclasses.replace(cfg, calibrate=calibrate, device="cuda")
            twin = DigitalTwin(w, dc, t_bins, cfg)
            res = twin.run(TraceGroundTruth(twin.orchestrator.workload, dc, t_bins).window)
            ms = [r.sim_seconds * 1e3 for r in res.records]
            out.setdefault(name, []).append(dict(
                mean_ms=statistics.fmean(ms), median_ms=statistics.median(ms),
                des_s=res.des_seconds, mape=res.overall_mape))
    out["whatif_d"] = whatif_d(torch, cs, w, dc, t_bins, runs)
    return out


def whatif_d(torch, cs, w, dc, t_bins, runs: int) -> dict:
    """``chip_smoke.py``'s what-if call at D on the card: median wall s a
    call and of its DES alone, and the schedule's sums."""
    from repro_torch.core import scenarios as psc
    from repro_torch.core.power import PowerParams
    from repro_torch.runtime import fault
    from repro_torch.traces.carbon import make_diurnal_carbon
    from repro_torch.traces.price import make_diurnal_price

    ss = psc.build_scenario_set(w, dc, cs.whatif_d(psc, fault), PowerParams())
    traces = dict(carbon_intensity=make_diurnal_carbon(t_bins), price=make_diurnal_price(t_bins))

    def call():
        return psc.run_scenarios(ss, max_hosts=ss.max_hosts, t_bins=t_bins,
                                 fused_readout=True, **traces)

    sim, _ = call()
    wall, des = cs.call_and_des_seconds(torch, call, lambda: cs.lanes_des(psc, ss, t_bins),
                                        turns=runs)
    return dict(lanes=ss.workload.submit_bin.shape[0], wall_s=wall, des_s=des,
                schedule_sums=[int(sim.job_start.long().sum()), int(sim.job_host.long().sum())])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--runs", type=int, default=3, help="E2 runs per mode and root")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("e2_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(pathlib.Path(args.roots[0]).resolve(), args.runs)))
        return 0
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", "--runs",
                               str(args.runs), root], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
