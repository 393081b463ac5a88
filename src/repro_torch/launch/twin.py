"""Digital-twin launcher: run the OpenDT closed loop over a SURF-like trace.

    PYTHONPATH=src python -m repro_torch.launch.twin --days 7 --calibrate
    PYTHONPATH=src python -m repro_torch.launch.twin --device cpu --days 0.5

``--device cuda`` (the default) needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import OrchestratorConfig, run_surf_experiment
from repro_torch.core.calibrate import CalibrationSpec
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like


def main(argv: "list[str] | None" = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=7.0)
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--no-calibrate", dest="calibrate", action="store_false")
    ap.add_argument("--window-hours", type=float, default=3.0)
    ap.add_argument("--mode", choices=["r_only", "joint"], default="r_only")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=22)
    ap.set_defaults(calibrate=True)
    args = ap.parse_args(argv)

    dc = DatacenterConfig()
    w = make_surf22_like(SurfTraceSpec(days=args.days, seed=args.seed), dc,
                         device=args.device)
    t_bins = int(args.days * BINS_PER_DAY)
    cfg = OrchestratorConfig(
        bins_per_window=int(args.window_hours * 12),
        calibration=CalibrationSpec(mode=args.mode,
                                    refine_iters=args.refine),
        device=args.device,
    )
    t0 = time.time()
    res = run_surf_experiment(w, dc, t_bins, calibrate=args.calibrate,
                              cfg=cfg)
    wall = time.time() - t0
    print(f"twinned {args.days:g} days ({t_bins} bins, {w.num_jobs} jobs) "
          f"on {args.device} in {wall:.1f}s  "
          f"[{'calibrated' if args.calibrate else 'static'}]")
    print(f"overall MAPE: {res.overall_mape:.2f}%")
    for r in res.slo_reports:
        print(f"SLO {r.slo.name}: compliance {r.compliance:.1%} "
              f"(target >= {r.slo.min_compliance:.0%}) -> "
              f"{'MET' if r.met else 'MISSED'}")
    print(f"under-estimation fraction: {res.under_estimation_fraction:.1%}")
    print(f"window MAPEs: {np.round(res.per_window_mape, 2).tolist()[:12]} ...")
    if res.approved_proposals:
        print(f"approved proposals: {len(res.approved_proposals)}")
    return res


if __name__ == "__main__":
    main()
