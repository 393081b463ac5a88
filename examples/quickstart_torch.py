"""Quickstart on the PyTorch port: twin one day of datacenter operation
and self-calibrate.

The counterpart of ``examples/quickstart.py``, with its lines (plus
``--device`` and the size flags).  The closed loop of the paper's stages
1-2 runs through ``repro_torch.core.run_surf_experiment``: every 3-hour
window predicts with the pipelined power parameters (one ``des_readout``
launch), is scored against the hidden-model telemetry, and recalibrates
over the history (``calib_mape_grid``); the full-horizon DES behind the
twin and behind the telemetry is one ``des_place`` launch each.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import OrchestratorConfig, run_surf_experiment
from repro_torch.core.twin import TwinRunResult
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like


@dataclasses.dataclass
class QuickstartResult:
    result: TwinRunResult
    mean_util: float


def main(argv=None) -> QuickstartResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--hosts", type=int, default=DatacenterConfig.num_hosts)
    ap.add_argument("--seed", type=int, default=SurfTraceSpec.seed)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A datacenter (SURF-SARA topology: 277 hosts x 16 cores @ 2.1 GHz)
    dc = DatacenterConfig(num_hosts=args.hosts)

    # 2. A workload trace (synthetic SURF-22; swap in your own Workload)
    workload = make_surf22_like(SurfTraceSpec(days=args.days, seed=args.seed), dc,
                                device=dev)

    # 3. Twin it, closed loop: telemetry -> simulate -> calibrate -> SLOs
    result = run_surf_experiment(
        workload, dc, t_bins=int(args.days * BINS_PER_DAY),
        calibrate=True,
        cfg=OrchestratorConfig(bins_per_window=36, device=str(dev)),   # 3 h windows
    )

    print(f"windows twinned      : {len(result.records)}")
    print(f"overall MAPE         : {result.overall_mape:.2f}%")
    for rep in result.slo_reports:
        print(f"SLO {rep.slo.name:15s}: {rep.compliance:.1%} compliant "
              f"-> {'MET' if rep.met else 'MISSED'}")
    print(f"under-estimation     : {result.under_estimation_fraction:.1%} "
          "of samples")
    last = result.records[-1].params
    p_idle, p_max, r = (float(last.p_idle), float(last.p_max), float(last.r))
    print(f"calibrated power fit : P(u) = {p_idle:.1f} + "
          f"({p_max:.1f} - {p_idle:.1f}) * (2u - u^{r:.2f})")
    mean_util = float(np.mean(
        [float(rec.prediction.utilization.mean()) for rec in result.records]))
    print(f"mean utilization     : {mean_util:.1%}  "
          f"({'under' if mean_util < 0.3 else 'well'}-utilized; "
          "paper §3.3 insight)")
    return QuickstartResult(result, mean_util)


if __name__ == "__main__":
    main()
