"""E1 on the PyTorch port: reproduce the FootPrinter comparison and extend
it (paper §3.3, Fig. 4/5).

The counterpart of ``examples/reproduce_footprinter.py``, with its lines
(plus ``--device`` and the size flags).  It carries its own copy of E1's
``footprinter_day1_fit`` and ``run`` (``benchmarks/e1_footprinter.py``).

FootPrinter [30]: a linear host power model, hand-tuned ONCE on the first
day of telemetry (least squares on aggregate power vs. aggregate busy
cores), then run once over the full horizon — no recalibration.
OpenDT: the generic OpenDC analytical model, continuously predicting at the
5-minute industry granularity (uncalibrated in E1; E2 adds calibration).
On the card the ground truth's DES and the twin's are one ``des_place``
launch each, and every window's prediction one ``des_readout``.

    PYTHONPATH=src python examples/reproduce_footprinter_torch.py
    PYTHONPATH=src python examples/reproduce_footprinter_torch.py --device cpu --days 2

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import OrchestratorConfig, mape, run_surf_experiment
from repro_torch.core.twin import TraceGroundTruth
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

DAYS = 7.0


def footprinter_day1_fit(u_th: np.ndarray, real: np.ndarray) -> np.ndarray:
    """Hand-tuned linear model: lstsq fit P ~ a + b * sum(u) on day 1."""
    su = u_th.sum(axis=1)
    d1 = slice(0, BINS_PER_DAY)
    A = np.stack([np.ones_like(su[d1]), su[d1]], axis=1)
    coef, *_ = np.linalg.lstsq(A, real[d1], rcond=None)
    return coef[0] + coef[1] * su


def run(days: float = DAYS, seed: int = 22, *, device: str = "cuda",
        num_hosts: int = DatacenterConfig.num_hosts) -> dict:
    dev = resolve_device(device)
    dc = DatacenterConfig(num_hosts=num_hosts)
    w = make_surf22_like(SurfTraceSpec(days=days, seed=seed), dc, device=dev)
    t_bins = int(days * BINS_PER_DAY)

    t0 = time.time()
    truth = TraceGroundTruth(w, dc, t_bins)
    real = truth.power
    u = truth.u_th.astype(np.float64)

    # FootPrinter baseline (run once)
    fp = footprinter_day1_fit(u, real)
    fp_mape = float(mape(torch.as_tensor(real, dtype=torch.float32, device=dev),
                         torch.as_tensor(fp.astype(np.float32), device=dev)))

    # OpenDT continuous, uncalibrated (E1 does not calibrate)
    res = run_surf_experiment(w, dc, t_bins, calibrate=False,
                              cfg=OrchestratorConfig(device=str(dev)))
    wall = time.time() - t0

    # Extension (Fig. 5B/C): performance + efficiency from the same run
    def stream(field):
        return np.concatenate([getattr(r.prediction, field).cpu().numpy()
                               for r in res.records])

    tflops, energy, util = stream("tflops"), stream("energy_kwh"), stream("utilization")
    # discretize per hour like the paper (12 x 5-min bins)
    hours = len(tflops) // 12
    tf_h = tflops[: hours * 12].reshape(hours, 12).mean(1)
    en_h = energy[: hours * 12].reshape(hours, 12).sum(1)
    eff_h = tf_h / np.maximum(en_h, 1e-9)

    return {
        "footprinter_mape": fp_mape,
        "opendt_mape": res.overall_mape,
        "improvement_pp": fp_mape - res.overall_mape,
        "paper_footprinter_mape": 7.86,
        "paper_opendt_mape": 5.13,
        "mean_utilization": float(util.mean()),
        "peak_tflops_hour": float(tf_h.max()),
        "mean_tflops": float(tf_h.mean()),
        "best_efficiency_tflops_per_kwh": float(eff_h.max()),
        "efficiency_at_peak_perf": float(eff_h[int(np.argmax(tf_h))]),
        "underutilization_insight": bool(util.mean() < 0.30),
        "wall_seconds": wall,
        "per_window_mape": [float(x) for x in res.per_window_mape],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", type=float, default=DAYS)
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--hosts", type=int, default=DatacenterConfig.num_hosts)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.days, args.seed, device=args.device, num_hosts=args.hosts)
    print(json.dumps({k: v for k, v in res.items() if k != "per_window_mape"},
                     indent=2))
    print()
    print(f"FootPrinter (hand-tuned, run once) MAPE : "
          f"{res['footprinter_mape']:.2f}%   (paper: 7.86%)")
    print(f"OpenDT continuous (uncalibrated)  MAPE : "
          f"{res['opendt_mape']:.2f}%   (paper: 5.13%)")
    print(f"-> OpenDT better by {res['improvement_pp']:.2f} pp; "
          f"extension: best efficiency "
          f"{res['best_efficiency_tflops_per_kwh']:.2f} TFLOPs/kWh at "
          f"peak performance {res['peak_tflops_hour']:.1f} TFLOP/s")
    return res


if __name__ == "__main__":
    main()
