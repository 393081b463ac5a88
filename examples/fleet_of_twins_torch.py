"""Fleet twinning on the PyTorch port: D datacenters, one batched step a
window.

The counterpart of ``examples/fleet_of_twins.py``, with its sites, hidden
power models and lines (plus ``--device`` and the size flags).  The JAX
package ``vmap``s ``twin_step`` and scans it over the horizon; here
``repro_torch.core.twin.run_fleet`` steps every lane of the stacked fleet
state at once, each window: one ``des_readout`` launch for the D
predictions and one ``calib_mape_grid`` launch for the D grid searches,
each lane over its own candidate row.

This example twins 4 regional datacenters sharing one padded topology but
with different workload intensities and different *hidden* power models
(per-site hardware variation, paper §2.4).  Per window, each lane predicts
with its own pipelined calibration result, scores against its own telemetry
and recalibrates — D grid searches, D MAPE streams, one batched step.

    PYTHONPATH=src python examples/fleet_of_twins_torch.py
    PYTHONPATH=src python examples/fleet_of_twins_torch.py --device cpu

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.power import PowerParams, opendc_power
from repro_torch.core.state import SimSlice, TelemetrySlice, TwinConfig, TwinState, init_twin_state
from repro_torch.core.twin import index_twin_state, run_fleet, stack_twin_states
from repro_torch.traces.schema import DatacenterConfig

NUM_DC = 4
HOSTS = 32
BINS = 36          # one 3 h window at 5-min sampling
WINDOWS = 8

#: per-site hidden reality the calibrator must discover (r* per region)
HIDDEN_R = [1.6, 2.4, 3.1, 3.8]
UTIL_MEAN = [0.25, 0.40, 0.55, 0.70]


def synth_site(seed: int, r_star: float, util_mean: float, *, windows: int = WINDOWS,
               bins: int = BINS, hosts: int = HOSTS):
    """Synthetic utilization + hidden-model power telemetry for one site
    (numpy draws; the hidden model is the port's ``opendc_power`` in f32 on
    the host)."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.normal(util_mean, 0.15, (windows, bins, hosts)),
                0.0, 1.0).astype(np.float32)
    hidden = PowerParams(p_idle=72.0, p_max=365.0, r=r_star)
    p = opendc_power(torch.from_numpy(u), hidden).sum(dim=-1).numpy().astype(np.float32)
    p *= 1.0 + rng.normal(0, 0.01, p.shape)        # meter noise
    return u, p.astype(np.float32)


@dataclasses.dataclass
class FleetResult:
    final: TwinState            # the fleet's state after the last window
    mape: np.ndarray            # [W, D] window MAPE
    r: np.ndarray               # [D] calibrated exponent per site
    outputs: object             # the stacked WindowOutput [W, D, ...]


def main(argv=None) -> FleetResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=HOSTS)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--bins", type=int, default=BINS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    windows = args.windows

    dc = DatacenterConfig(num_hosts=args.hosts, cores_per_host=16)
    cfg = TwinConfig(bins_per_window=args.bins, dc=dc, device=str(dev))
    fleet = stack_twin_states([init_twin_state(cfg) for _ in range(NUM_DC)])

    sites = [synth_site(11 + d, HIDDEN_R[d], UTIL_MEAN[d], windows=windows,
                        bins=args.bins, hosts=args.hosts)
             for d in range(NUM_DC)]
    u_all = np.stack([s[0] for s in sites], axis=1)    # [W, D, BINS, HOSTS]
    p_all = np.stack([s[1] for s in sites], axis=1)    # [W, D, BINS]
    u_dev = torch.as_tensor(u_all, device=dev)
    telem = TelemetrySlice(u_th=u_dev,
                           power_w=torch.as_tensor(p_all, device=dev),
                           valid=torch.ones((windows, NUM_DC), dtype=torch.bool,
                                            device=dev))
    sims = SimSlice(u_th=u_dev)

    final, outs = run_fleet(fleet, telem, sims)        # one batched step a window
    mape = outs.mape.cpu().numpy()                     # [W, D]

    print(f"fleet of {NUM_DC} datacenters x {windows} windows, "
          f"one batched step a window ({args.hosts} hosts each)")
    print(f"{'window':>6s} " + " ".join(f"{f'dc{d} MAPE%':>10s}"
                                        for d in range(NUM_DC)))
    for w in range(windows):
        print(f"{w:6d} " + " ".join(f"{mape[w, d]:10.2f}"
                                    for d in range(NUM_DC)))

    print("\ncalibrated exponent per site (hidden r* in parentheses):")
    r = np.empty(NUM_DC, np.float32)
    for d in range(NUM_DC):
        st = index_twin_state(final, d)
        r[d] = float(st.params.r)
        print(f"  dc{d}: r = {r[d]:.2f} "
              f"(r* = {HIDDEN_R[d]:.2f}), "
              f"window MAPE {mape[:, d].mean():.2f}% mean")

    print("\nReading: each lane converges toward its own hidden hardware "
          "model — the fleet\nshares one batched step, not one calibration.")
    return FleetResult(final, mape, r, outs)


if __name__ == "__main__":
    main()
