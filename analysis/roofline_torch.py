"""Live roofline of the masked-DES hot path (placement vs readout), on the
PyTorch port: the counterpart of ``analysis/roofline.py``.

The JAX script asks the XLA compiler for the cost of the program every
scenario lane pays for and splits placement from readout by compiling a
wrapper that drops the readout.  Here the two halves are the port's own
functions, run and counted apart: the placement is
``core.desim._place_masked`` (one ``des_place`` launch) and the readout
``core.desim._read_out_placed`` on its result; ``total`` is
``simulate_utilization_masked``, both in one call.  Each is counted with
``analysis.cost.trace_cost``: FLOPs as the flop counter counts them
(the dot-like products; ``des_place`` by its formula,
``kernels.ops.des_place_ops``) and bytes as each op's operands and
results, ``des_place`` one op.  The count is the same on the card and on
the CPU.

Per phase: ``wall_s`` (on the card, ``torch.cuda.synchronize`` around 5
calls after a warm-up), ``flops``, ``bytes``, the achieved GFLOP/s, GB/s
and FLOP/byte, and ``bound_s``: the larger of the bytes at the H100's
HBM rate and the operations at its f32 rate (``analysis/roofline.py``'s
constants; the DES runs no tensor-core product).

Usage::

    PYTHONPATH=src python analysis/roofline_torch.py                # on the card
    PYTHONPATH=src python analysis/roofline_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.cost import trace_cost
from repro_torch.analysis.roofline import HBM_BW
from repro_torch.core.desim import _place_masked, _read_out_placed, simulate_utilization_masked
from repro_torch.traces.schema import DatacenterConfig, host_mask
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

#: H100 SXM5 dense f32 rate on the CUDA cores (FLOP/s), the kernel table's
F32_FLOPS = 67e12


def _time(fn, cuda: bool, n: int = 5) -> float:
    fn()                                  # warm-up
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def _phase(name: str, cost: dict, wall_s: float) -> dict:
    flops, nbytes = cost["flops_per_device"], cost["bytes_per_device"]
    return {"name": name, "wall_s": wall_s, "flops": flops, "bytes": nbytes,
            "gflop_per_s": flops / wall_s / 1e9 if wall_s > 0 else None,
            "gb_per_s": nbytes / wall_s / 1e9 if wall_s > 0 else None,
            "flop_per_byte": flops / nbytes if nbytes > 0 else None,
            "bound_s": max(nbytes / HBM_BW, flops / F32_FLOPS)}


def _phases(days: float, dc: DatacenterConfig | None, device) -> tuple:
    """``(workload, t_bins, dc, {phase: fn})``: the DES over ``days`` of
    the SURF-22-like workload on ``device`` as its placement, its readout
    (of one placement made here) and the two together."""
    dc = dc or DatacenterConfig()
    dev = resolve_device(device)
    w = make_surf22_like(SurfTraceSpec(days=days), dc, device=dev)
    t_bins = int(days * BINS_PER_DAY)
    mask = host_mask(dc.num_hosts, dc.num_hosts).to(dev)
    cores = torch.as_tensor(dc.cores_per_host, dtype=torch.int32, device=dev)
    kw = dict(max_hosts=dc.num_hosts, t_bins=t_bins)

    def place():
        return _place_masked(w, mask, cores, max_starts_per_bin=64, policy_id=None,
                             backfill_depth=0, max_backfill=0, **kw)

    placed = place()
    return w, t_bins, dc, {
        "placement_scan": place,
        "post_scan_readout": lambda: _read_out_placed(placed, force_chunked_readout=False, **kw),
        "total": lambda: simulate_utilization_masked(w, mask, cores, **kw),
    }


def phase_costs(days: float = 2.0, dc: DatacenterConfig | None = None,
                device: "str | torch.device" = "cuda") -> dict:
    """``trace_cost`` of each phase (its FLOPs, bytes and ops), untimed."""
    _, _, _, fns = _phases(days, dc, device)
    out = {}
    for name, fn in fns.items():
        c = trace_cost(fn)
        del c["out"]
        out[name] = c
    return out


def analyze_des_hot_path(days: float = 2.0, dc: DatacenterConfig | None = None,
                         device: "str | torch.device" = "cuda") -> dict:
    """Roofline coordinates of the placement and readout phases of the
    DES over ``days`` of the SURF-22-like workload on ``device``; the JAX
    script's keys, plus ``bound_s`` a phase."""
    w, t_bins, dc, fns = _phases(days, dc, device)
    costs = {}
    for name, fn in fns.items():
        costs[name] = trace_cost(fn)
        del costs[name]["out"]
    cuda = resolve_device(device).type == "cuda"
    return {
        "days": days,
        "t_bins": t_bins,
        "num_hosts": dc.num_hosts,
        "jobs": int(w.duration_bins.shape[0]),
        "cost_analysis_available": True,
        "phases": [_phase(n, costs[n], _time(fns[n], cuda)) for n in fns],
    }


def table(result: dict) -> str:
    hdr = (f"{'phase':20s} {'wall_s':>9s} {'GFLOP':>9s} {'GB':>9s} "
           f"{'GFLOP/s':>9s} {'GB/s':>8s} {'FLOP/B':>7s} {'bound_s':>10s}")
    rows = [hdr, "-" * len(hdr)]

    def fmt(v, scale=1.0, spec=".3f"):
        return "--" if v is None else format(v / scale, spec)

    for p in result["phases"]:
        rows.append(
            f"{p['name']:20s} {p['wall_s']:9.4f} "
            f"{fmt(p['flops'], 1e9):>9s} {fmt(p['bytes'], 1e9):>9s} "
            f"{fmt(p['gflop_per_s']):>9s} {fmt(p['gb_per_s']):>8s} "
            f"{fmt(p['flop_per_byte'], 1.0, '.2f'):>7s} {p['bound_s']:10.3e}")
    return "\n".join(rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = analyze_des_hot_path(args.days, device=args.device)
    print(f"masked DES hot path: {res['t_bins']} bins x "
          f"{res['num_hosts']} hosts, {res['jobs']} jobs on {args.device}")
    print(table(res))
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
