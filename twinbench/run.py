"""Run one cell of the twin's benchmark on an NVIDIA GPU and print its result.

    python twinbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``twinbench/workloads/<cell>.json``)
names its configuration and traffic mix; the traffic names its driver, which
sets up, warms up, measures for ``--seconds`` and checks its outputs against
the plain reference.  With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from the
device trace of the window.  The last line of standard output is the result,
one JSON object.  Without enough cards the run exits with code 3, without
the port's sources with 2, and with 4 if the window loaded JAX or the JAX
package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(CHECKOUT))
    from twinbench.harness import device, files, guard, report

    cell = files.Cell(args.workload)
    src = CHECKOUT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"twinbench: the port's package is not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    _caches()
    import torch

    device.require_cards(torch, cell.chips)
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    print(f"twinbench: {cell.name} on {device.power_limit()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; peaks {device.PEAK_F32_FLOPS:.3g} FLOP/s f32, "
          f"{device.PEAK_HBM_BYTES_PER_S:.3g} B/s", file=sys.stderr)
    out = files.driver(cell.traffic["driver"]).run(
        cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace), device=dev,
        t_start=T_START)
    print(f"twinbench: {out.attempted} attempted in the window, set-up "
          f"{out.metrics['setup_s']:.3f} s, output check {out.run.get('check_s', 0.0):.3f} s"
          + (f", trace read {out.trace.read_s:.3f} s" if out.trace is not None else ""),
          file=sys.stderr)
    print("twinbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                          out.run.get("setup_phases", {}).items()),
          file=sys.stderr)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"twinbench: the run loaded {loaded}", file=sys.stderr)
        return 4

    spec = files.manifest()
    if args.trace:
        metrics = {}
        for m in spec["per_layer"]:
            if cell.name not in m.get("workloads", [cell.name]):
                continue
            value = files.metric_reader(m["name"])(out.trace, out.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_entry = device.describe(torch, dev, cell.chips, out.memory_peak_bytes)
        dev_entry.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        report.emit(checks=out.checks, attempted=out.attempted, failed=out.failed,
                    metrics=metrics, device=dev_entry, breakdown=out.trace.breakdown())
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if cell.name in m.get("workloads", [cell.name])}
        report.emit(checks=out.checks, attempted=out.attempted, failed=out.failed,
                    metrics=metrics,
                    device=device.describe(torch, dev, cell.chips, out.memory_peak_bytes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
