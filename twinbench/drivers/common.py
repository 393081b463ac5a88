"""What the drivers share: the port's import, the kernel build, the device,
the closed loop's clock and the outcome of a run."""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics, the counts, the
    output check, the peak memory and, traced, what the readers take."""

    metrics: dict
    attempted: int
    failed: int
    checks: object
    memory_peak_bytes: int
    trace: object = None
    #: for the per-layer readers: ``units`` (requests or steps traced),
    #: ``launches`` (kernel name -> list of count inputs, one a launch),
    #: ``unit_wall_s`` (host seconds of each traced unit)
    run: dict = dataclasses.field(default_factory=dict)


def build_kernels(device, names) -> None:
    """Build (or find built) the cell's CUDA kernels under the checkout's
    ``build/kernels``; nothing on the CPU."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build
    _build.build(tuple(names))
    for name in names:
        _build.load(name)


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def workload(torch, week: dict, device):
    """A week of :mod:`twinbench.harness.surf22` as the port's ``Workload``."""
    from repro_torch.traces.schema import Workload
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Workload(submit_bin=t(week["submit"]), duration_bins=t(week["dur"]),
                    cores=t(week["cores"]), util_levels=t(week["util"]),
                    valid=t(week["valid"]))


def closed_loop(seconds: float, call, on_done) -> tuple[int, float, list]:
    """Call ``call(n)`` back to back until ``seconds`` have passed since the
    first call; ``on_done(n, result)`` takes each result.  Returns the count,
    the seconds from the first call to the end of the last, and each call's
    seconds."""
    walls = []
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        out = call(n)
        walls.append(time.perf_counter() - a)
        on_done(n, out)
        n += 1
    return n, time.perf_counter() - t0, walls
