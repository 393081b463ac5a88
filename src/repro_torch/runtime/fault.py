"""Fault-tolerant training driver + host-failure schedules for the DES
(port of ``repro.runtime.fault``).

Two layers share this module because they model the same physical event
(a host dying) at different granularities:

* :class:`HostFailure` / :func:`failure_arrays`: a tuple of per-host
  outage/degradation windows becomes three dense ``[max_hosts]`` arrays
  (start, end, kill flag) that the DES folds into a time-varying host
  mask, so "rack 3 dies at noon" is one lane of a what-if batch.
* :func:`run_with_restarts`: the training-loop restart driver a cluster
  scheduler would run: periodic checkpoints, (optionally injected)
  failures, restore from the latest checkpoint.  The JAX package's
  restart loop imports ``plan_mesh`` but never calls it: it restarts on
  the mesh it had, and so does this one (the policy itself is
  :mod:`repro_torch.runtime.elastic`).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import numpy as np

from repro_torch._tree import flatten, leaves

#: schedule sentinel for "this host never fails": the window start sits
#: past any representable bin, so every ``start <= t < end`` test is false
NEVER_BIN = np.iinfo(np.int32).max

#: failure kinds: an OUTAGE kills running jobs and draws no power for the
#: window; a DEGRADED host drains (no new placements, running jobs finish,
#: the host keeps drawing power).
OUTAGE = "outage"
DEGRADED = "degraded"


@dataclasses.dataclass(frozen=True)
class HostFailure:
    """One per-host failure window ``[start_bin, end_bin)`` on the DES clock.

    ``kind="outage"``: jobs running on the host at ``start_bin`` are
    killed (their cores come back with the host at ``end_bin``), and the
    host takes no placements and draws no power during the window.
    ``kind="degraded"``: no new placements during the window; running jobs
    keep running and the host keeps drawing power.
    """

    host: int
    start_bin: int
    end_bin: int
    kind: str = OUTAGE

    def __post_init__(self):
        if self.host < 0:
            raise ValueError(f"failure host must be >= 0, got {self.host}")
        if not 0 <= self.start_bin < self.end_bin:
            raise ValueError(
                f"failure window must satisfy 0 <= start < end, got "
                f"[{self.start_bin}, {self.end_bin})")
        if self.kind not in (OUTAGE, DEGRADED):
            raise ValueError(
                f"failure kind must be {OUTAGE!r} or {DEGRADED!r}, "
                f"got {self.kind!r}")


def failure_arrays(failures, max_hosts: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``[max_hosts]`` (start int32, end int32, kill bool) arrays.

    Hosts without a window get the ``NEVER_BIN`` start (and end 0), so a
    lane without failures in a mixed batch runs the no-failure schedule.
    One window per host: overlapping schedules must be merged first.
    """
    fs = np.full(max_hosts, NEVER_BIN, np.int32)
    fe = np.zeros(max_hosts, np.int32)
    kill = np.zeros(max_hosts, bool)
    for f in failures:
        if f.host >= max_hosts:
            raise ValueError(
                f"failure host {f.host} out of range for {max_hosts} hosts")
        if fs[f.host] != NEVER_BIN:
            raise ValueError(
                f"host {f.host} has multiple failure windows; the DES "
                "carries one window per host — merge them first")
        fs[f.host] = f.start_bin
        fe[f.host] = f.end_bin
        kill[f.host] = f.kind == OUTAGE
    return fs, fe, kill


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50            # steps
    keep: int = 3
    max_restarts: int = 10


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: kill at steps."""

    fail_at_steps: tuple[int, ...] = ()
    device_loss: int = 0            # devices lost at each failure
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(step, self.device_loss)


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int, device_loss: int):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step
        self.device_loss = device_loss


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    checkpoints: int
    losses: list[float]
    restored_from: list[int]


def run_with_restarts(
    *,
    total_steps: int,
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], tuple[Any, float]],
    fault_cfg: FaultConfig = FaultConfig(),
    injector: FailureInjector | None = None,
    on_window: Callable[[int, Any], None] | None = None,
) -> RunReport:
    """Drive step_fn to total_steps across simulated crashes.

    make_state: fresh job state (params, opt, data cursor, twin state).
    step_fn(state, step) -> (state', loss).
    """
    # imported here: the checkpoint's codec lives in repro_torch.core, whose
    # package imports core.scenarios, which imports this module
    from repro_torch.checkpoint import ckpt

    report = RunReport(0, 0, 0, [], [])
    restarts = 0
    while True:
        start = ckpt.latest_step(fault_cfg.ckpt_dir)
        if start is None:
            state = make_state()
            step0 = 0
        else:
            step0, host_state = ckpt.restore(fault_cfg.ckpt_dir)
            state = _rehydrate(make_state(), host_state)
            report.restored_from.append(step0)
        try:
            for step in range(step0, total_steps):
                if injector is not None:
                    injector.check(step)
                state, loss = step_fn(state, step)
                report.losses.append(loss)
                report.steps_done = step + 1
                if (step + 1) % fault_cfg.ckpt_every == 0:
                    ckpt.save(fault_cfg.ckpt_dir, step + 1, state,
                              keep=fault_cfg.keep)
                    report.checkpoints += 1
                if on_window is not None:
                    on_window(step, state)
            return report
        except SimulatedFailure:
            restarts += 1
            report.restarts = restarts
            if restarts > fault_cfg.max_restarts:
                raise
            # loop: restore from latest checkpoint and continue
            continue


def _rehydrate(template: Any, host_state: Any) -> Any:
    """The restored host leaves on the template's structure: each tensor
    leaf takes the template's dtype, device and ``requires_grad``, each
    numpy leaf its dtype."""
    from repro_torch.checkpoint import ckpt

    flat_t, unflatten = flatten(template)
    flat_h = leaves(host_state)
    if len(flat_t) != len(flat_h):
        raise ValueError("state structure changed across restart: "
                         f"{len(flat_h)} leaves restored, {len(flat_t)} expected")
    return unflatten([ckpt.cast_like(h, t) for t, h in zip(flat_t, flat_h)])
