"""Window manager + dynamic batcher: tenants onto fleet lanes (port of
``repro.serve.batching``).

The sim-worker in upstream OpenDT keeps a *window manager* that assembles
telemetry into complete windows before simulation; this module is that role
plus the piece the core makes possible: packing whatever mix of tenants is
ready into a **fixed-shape** ``[L]``-lane call of
:func:`repro_torch.core.twin.fleet_step_masked`.  Unfilled lanes ride along
as masked padding — the same pad-and-mask trick the scenario engine plays
on the S axis — so one batched step (one launch of each kernel) serves
every arrival pattern.

Three pieces, all host-side and purely mechanical:

  * :class:`LaneMap` — which tenant occupies which fleet lane (admission /
    eviction bookkeeping);
  * :class:`WindowManager` — per-tenant reordering buffer: windows may
    arrive in any order, each tenant's stream is released strictly
    in-order (window ``k`` only after ``k-1``);
  * :func:`build_fleet_inputs` — stacks one ready window per active lane
    into ``[L, ...]`` tensors on the service's device (zeros on empty
    lanes), one host-to-device copy per field.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.state import SimSlice, TelemetrySlice, TwinConfig
from repro_torch.serve.producers import WindowEvent

#: optional per-bin forecast columns a service can thread into SimSlice,
#: in SimSlice's field order
SIM_COLUMNS = ("carbon_intensity", "ambient_c", "price")


class LaneMap:
    """Tenant <-> fleet-lane assignment (the admission/eviction ledger)."""

    def __init__(self, lanes: int):
        self.lanes = int(lanes)
        self._lane_of: dict[str, int] = {}
        self._free: list[int] = list(range(self.lanes - 1, -1, -1))

    def admit(self, tenant: str) -> int:
        """Assign ``tenant`` a free lane (lowest-numbered first)."""
        if tenant in self._lane_of:
            raise ValueError(f"tenant {tenant!r} already admitted")
        if not self._free:
            raise ValueError(
                f"all {self.lanes} fleet lanes occupied — evict a tenant "
                "first or serve with more lanes")
        lane = self._free.pop()
        self._lane_of[tenant] = lane
        return lane

    def evict(self, tenant: str) -> int:
        """Free ``tenant``'s lane and return its index."""
        lane = self._lane_of.pop(tenant)
        self._free.append(lane)
        self._free.sort(reverse=True)
        return lane

    def lane(self, tenant: str) -> int:
        return self._lane_of[tenant]

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._lane_of

    @property
    def tenants(self) -> "list[str]":
        """Resident tenants in lane order (deterministic iteration)."""
        return sorted(self._lane_of, key=self._lane_of.__getitem__)

    @property
    def occupied(self) -> int:
        return len(self._lane_of)


class WindowManager:
    """Per-tenant reordering buffer: any arrival order, in-order release.

    ``add`` buffers an event under ``(tenant, window)``; ``pop_ready``
    hands back the event for exactly the window the tenant's twin expects
    next (or None).  Windows older than the expectation — replays after a
    crash-restore, duplicate deliveries — are dropped on ``add``; the
    service's sessions know how far each stream has advanced.
    """

    def __init__(self):
        self._pending: dict[str, dict[int, WindowEvent]] = {}

    def add(self, event: WindowEvent, next_window: int) -> bool:
        """Buffer ``event``; False when it is a stale (already-served) replay."""
        if event.window < next_window:
            return False
        self._pending.setdefault(event.tenant, {})[event.window] = event
        return True

    def pop_ready(self, tenant: str, next_window: int) -> "WindowEvent | None":
        got = self._pending.get(tenant)
        if not got:
            return None
        ev = got.pop(next_window, None)
        if ev is not None and not got:
            del self._pending[tenant]
        return ev

    def pending(self, tenant: str) -> int:
        return len(self._pending.get(tenant, ()))

    def drop(self, tenant: str) -> None:
        """Forget a tenant's buffered windows (eviction)."""
        self._pending.pop(tenant, None)

    @property
    def empty(self) -> bool:
        return not self._pending


def build_fleet_inputs(events: "dict[int, WindowEvent]", lanes: int,
                       cfg: TwinConfig, columns: "tuple[str, ...]" = ()
                       ) -> "tuple[TelemetrySlice, SimSlice, torch.Tensor]":
    """Stack one window per active lane into fixed-shape tensors on
    ``cfg.device``.

    ``events`` maps lane index -> the window to serve there; every other
    lane gets zero padding and ``lane_active=False``.  The output shapes
    depend only on ``(lanes, cfg, columns)``, never on which lanes are
    filled.  ``columns`` must name the :data:`SIM_COLUMNS` subset the
    service was configured with; events must carry those columns and no
    others, so the input structure is the same for every batch.  Each
    field is assembled on the host and copied to the device once.
    """
    tw, h = cfg.bins_per_window, cfg.dc.num_hosts
    u = np.zeros((lanes, tw, h), np.float32)
    p = np.zeros((lanes, tw), np.float32)
    valid = np.zeros((lanes,), bool)
    sim_u = np.zeros((lanes, tw, h), np.float32)
    cols = {c: np.zeros((lanes, tw), np.float32) for c in columns}
    active = np.zeros((lanes,), bool)

    for lane, ev in events.items():
        if ev.u_th.shape != (tw, h) or ev.sim_u.shape != (tw, h):
            raise ValueError(
                f"tenant {ev.tenant!r} window {ev.window}: got telemetry "
                f"{ev.u_th.shape} / sim {ev.sim_u.shape}, the service is "
                f"compiled for {(tw, h)} — clip to the window first")
        active[lane] = True
        sim_u[lane] = ev.sim_u
        u[lane] = ev.u_th
        if ev.power_w is not None:
            p[lane] = ev.power_w
            valid[lane] = True
        for c in SIM_COLUMNS:
            col = getattr(ev, c)
            if c in cols:
                if col is None:
                    raise ValueError(
                        f"tenant {ev.tenant!r} window {ev.window}: the "
                        f"service's configured column {c!r} is missing "
                        "from the event")
                cols[c][lane] = col
            elif col is not None:
                raise ValueError(
                    f"tenant {ev.tenant!r} window {ev.window}: column {c!r} "
                    "is not in the service's configured columns — adding it "
                    "mid-stream would change the batch's input structure")

    dev = resolve_device(cfg.device)

    def put(x):
        return torch.from_numpy(x).to(dev)

    telem = TelemetrySlice(u_th=put(u), power_w=put(p), valid=put(valid))
    sim = SimSlice(u_th=put(sim_u),
                   **{c: put(cols[c]) if c in cols else None for c in SIM_COLUMNS})
    return telem, sim, put(active)
