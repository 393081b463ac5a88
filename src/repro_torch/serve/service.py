"""The streaming twin service: bounded-queue ingestion onto one batched
step (port of ``repro.serve.service``, paper stage 1).

:class:`TwinService` is the serving shell around the fleet core — the role
OpenDT's Kafka mesh (dc-mock -> broker -> sim-worker) plays, collapsed
onto one process and one batched step:

  * **ingestion** — :meth:`TwinService.submit` pushes
    :class:`~repro_torch.serve.producers.WindowEvent` s through a bounded
    queue; a full queue rejects (returns False) and :meth:`pump` answers by
    *rewinding* the replayable producer, so backpressure is lossless;
  * **batching** — every service step pops at most one ready window per
    resident tenant (strictly in stream order) and packs them into a
    fixed-shape :func:`~repro_torch.core.twin.fleet_step_masked` call;
    whatever subset of lanes is ready, a batch on the card launches one
    ``des_readout`` and ``1 + refine_iters`` ``calib_mape_grid`` (each
    entry of the mesh once with ``ServeConfig.shard``);
  * **caching** — before dispatch each window probes the
    :class:`~repro_torch.serve.cache.ResultCache` under its
    ``(window, stream digest, scenario digest)`` key; a hit lands the
    decoded successor state on the lane and skips the device entirely,
    bit-for-bit;
  * **pipelining** — kernels are queued on the card's stream and return at
    once: batch ``k+1`` is dispatched before batch ``k``'s outputs are
    copied to the host.  Stream digests advance at *dispatch*, which is
    what lets consecutive windows of one tenant occupy consecutive
    in-flight batches.  A batch's outputs and successor states come to
    the host with one copy a leaf for the whole batch, sliced per tenant
    there.  The fleet's tensors are never written in place (every step
    and lane update makes new ones), so an in-flight batch's successors
    cannot change under it;
  * **emission** — results are staged per tenant and released strictly in
    window order, whatever order cache hits and harvests complete in;
  * **sessions** — :meth:`checkpoint` / :meth:`restore` persist every
    tenant through :class:`~repro_torch.serve.sessions.SessionStore`; a restored
    service + replayed producers reproduces the uninterrupted run exactly.

Time is injected (:class:`~repro_torch.core.orchestrator.Clock`): tests
drive :meth:`run_until_idle` frozen-time, the thread-driven live mode
(:meth:`start` / :meth:`stop`) paces itself with ``clock.sleep`` only.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

from repro_torch.core.desim import Prediction
from repro_torch.core.orchestrator import Clock
from repro_torch.core.power import PowerParams
from repro_torch.core.state import (
    TwinConfig,
    TwinState,
    WindowOutput,
    init_twin_state,
    state_leaves,
    state_with_leaves,
)
from repro_torch.core.twin import (
    fleet_step_masked,
    index_twin_state,
    stack_twin_states,
    update_twin_state_lane,
)
from repro_torch.serve.batching import (
    SIM_COLUMNS,
    LaneMap,
    WindowManager,
    build_fleet_inputs,
)
from repro_torch.serve.cache import (
    ResultCache,
    decode_result,
    digest_arrays,
    digest_bytes,
    encode_result,
)
from repro_torch.serve.producers import Producer, WindowEvent
from repro_torch.serve.sessions import Session, SessionStore


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shape of a service: twin config, lane count, queue, cache.

    ``columns`` fixes the optional :class:`~repro_torch.core.state.SimSlice`
    forecast columns every event must carry (and no others): a batch's
    input *structure* is part of the service's identity, so it is declared
    up front rather than inferred from traffic.  The service runs on
    ``twin.device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels'
    plain versions).
    """

    twin: TwinConfig = TwinConfig()
    base_params: PowerParams = PowerParams()
    lanes: int = 16
    queue_capacity: int = 256
    cache: bool = True
    cache_entries: int = 256
    columns: "tuple[str, ...]" = ()
    #: live-mode idle pacing (seconds of injected-clock sleep)
    poll_seconds: float = 0.05
    #: dispatched-but-unharvested batches to keep in flight
    inflight_depth: int = 1
    #: split the lane axis over a device mesh: every dispatch runs
    #: :func:`~repro_torch.core.twin.fleet_step_masked` with ``shard=True``
    #: (bit for bit equal to the unsharded step).  Pick ``lanes`` as a
    #: multiple of the mesh's entries (>= 2 an entry) so dispatches skip
    #: the padding copy.
    shard: bool = False
    #: explicit mesh for ``shard=True`` (default: ``fleet_mesh()`` over
    #: every device of ``twin.device``'s kind)
    mesh: "object | None" = None

    def __post_init__(self):
        bad = set(self.columns) - set(SIM_COLUMNS)
        if bad:
            raise ValueError(
                f"unknown sim columns {sorted(bad)}; choose from "
                f"{SIM_COLUMNS}")
        if self.mesh is not None and not self.shard:
            raise ValueError("mesh given but shard=False")


@dataclasses.dataclass
class ServeStats:
    """Service counters (the numbers ``BENCH_serve.json`` snapshots)."""

    windows_served: int = 0    # results emitted (computed + cached)
    windows_computed: int = 0  # served by the batched step
    windows_cached: int = 0    # served by a cache hit
    batches: int = 0           # fleet_step_masked dispatches
    lanes_stepped: int = 0     # active lanes summed over batches
    queue_rejects: int = 0     # submits bounced by the bounded queue
    stale_dropped: int = 0     # already-served replays dropped on ingest

    @property
    def fill_ratio(self) -> float:
        """Mean fraction of lanes active per dispatched batch."""
        total = self.batches * max(1, self._lanes)
        return self.lanes_stepped / total if self.batches else 0.0

    _lanes: int = 0  # set by the service; not a counter


@dataclasses.dataclass(frozen=True)
class WindowResult:
    """One emitted tenant-window: the output, and how it was served."""

    tenant: str
    window: int
    output: WindowOutput   # host (numpy) leaves
    cached: bool


@dataclasses.dataclass
class _Inflight:
    """One dispatched batch awaiting harvest."""

    outs: WindowOutput                       # [L, ...] device leaves
    fleet: TwinState                         # the successor fleet, [L, ...]
    entries: "list[tuple[str, int, tuple]]"  # (tenant, lane, cache key)


def _output_leaves(out: WindowOutput) -> list:
    """A WindowOutput's leaves in a fixed order (absent ones as None)."""
    pred = [getattr(out.prediction, f.name)
            for f in dataclasses.fields(out.prediction)]
    return pred + [out.mape, out.calib_mape,
                   out.params_used.p_idle, out.params_used.p_max,
                   out.params_used.r, out.params_next.p_idle,
                   out.params_next.p_max, out.params_next.r, out.window]


def _output_of(leaves: list) -> WindowOutput:
    """Inverse of :func:`_output_leaves`."""
    n = len(dataclasses.fields(Prediction))
    pred, rest = leaves[:n], leaves[n:]
    return WindowOutput(
        prediction=Prediction(*pred), mape=rest[0], calib_mape=rest[1],
        params_used=PowerParams(*rest[2:5]), params_next=PowerParams(*rest[5:8]),
        window=rest[8])


def _to_host(leaves: list) -> list:
    """One device-to-host copy a leaf (None kept)."""
    return [None if x is None else x.cpu().numpy() for x in leaves]


class TwinService:
    """Multiplex live tenant twins onto one batched fleet step."""

    def __init__(self, cfg: ServeConfig = ServeConfig(), *,
                 clock: Clock = Clock()):
        self.cfg = cfg
        self.clock = clock
        self.stats = ServeStats(_lanes=cfg.lanes)
        self.cache = ResultCache(cfg.cache_entries) if cfg.cache else None
        self._lanes = LaneMap(cfg.lanes)
        self._windows = WindowManager()
        self._queue: "collections.deque[WindowEvent]" = collections.deque()
        self._producers: "list[Producer]" = []
        self._fleet = stack_twin_states(
            [init_twin_state(cfg.twin, cfg.base_params)] * cfg.lanes)
        self._next_window: dict[str, int] = {}
        self._digest: dict[str, str] = {}
        self._emit_next: dict[str, int] = {}
        self._staged: dict[str, dict[int, WindowResult]] = {}
        self._inflight: "collections.deque[_Inflight]" = collections.deque()
        self._results: "list[WindowResult]" = []
        self._lock = threading.RLock()
        self._stop_event = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- admission / eviction (control plane) ----------------------------

    def admit(self, tenant: str, state: "TwinState | None" = None, *,
              digest: "str | None" = None, next_window: int = 0) -> int:
        """Land a tenant on a free lane; returns the lane index.

        Fresh tenants start from :func:`~repro_torch.core.state.init_twin_state`
        (the service's ``twin``/``base_params`` config); restored tenants
        pass their checkpointed ``state``/``digest``/``next_window``.
        """
        with self._lock:
            lane = self._lanes.admit(tenant)
            if state is None:
                state = init_twin_state(self.cfg.twin, self.cfg.base_params)
            try:
                self._land(lane, state)
            except ValueError:
                self._lanes.evict(tenant)
                raise
            if digest is None:
                digest = digest_arrays(*state_leaves(state))
            self._next_window[tenant] = int(next_window)
            self._digest[tenant] = digest
            self._emit_next[tenant] = int(next_window)
            self._staged.setdefault(tenant, {})
            return lane

    def evict(self, tenant: str) -> Session:
        """Free a tenant's lane; returns its session (re-admittable).

        In-flight batches are harvested first so the returned state is the
        successor of every window the tenant was dispatched.  Buffered
        not-yet-served windows are dropped — replayable producers re-emit
        them on re-admission.
        """
        with self._lock:
            while self._inflight:
                self._harvest_one()
            # a copy: the freed lane is written in place by later admissions
            lane_state = index_twin_state(self._fleet, self._lanes.lane(tenant))
            session = Session(
                tenant=tenant,
                state=state_with_leaves([x.clone() for x in state_leaves(lane_state)],
                                        self.cfg.twin),
                next_window=self._next_window[tenant],
                digest=self._digest[tenant],
            )
            self._lanes.evict(tenant)
            self._windows.drop(tenant)
            self._queue = collections.deque(
                ev for ev in self._queue if ev.tenant != tenant)
            for d in (self._next_window, self._digest, self._emit_next,
                      self._staged):
                d.pop(tenant, None)
            return session

    @property
    def tenants(self) -> "list[str]":
        return self._lanes.tenants

    # -- ingestion --------------------------------------------------------

    def submit(self, event: WindowEvent) -> bool:
        """Queue one window; False when the bounded queue is full."""
        if event.tenant not in self._lanes:
            raise ValueError(
                f"tenant {event.tenant!r} is not admitted — call "
                "admit() before streaming")
        with self._lock:
            if len(self._queue) >= self.cfg.queue_capacity:
                self.stats.queue_rejects += 1
                return False
            self._queue.append(event)
            return True

    def attach(self, producer: Producer) -> None:
        """Register a replayable producer for :meth:`pump` to poll."""
        self._producers.append(producer)

    def pump(self, now: "float | None" = None) -> int:
        """Poll every producer at ``now`` (injected clock by default).

        Queued-full backpressure rewinds the producer to the rejected
        window — nothing is lost, the stream re-emits on the next pump.
        Returns the number of events queued.
        """
        if now is None:
            now = self.clock.now()
        queued = 0
        for producer in self._producers:
            for ev in producer.poll(now):
                if self.submit(ev):
                    queued += 1
                else:
                    producer.rewind(ev.window)
                    break
        return queued

    # -- the serving step -------------------------------------------------

    def _drain_queue(self) -> None:
        while self._queue:
            ev = self._queue.popleft()
            if ev.tenant not in self._lanes:
                self.stats.stale_dropped += 1
                continue
            if not self._windows.add(ev, self._next_window[ev.tenant]):
                self.stats.stale_dropped += 1

    def _scenario_digest(self, ev: WindowEvent) -> str:
        return digest_arrays(
            ev.u_th, ev.power_w, ev.sim_u,
            *(getattr(ev, c) for c in self.cfg.columns))

    def _advance(self, tenant: str, scenario_digest: str) -> None:
        # the rolling stream digest: host metadata only, advanced at
        # dispatch so back-to-back windows of one tenant can occupy
        # consecutive in-flight batches
        self._digest[tenant] = digest_bytes(
            self._digest[tenant].encode(), scenario_digest.encode())
        self._next_window[tenant] += 1

    def _stage(self, result: WindowResult) -> None:
        staged = self._staged[result.tenant]
        staged[result.window] = result
        while self._emit_next[result.tenant] in staged:
            w = self._emit_next[result.tenant]
            self._results.append(staged.pop(w))
            self._emit_next[result.tenant] = w + 1
            self.stats.windows_served += 1

    def _land(self, lane: int, state: TwinState) -> None:
        """Put ``state`` on ``lane`` of the fleet.  The write goes in place
        unless an in-flight batch holds the fleet (its successor lanes are
        read at harvest); then it goes to a copy, which is the service's
        alone, so the round's later writes go in place."""
        held = any(b.fleet is self._fleet for b in self._inflight)
        self._fleet = update_twin_state_lane(self._fleet, lane, state,
                                             in_place=not held)

    def _dispatch(self, ready: "dict[str, tuple[WindowEvent, tuple]]") -> None:
        by_lane = {self._lanes.lane(t): ev for t, (ev, _) in ready.items()}
        telem, sim, active = build_fleet_inputs(
            by_lane, self.cfg.lanes, self.cfg.twin, self.cfg.columns)
        new_fleet, outs = fleet_step_masked(self._fleet, telem, sim, active,
                                            shard=self.cfg.shard, mesh=self.cfg.mesh)
        # the batch keeps the successor fleet itself: while it is in flight
        # a lane write copies the fleet first (_land), so its lanes still
        # hold these values at harvest
        entries = [(tenant, self._lanes.lane(tenant), key)
                   for tenant, (_, key) in ready.items()]
        self._fleet = new_fleet
        self._inflight.append(_Inflight(outs=outs, fleet=new_fleet,
                                        entries=entries))
        self.stats.batches += 1
        self.stats.lanes_stepped += len(ready)

    def _harvest_one(self) -> None:
        batch = self._inflight.popleft()
        # one device-to-host copy a leaf for the whole batch, sliced here
        outs = _to_host(_output_leaves(batch.outs))
        succs = (_to_host(state_leaves(batch.fleet))
                 if self.cache is not None else None)
        for tenant, lane, key in batch.entries:
            out = _output_of([None if x is None else x[lane] for x in outs])
            if self.cache is not None:
                succ = state_with_leaves([x[lane] for x in succs], self.cfg.twin)
                self.cache.put(key, encode_result(out, succ))
            self.stats.windows_computed += 1
            self._stage(WindowResult(tenant=tenant, window=int(out.window),
                                     output=out, cached=False))

    def _step_once(self) -> bool:
        """One scheduling round; True when any work happened."""
        with self._lock:
            self._drain_queue()
            ready: dict[str, tuple[WindowEvent, tuple]] = {}
            hits = 0
            for tenant in self._lanes.tenants:
                ev = self._windows.pop_ready(tenant,
                                             self._next_window[tenant])
                if ev is None:
                    continue
                scen = self._scenario_digest(ev)
                key = (ev.window, self._digest[tenant], scen)
                if self.cache is not None:
                    blob = self.cache.get(key)
                    if blob is not None:
                        out, succ = decode_result(blob, device=self.cfg.twin.device)
                        self._land(self._lanes.lane(tenant), succ)
                        self._advance(tenant, scen)
                        self.stats.windows_cached += 1
                        hits += 1
                        self._stage(WindowResult(
                            tenant=tenant, window=ev.window, output=out,
                            cached=True))
                        continue
                ready[tenant] = (ev, key)
                self._advance(tenant, scen)
            if ready:
                self._dispatch(ready)
            progress = bool(ready) or hits > 0
            while len(self._inflight) > (self.cfg.inflight_depth
                                         if ready else 0):
                self._harvest_one()
                progress = True
            return progress

    def run_until_idle(self, *, pump: bool = True) -> "list[WindowResult]":
        """Serve deterministically until nothing is left to do.

        Pumps attached producers (at the injected clock's ``now``), drains
        the queue, batches, harvests — and repeats until no producer emits,
        no window is ready and nothing is in flight.  Returns the results
        emitted by this call, in per-tenant stream order.
        """
        emitted_from = len(self._results)
        while True:
            queued = self.pump() if pump else 0
            progress = self._step_once()
            if not queued and not progress and not self._inflight:
                break
        return self._results[emitted_from:]

    def drain(self) -> "list[WindowResult]":
        """Take every emitted result (clears the emission log)."""
        with self._lock:
            out, self._results = self._results, []
            return out

    @property
    def results(self) -> "list[WindowResult]":
        return list(self._results)

    # -- live mode ---------------------------------------------------------

    def start(self) -> None:
        """Run the serving loop on a thread, paced by the injected clock."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop_event.clear()

        def loop():
            while not self._stop_event.is_set():
                queued = self.pump()
                progress = self._step_once()
                if not queued and not progress:
                    self.clock.sleep(self.cfg.poll_seconds)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="twin-service")
        self._thread.start()

    def stop(self) -> None:
        """Stop the live loop and harvest everything in flight."""
        if self._thread is None:
            return
        self._stop_event.set()
        self._thread.join()
        self._thread = None
        with self._lock:
            while self._inflight:
                self._harvest_one()

    # -- sessions ----------------------------------------------------------

    def checkpoint(self, root) -> SessionStore:
        """Persist every resident tenant's session under ``root``.

        In-flight work is harvested first, so each saved session is the
        exact successor of every window that tenant has been served.
        Queued/buffered but unserved windows are *not* persisted — the
        replayable producers re-emit them after :meth:`restore`, and the
        stale-replay filter drops everything below each session's
        ``next_window``.  The fleet comes to the host once (a copy a leaf).
        """
        with self._lock:
            while self._inflight:
                self._harvest_one()
            store = SessionStore(root, device=self.cfg.twin.device)
            host = _to_host(state_leaves(self._fleet))
            for tenant in self._lanes.tenants:
                lane = self._lanes.lane(tenant)
                store.save(Session(
                    tenant=tenant,
                    state=state_with_leaves([x[lane] for x in host], self.cfg.twin),
                    next_window=self._next_window[tenant],
                    digest=self._digest[tenant],
                ))
            return store

    def restore(self, root) -> "list[str]":
        """Re-admit every tenant checkpointed under ``root``.

        The restored service resumes each stream at its saved
        ``next_window`` with the saved state and digest — outputs from
        here on are bit-for-bit what the uninterrupted service would have
        emitted.
        """
        store = SessionStore(root, device=self.cfg.twin.device)
        tenants = store.tenants
        for tenant in tenants:
            s = store.load(tenant)
            self.admit(tenant, s.state, digest=s.digest,
                       next_window=s.next_window)
        return tenants

    # -- introspection -----------------------------------------------------

    def compile_count(self) -> "int | None":
        """Always None: eager PyTorch compiles no program.  A batch's kernel
        launches (``repro_torch.kernels.ops.LAUNCHES``) take its place: one
        ``des_readout`` and ``1 + refine_iters`` ``calib_mape_grid``, an
        entry of the mesh when the service shards."""
        return None
