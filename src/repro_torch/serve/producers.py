"""Replayable streaming telemetry producers, the dc-mock role (port of
``repro.serve.producers``).

Upstream OpenDT's ``dc-mock`` service replays a recorded trace onto Kafka at
a configurable rate; these producers play that part for the
:class:`~repro_torch.serve.service.TwinService`.  A producer owns one tenant's
telemetry stream and answers :meth:`poll(now) <Producer.poll>` with every
window whose (jittered) due time has passed — *time is an argument*, never
an ambient clock, so the same producer runs frozen-time in tests and
wall-clock in the live service loop (tracecheck TC007).

Two flavors ship:

  * :class:`TraceReplayProducer` — replays a
    :class:`~repro_torch.core.twin.TraceGroundTruth` (or any precomputed
    ``u_th``/``power`` pair, e.g. a SURF-like trace) window by window;
  * :class:`SyntheticProducer` — generates jittered synthetic telemetry
    from a seeded RNG and a hidden power model, deterministic per
    ``(seed, window)`` regardless of poll pattern.

Both are **replayable**: :meth:`Producer.rewind` moves the cursor back, so
backpressure (a full service queue) and crash recovery (a restored session
asking for older windows again) are lossless — the stream is re-emitted,
not re-recorded.  Events are numpy: the producers run on the host and
touch no device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.power import PowerParams


def opendc_power_np(u: np.ndarray, params: PowerParams) -> np.ndarray:
    """The OpenDC power model in numpy float32, for host-side producers:
    ``P(u) = P_idle + (P_max - P_idle)(2u - u^r)``, u clipped to [0, 1]."""
    u = np.clip(np.asarray(u, np.float32), np.float32(0.0), np.float32(1.0))
    p_idle, p_max, r = (np.asarray(x, np.float32)
                        for x in (params.p_idle, params.p_max, params.r))
    shape = np.float32(2.0) * u - np.power(u, r)
    return p_idle + (p_max - p_idle) * shape


@dataclasses.dataclass(frozen=True)
class WindowEvent:
    """One tenant-window of streamed telemetry, ready for ingestion.

    ``u_th``/``power_w`` are the *measured* window (``power_w=None`` marks a
    telemetry gap — the twin still predicts, learns nothing); ``sim_u`` is
    the DES utilization slice the twin predicts from.  The optional
    ``[Tw]`` forecast columns must match the service's configured columns
    (:class:`~repro_torch.serve.service.ServeConfig`), so a batch's input
    structure never changes mid-stream.
    """

    tenant: str
    window: int
    u_th: np.ndarray                      # [Tw, H] measured utilization
    power_w: "np.ndarray | None"          # [Tw] measured power (None = gap)
    sim_u: np.ndarray                     # [Tw, H] DES slice to predict from
    carbon_intensity: "np.ndarray | None" = None   # [Tw] gCO2/kWh forecast
    ambient_c: "np.ndarray | None" = None          # [Tw] deg C forecast
    price: "np.ndarray | None" = None              # [Tw] $/kWh forecast


class Producer:
    """Protocol: a replayable, clock-driven stream of one tenant's windows."""

    tenant: str

    def poll(self, now: float) -> "list[WindowEvent]":
        """Every not-yet-emitted window due at or before ``now``, in order."""
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        """True once every window has been emitted (cursor at the end)."""
        raise NotImplementedError

    def rewind(self, window: int) -> None:
        """Move the cursor back so ``window`` is the next emission."""
        raise NotImplementedError


class _ScheduledProducer(Producer):
    """Shared machinery: a jittered due-time schedule over W windows.

    Window ``w`` becomes due at ``start + (w + 1) * period_s + jitter_w``
    with ``jitter_w ~ U[0, jitter_s)`` drawn from a seeded RNG — the
    schedule is a pure function of the constructor arguments, so two
    identically-configured producers emit identically (determinism the
    service tests lean on).
    """

    def __init__(self, tenant: str, num_windows: int, *, start: float = 0.0,
                 period_s: float = 0.0, jitter_s: float = 0.0, seed: int = 0):
        self.tenant = tenant
        self.num_windows = int(num_windows)
        rng = np.random.default_rng([seed, 0xD0])
        self._due = (start + period_s * (np.arange(self.num_windows) + 1)
                     + rng.uniform(0.0, jitter_s or 0.0, self.num_windows))
        self._cursor = 0

    def _window_event(self, window: int) -> WindowEvent:
        raise NotImplementedError

    def poll(self, now: float) -> "list[WindowEvent]":
        events: list[WindowEvent] = []
        while (self._cursor < self.num_windows
               and self._due[self._cursor] <= now):
            events.append(self._window_event(self._cursor))
            self._cursor += 1
        return events

    @property
    def exhausted(self) -> bool:
        return self._cursor >= self.num_windows

    def rewind(self, window: int) -> None:
        if not 0 <= window <= self.num_windows:
            raise ValueError(
                f"rewind target {window} outside [0, {self.num_windows}]")
        self._cursor = min(self._cursor, int(window))


class TraceReplayProducer(_ScheduledProducer):
    """Replays a recorded trace window by window (dc-mock style).

    ``truth`` is anything exposing ``u_th`` (``[T, H]`` utilization, the DES
    field doubling as measured utilization) and ``power`` (``[T]`` measured
    watts) — :class:`~repro_torch.core.twin.TraceGroundTruth` fits directly.
    Forecast columns (full-horizon ``[T]`` arrays) are sliced per window.
    """

    def __init__(self, tenant: str, truth, bins_per_window: int, *,
                 start: float = 0.0, period_s: float = 0.0,
                 jitter_s: float = 0.0, seed: int = 0,
                 carbon_intensity: "np.ndarray | None" = None,
                 ambient_c: "np.ndarray | None" = None,
                 price: "np.ndarray | None" = None):
        self.u_th = np.asarray(truth.u_th)
        self.power = np.asarray(truth.power)
        self.bins_per_window = int(bins_per_window)
        self.carbon_intensity = carbon_intensity
        self.ambient_c = ambient_c
        self.price = price
        super().__init__(
            tenant, self.u_th.shape[0] // self.bins_per_window,
            start=start, period_s=period_s, jitter_s=jitter_s, seed=seed)

    def _window_event(self, window: int) -> WindowEvent:
        sl = slice(window * self.bins_per_window,
                   (window + 1) * self.bins_per_window)

        def col(x):
            return None if x is None else np.asarray(x[sl], np.float32)

        return WindowEvent(
            tenant=self.tenant, window=window,
            u_th=np.asarray(self.u_th[sl], np.float32),
            power_w=np.asarray(self.power[sl], np.float32),
            sim_u=np.asarray(self.u_th[sl], np.float32),
            carbon_intensity=col(self.carbon_intensity),
            ambient_c=col(self.ambient_c),
            price=col(self.price),
        )


class SyntheticProducer(_ScheduledProducer):
    """Jittered synthetic telemetry from a hidden power model.

    Per window the utilization field is drawn from a seeded per-window RNG
    (``default_rng([seed, window])`` — the data is a pure function of
    ``(seed, window)``, independent of poll order) and the measured power is
    the *hidden* model's response plus meter noise: the live-stream analog
    of :func:`repro_torch.traces.surf.synthesize_ground_truth`, sized for a
    service test rather than a full trace.  The hidden model is
    :func:`opendc_power_np`.
    """

    def __init__(self, tenant: str, *, hosts: int, bins_per_window: int,
                 num_windows: int, seed: int = 0, util_mean: float = 0.4,
                 hidden: PowerParams = PowerParams(p_idle=72.0, p_max=365.0,
                                                   r=2.4),
                 noise: float = 0.01, start: float = 0.0,
                 period_s: float = 0.0, jitter_s: float = 0.0):
        self.hosts = int(hosts)
        self.bins_per_window = int(bins_per_window)
        self.util_mean = float(util_mean)
        self.hidden = hidden
        self.noise = float(noise)
        self.seed = int(seed)
        super().__init__(tenant, num_windows, start=start, period_s=period_s,
                         jitter_s=jitter_s, seed=seed)

    def _window_event(self, window: int) -> WindowEvent:
        rng = np.random.default_rng([self.seed, window])
        u = np.clip(rng.normal(self.util_mean, 0.15,
                               (self.bins_per_window, self.hosts)),
                    0.0, 1.0).astype(np.float32)
        p = opendc_power_np(u, self.hidden).sum(axis=-1)
        p = (p * (1.0 + rng.normal(0.0, self.noise, p.shape))).astype(
            np.float32)
        return WindowEvent(tenant=self.tenant, window=window, u_th=u,
                           power_w=p, sim_u=u)
