"""Telemetry windows and the in-memory store (port of ``repro.core.telemetry``).

Telemetry arrives asynchronously and is windowed: records are clipped to
the window of operation before the simulator sees them, and consumers
read consistent snapshots keyed by window index.  The store persists as
one codec-tagged blob (:mod:`repro_torch.core.codec`), the JAX package's
format: either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Iterable

import numpy as np

from repro_torch.core import codec
from repro_torch.traces.schema import SAMPLE_SECONDS

#: extras column: measured grid carbon intensity ``[Tw]`` (gCO2/kWh)
CARBON_INTENSITY_KEY = "carbon_intensity"

#: extras column: measured electricity spot price ``[Tw]`` ($/kWh)
PRICE_KEY = "price"

#: extras column: measured outside-air temperature ``[Tw]`` (deg C)
AMBIENT_KEY = "ambient_c"


@dataclasses.dataclass(frozen=True)
class TelemetryWindow:
    """One window of operation's worth of physical-twin telemetry (numpy)."""

    window: int
    t0_bin: int
    u_th: np.ndarray          # [Tw, H] per-host utilization
    power_w: np.ndarray       # [Tw] measured total power draw
    extras: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def bins(self) -> int:
        return int(self.power_w.shape[0])


def clip_to_window(window: int, bins_per_window: int, t0_bin: int,
                   u_th: np.ndarray, power_w: np.ndarray,
                   **extras: np.ndarray) -> TelemetryWindow:
    """Clip raw records to the window of operation; forward-fill a short tail."""
    w0 = window * bins_per_window
    w1 = w0 + bins_per_window
    lo = max(w0 - t0_bin, 0)
    hi = max(min(w1 - t0_bin, power_w.shape[0]), lo)
    u = u_th[lo:hi]
    p = power_w[lo:hi]
    if p.shape[0] < bins_per_window:
        pad = bins_per_window - p.shape[0]
        if p.shape[0] == 0:
            u = np.zeros((bins_per_window,) + u_th.shape[1:], u_th.dtype)
            p = np.zeros((bins_per_window,), power_w.dtype)
        else:
            u = np.concatenate([u, np.repeat(u[-1:], pad, axis=0)])
            p = np.concatenate([p, np.repeat(p[-1:], pad)])
    ex = {k: v[lo:hi] for k, v in extras.items()}
    return TelemetryWindow(window=window, t0_bin=w0, u_th=u, power_w=p, extras=ex)


class TelemetryStore:
    """Windowed, thread-safe telemetry store, persisted by :meth:`flush`."""

    def __init__(self, bins_per_window: int,
                 sample_seconds: float = SAMPLE_SECONDS):
        self.bins_per_window = int(bins_per_window)
        self.sample_seconds = float(sample_seconds)
        self._windows: dict[int, TelemetryWindow] = {}
        self._lock = threading.Lock()

    def ingest(self, tw: TelemetryWindow) -> None:
        if tw.bins != self.bins_per_window:
            raise ValueError(
                f"window {tw.window}: got {tw.bins} bins, "
                f"expected {self.bins_per_window} (clip first)")
        with self._lock:
            if tw.window in self._windows:
                raise ValueError(f"window {tw.window} already ingested")
            self._windows[tw.window] = tw

    def get(self, window: int) -> TelemetryWindow | None:
        with self._lock:
            return self._windows.get(window)

    def latest(self) -> int:
        with self._lock:
            return max(self._windows, default=-1)

    def history(self, upto: int, n: int) -> list[TelemetryWindow]:
        """The last ``n`` complete windows ending at ``upto`` (inclusive)."""
        with self._lock:
            return [self._windows[w] for w in range(max(0, upto - n + 1), upto + 1)
                    if w in self._windows]

    def windows(self) -> Iterable[int]:
        with self._lock:
            return sorted(self._windows)

    def flush(self, path: str) -> None:
        """Persist every window through :mod:`repro_torch.core.codec`.

        Columns are :func:`~repro_torch.core.codec.pack_array` records (raw
        bytes + dtype + shape), so the round trip is bit for bit with the
        dtypes kept (format version 2).  The file is written beside
        ``path`` and renamed over it, so a reader never sees half a flush.
        """
        cols: dict = {"version": 2,
                      "bins_per_window": self.bins_per_window,
                      "sample_seconds": self.sample_seconds, "windows": {}}
        with self._lock:
            for w, tw in sorted(self._windows.items()):
                cols["windows"][w] = {
                    "t0_bin": tw.t0_bin,
                    "u_th": codec.pack_array(tw.u_th),
                    "power_w": codec.pack_array(tw.power_w),
                    "extras": {k: codec.pack_array(v)
                               for k, v in tw.extras.items()},
                }
        blob = codec.dumps(cols, level=6)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "TelemetryStore":
        """A store from :meth:`flush`'s file, or from a version-1 file (the
        earlier columns: raw float32 ``u_th`` with its shape, float64
        ``power_w``, float32 extras)."""
        with open(path, "rb") as f:
            cols = codec.loads(f.read())
        store = cls(cols["bins_per_window"], cols["sample_seconds"])
        legacy = cols.get("version", 1) < 2
        for w, rec in cols["windows"].items():
            if legacy:
                u = np.frombuffer(rec["u_th"], np.float32).reshape(rec["u_shape"])
                p = np.frombuffer(rec["power_w"], np.float64)
                extras = {k: np.frombuffer(v["b"], np.float32).reshape(v["s"])
                          for k, v in rec["extras"].items()}
            else:
                u = codec.unpack_array(rec["u_th"])
                p = codec.unpack_array(rec["power_w"])
                extras = {k: codec.unpack_array(v)
                          for k, v in rec["extras"].items()}
            store.ingest(TelemetryWindow(int(w), rec["t0_bin"], u, p, extras))
        return store
