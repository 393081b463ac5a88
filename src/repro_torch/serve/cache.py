"""Digest-keyed result cache of codec blobs, the sim-worker role (port of
``repro.serve.cache``).

Upstream OpenDT's sim-worker keeps a ``result_cache.py`` so re-simulating
an already-seen (window, parameters, scenario) triple is a lookup, not a
run.  The twin's analog: ``twin_step`` is deterministic, so a tenant
window's *entire* outcome — the :class:`~repro_torch.core.state.WindowOutput`
**and** the successor :class:`~repro_torch.core.state.TwinState` — is a pure
function of ``(window, params_digest, scenario_digest)``, where

  * ``params_digest`` is the tenant's rolling stream digest: seeded from
    the admitted ``TwinState`` bytes and folded forward with every served
    window's input digest, it identifies the exact calibrated state the
    step would run from **without touching the device** (the property the
    double-buffered service loop needs — a cache probe never forces a
    host sync);
  * ``scenario_digest`` hashes the window's telemetry + sim inputs.

Entries are codec blobs (:func:`repro_torch.core.codec.dumps` — one-byte
codec id, optional-zstd policy) holding the output leaves plus the
successor state, so a hit replays **bit-for-bit** what the batched step
would have produced.  The blobs and digests are the JAX package's: either
package reads the other's entries.  The cache is LRU-bounded and counts
hits and misses.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

from repro_torch.core import codec
from repro_torch.core.desim import Prediction
from repro_torch.core.power import PowerParams
from repro_torch.core.state import (
    TwinState,
    WindowOutput,
    state_from_bytes,
    state_to_bytes,
)

#: Prediction's named leaves, in dataclass order (optional ones may be None)
_PRED_FIELDS = ("power_w", "energy_kwh", "tflops", "utilization",
                "efficiency", "gco2", "power_demand_w", "pue", "energy_cost")


def digest_bytes(*parts: bytes) -> str:
    """Hex digest over a byte sequence (the cache-key hash)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def _host(x):
    """``x`` as numpy (a tensor is copied to the host)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def digest_arrays(*arrays) -> str:
    """Digest over arrays or tensors (None allowed — a gap is part of the
    identity); equal to the JAX package's digest of the same values."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
            continue
        a = _host(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def encode_result(out: WindowOutput, next_state: TwinState) -> bytes:
    """Pack one served window — output + successor state — as a codec blob.

    The leaves may be tensors or numpy arrays (a batch's lanes sliced on
    the host)."""

    def arr(x):
        return None if x is None else codec.pack_array(x)

    payload = {
        "pred": {f: arr(getattr(out.prediction, f)) for f in _PRED_FIELDS},
        "mape": codec.pack_array(out.mape),
        "calib_mape": codec.pack_array(out.calib_mape),
        "params_used": [codec.pack_array(x) for x in
                        (out.params_used.p_idle, out.params_used.p_max,
                         out.params_used.r)],
        "params_next": [codec.pack_array(x) for x in
                        (out.params_next.p_idle, out.params_next.p_max,
                         out.params_next.r)],
        "window": codec.pack_array(out.window),
        "state": state_to_bytes(next_state),
    }
    return codec.dumps(payload)


def decode_result(blob: bytes, device="cuda") -> "tuple[WindowOutput, TwinState]":
    """Inverse of :func:`encode_result`, bit for bit: the output's leaves
    as numpy arrays, the successor state on ``device``."""
    payload = codec.loads(blob)

    def arr(rec):
        return None if rec is None else codec.unpack_array(rec)

    def params(recs):
        return PowerParams(*(codec.unpack_array(r) for r in recs))

    out = WindowOutput(
        prediction=Prediction(**{f: arr(payload["pred"][f])
                                 for f in _PRED_FIELDS}),
        mape=codec.unpack_array(payload["mape"]),
        calib_mape=codec.unpack_array(payload["calib_mape"]),
        params_used=params(payload["params_used"]),
        params_next=params(payload["params_next"]),
        window=codec.unpack_array(payload["window"]),
    )
    return out, state_from_bytes(payload["state"], device=device)


class ResultCache:
    """LRU-bounded blob cache with hit/miss counters.

    Keys are the ``(window, params_digest, scenario_digest)`` triples the
    service derives; values are :func:`encode_result` blobs.  ``get`` on a
    present key refreshes recency; ``put`` evicts the least recently used
    entry beyond ``capacity``.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: "collections.OrderedDict[tuple, bytes]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> "bytes | None":
        blob = self._entries.get(key)
        if blob is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return blob

    def put(self, key: tuple, blob: bytes) -> None:
        self._entries[key] = blob
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
