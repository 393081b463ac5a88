"""Streaming twin service: many live tenant twins, one batched step
(port of ``repro.serve``, paper stage 1).

Upstream OpenDT serves its twin as a Kafka microservice mesh — ``dc-mock``
telemetry producers, a sim-worker window manager and a result cache.  This
package is that serving story on the fleet core: replayable producers
(:mod:`repro_torch.serve.producers`), a dynamic batcher that packs ready
``(tenant, window)`` pairs onto the fixed fleet axis
(:mod:`repro_torch.serve.batching`), a digest-keyed result cache of codec
blobs (:mod:`repro_torch.serve.cache`), per-tenant checkpoint/restore
sessions (:mod:`repro_torch.serve.sessions`) and the bounded-queue
ingestion loop that ties them together (:mod:`repro_torch.serve.service`).

Everything host-side is deterministic by construction (the injectable
``Clock`` of :mod:`repro_torch.core.orchestrator`, seeded RNGs);
everything on the device is one batched step
(:func:`repro_torch.core.twin.fleet_step_masked`) for every tenant mix:
on the card one ``des_readout`` and ``1 + refine_iters``
``calib_mape_grid`` launches a batch.
"""

from repro_torch.serve.batching import LaneMap, WindowManager, build_fleet_inputs
from repro_torch.serve.cache import ResultCache, decode_result, encode_result
from repro_torch.serve.producers import (
    SyntheticProducer,
    TraceReplayProducer,
    WindowEvent,
)
from repro_torch.serve.sessions import Session, SessionStore
from repro_torch.serve.service import (
    ServeConfig,
    ServeStats,
    TwinService,
    WindowResult,
)

__all__ = [
    "LaneMap",
    "ResultCache",
    "ServeConfig",
    "ServeStats",
    "Session",
    "SessionStore",
    "SyntheticProducer",
    "TraceReplayProducer",
    "TwinService",
    "WindowEvent",
    "WindowManager",
    "WindowResult",
    "build_fleet_inputs",
    "decode_result",
    "encode_result",
]
