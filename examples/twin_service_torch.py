"""Streaming twin service on the PyTorch port: live tenants multiplexed
onto one batched step.

The counterpart of ``examples/twin_service.py``, with its tenants, its
lifecycle and its lines (plus ``--device`` and the size flags).  Tenants
arrive and leave, their telemetry streams in jittered and out of order,
and every dynamic batch — whatever mix of lanes is ready — is one call of
``fleet_step_masked``: one ``des_readout`` and one ``calib_mape_grid``
launch, however many lanes it fills.  Along the way it exercises the
whole lane lifecycle:

  admit -> batch -> step -> cache -> checkpoint/restore -> evict

Two tenant groups share hidden power models (same seeds), so once the
first group's streams have been served the result cache answers the
second group's windows without touching the device — bit for bit.  Where
the JAX example prints its compile count, this one prints the kernel
launches (eager PyTorch compiles no program).

    PYTHONPATH=src python examples/twin_service_torch.py
    PYTHONPATH=src python examples/twin_service_torch.py --device cpu

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.state import TwinConfig, state_leaves
from repro_torch.kernels import ops
from repro_torch.serve import ServeConfig, SessionStore, SyntheticProducer, TwinService
from repro_torch.traces.schema import DatacenterConfig

HOSTS = 16
BINS = 36          # one 3 h window at 5-min sampling
WINDOWS = 4
LANES = 8


def producer(tenant: str, seed: int, *, hosts: int = HOSTS, windows: int = WINDOWS):
    return SyntheticProducer(
        tenant, hosts=hosts, bins_per_window=BINS, num_windows=windows,
        seed=seed, util_mean=0.3 + 0.05 * (seed % 5))


def _host_leaves(state) -> list[np.ndarray]:
    return [x.cpu().numpy() for x in state_leaves(state)]


@dataclasses.dataclass
class ServiceResult:
    results_a: list             # WindowResult of group A, in stream order
    results_b: list             # group B's, answered from the cache
    windows_cached: int
    hit_rate: float
    restored: list[str]         # tenants restored into the fresh service
    new_windows: int            # windows the restored service served
    stale_dropped: int
    checkpointed: list          # tenant-b0's state leaves as checkpointed (host)
    evicted: list               # tenant-b0's state leaves as evicted after the
                                # restore (no window of it served since; host)
    next_window: int            # tenant-b0's evicted stream position
    bitwise_same: bool          # B-stream outputs == A-stream outputs
    launches: int               # kernel launches of the whole run


def main(argv=None) -> ServiceResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=HOSTS)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lanes, windows = args.lanes, args.windows

    def make(tenant, seed):
        return producer(tenant, seed, hosts=args.hosts, windows=windows)

    cfg = ServeConfig(
        twin=TwinConfig(bins_per_window=BINS,
                        dc=DatacenterConfig(num_hosts=args.hosts,
                                            cores_per_host=16),
                        device=str(dev)),
        lanes=lanes, queue_capacity=64)
    launches0 = sum(ops.LAUNCHES.values())
    svc = TwinService(cfg)

    def launched() -> int:
        return sum(ops.LAUNCHES.values()) - launches0

    # --- admit the first tenant group and stream it to completion --------
    for i in range(4):
        svc.admit(f"tenant-a{i}")
        svc.attach(make(f"tenant-a{i}", i))
    results_a = svc.run_until_idle()
    print(f"group A: {len(results_a)} windows served over "
          f"{svc.stats.batches} batches (fill {svc.stats.fill_ratio:.0%}, "
          f"kernel launches: {launched()})")

    # --- group B replays the same hidden models (same seeds): every window
    # is answered from the result cache, bitwise, device untouched ---------
    for i in range(4):
        svc.admit(f"tenant-b{i}")
        svc.attach(make(f"tenant-b{i}", i))
    results_b = svc.run_until_idle()
    print(f"group B: {len(results_b)} windows served, "
          f"{svc.stats.windows_cached} from cache (hit rate "
          f"{svc.cache.hit_rate:.0%}), still {launched()} kernel launches")
    windows_cached, hit_rate = svc.stats.windows_cached, svc.cache.hit_rate

    # --- checkpoint all 8 live sessions, kill, restore into a fresh
    # service; replayable producers re-emit from window 0 and every
    # already-served window drops as a stale replay -----------------------
    with tempfile.TemporaryDirectory() as root:
        svc.checkpoint(root)
        checkpointed = _host_leaves(SessionStore(root, device="cpu").load("tenant-b0").state)
        svc2 = TwinService(cfg)
        restored = svc2.restore(root)
        for i in range(4):
            svc2.attach(make(f"tenant-a{i}", i))
        new = svc2.run_until_idle()
        print(f"\nrestored {len(restored)} sessions; replayed group A "
              f"produced {len(new)} new windows "
              f"({svc2.stats.stale_dropped} stale replays dropped) — "
              "nothing is served twice")

        # --- evict one tenant; its session travels as a value ------------
        session = svc2.evict("tenant-b0")
        print(f"evicted tenant-b0 at window {session.next_window}; "
              f"{lanes - len(svc2.tenants)} of {lanes} lanes free")

    # cached results match computed ones bitwise: B-windows vs the A-stream
    # of the same seed
    a0 = {r.window: r for r in results_a if r.tenant == "tenant-a0"}
    b0 = {r.window: r for r in results_b if r.tenant == "tenant-b0"}
    same = all(
        np.array_equal(np.asarray(a0[w].output.prediction.power_w),
                       np.asarray(b0[w].output.prediction.power_w))
        for w in range(windows))
    print(f"\nB-stream outputs bitwise == A-stream outputs: {same}")
    print("one batched step served every batch above — admission order,\n"
          "fill pattern and cache hits never change the program.")
    return ServiceResult(results_a, results_b, windows_cached, hit_rate, restored,
                         len(new), svc2.stats.stale_dropped, checkpointed,
                         _host_leaves(session.state), session.next_window, same,
                         launched())


if __name__ == "__main__":
    main()
