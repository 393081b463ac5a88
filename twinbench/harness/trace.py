"""The device trace of a traced window (``--trace 1``).

``torch.profiler`` records the host's ops and the card's kernels and copies;
:class:`Trace` reduces them to what the per-layer readers take: device time
by kernel name, the busy time (the union of device intervals) inside the
window, and the idle gaps, each named by the innermost host event that
covered it.  The events are read from the profiler's raw results, not
through ``key_averages()``, which builds a tree of every event.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

#: host span that bounds the traced window in the profiler's clock
WINDOW_SPAN = "twinbench.window"


#: the harness's own host spans, which name the idle gaps they cover
SPAN_PREFIXES = ("twinbench.", "whatif.", "replay.")
#: characters of a kernel's or an op's name kept in the breakdown
NAME_CHARS = 96


class Trace:
    """``device`` and ``host`` are ``(start_ns, end_ns, name)`` intervals on
    the profiler's clock: the card's kernels and copies, and the host's ops
    and spans."""

    def __init__(self, window_s: float, device: list, host: list):
        self.window_s = window_s
        lo, hi = _window_bounds(host)
        dev = sorted((s, e, n) for s, e, n in device if e > lo and s < hi)
        self.device_s = collections.Counter()
        for s, e, n in dev:
            self.device_s[n] += (min(e, hi) - max(s, lo)) * 1e-9
        merged = []
        for s, e, _ in dev:
            s, e = max(s, lo), min(e, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        self.idle_by_host = _name_gaps(self.gaps, host)

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds one of ``parts``."""
        return sum(v for n, v in self.device_s.items() if any(p in n for p in parts))

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in self.device_s.most_common(top)],
                "idle_gaps": [[n[:NAME_CHARS], v] for n, v in self.idle_by_host.most_common(top)]}


def _window_bounds(host: list) -> tuple[int, int]:
    for s, e, n in host:
        if n == WINDOW_SPAN:
            return s, e
    raise RuntimeError(f"no {WINDOW_SPAN!r} span in the trace")


def _covering(events: list, starts: list, t: int, reach: int):
    """The latest-starting of ``events`` (sorted) that covers ``t``, looking
    back at most ``reach`` events, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - reach, -1), -1):
        if events[k][1] > t:
            return events[k][2]
    return None


def _name_gaps(gaps: list, host: list) -> collections.Counter:
    """Seconds of device idleness by what the host was doing at each gap's
    middle: the harness span around it and the innermost op inside that,
    ``span/op`` (just ``span`` where the host ran Python or numpy)."""
    spans = sorted(x for x in host if x[2].startswith(SPAN_PREFIXES) and x[2] != WINDOW_SPAN)
    ops = sorted(x for x in host if not x[2].startswith(SPAN_PREFIXES))
    s_starts, o_starts = [x[0] for x in spans], [x[0] for x in ops]
    out = collections.Counter()
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        span = _covering(spans, s_starts, mid, len(spans)) or "outside the harness's spans"
        op = _covering(ops, o_starts, mid, 64)
        out[span if op is None else f"{span}/{op}"] += (hi - lo) * 1e-9
    return out


@contextlib.contextmanager
def traced(torch, enabled: bool, sink: list):
    """Profile the body when ``enabled`` and append its :class:`Trace` to
    ``sink``; otherwise run it as is.  The body runs inside the
    :data:`WINDOW_SPAN` span either way."""
    if not enabled:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t_read = time.perf_counter()
    cpu = torch.autograd.DeviceType.CPU
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, d = ev.start_ns(), ev.duration_ns()
        if d <= 0:
            continue
        if ev.device_type() == cpu:
            host.append((s, s + d, ev.name()))
        elif not ev.is_user_annotation():
            # the card's kernels and copies; a host span's device-side
            # shadow (a user annotation) is no device work
            device.append((s, s + d, ev.name()))
    spans = {n for _, _, n in host if n.startswith(SPAN_PREFIXES)}
    sink.append(Trace(window_s, [x for x in device if x[2] not in spans], host))
    sink[-1].read_s = time.perf_counter() - t_read
