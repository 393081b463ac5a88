"""Op-by-op cost of one step in eager PyTorch (the port's counterpart of
``repro.analysis.hlo``).

The JAX package reads its costs from compiled HLO text, multiplying loop
bodies by their trip counts.  Eager PyTorch compiles nothing and has no
HLO: each aten op is dispatched as the step runs, so :func:`trace_cost`
runs the step itself, on ``meta`` tensors for a dry-run (shapes only,
nothing allocated or computed) or on real ones, under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode of its
own, and counts:

  * FLOPs: the counter's dot-like products (``mm``, ``bmm``, ``addmm``,
    convolutions, ...) and the two LM kernels' registered formulas
    (``kernels/ops.py``): the ops ``hlo.py`` charges as ``dot``;
  * HBM bytes: operands plus results of every op that is not a view
    (eager PyTorch fuses nothing, so each op reads and writes HBM once);
    an op's tensors are counted once each, and an ``empty`` moves nothing;
  * ops, and the high-water mark of live storage bytes the step allocates
    (storages its ops create, freed when their last tensor dies).

A dispatch mode is off while it handles an op, so a kernel operator's
body (the kernel's launch, or its plain version on the CPU) is one op:
the count is the same on the card, the CPU and ``meta``.  One process issues no
collectives, so there are no collective bytes: ``None``, never 0.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops as _ops  # noqa: F401  (registers the kernel ops' FLOPs)

Tensor = torch.Tensor

#: ops that allocate without touching memory
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float | None = None  # per-device wire bytes; None: not modelled
    coll_counts: dict[str, int] = dataclasses.field(default_factory=dict)


def _view_key(t: Tensor) -> tuple:
    """A tensor's identity as an operand: its storage and its view of it."""
    return (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape),
            tuple(t.stride()), t.dtype)


class _CostMode(TorchDispatchMode):
    """Counts ops, their bytes and the live bytes of the storages they create."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.num_ops = 0
        self.live = 0
        self.peak_live = 0
        self._tracked: set[int] = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_storages]
        if not outs or func.is_view or (not func._schema.is_mutable and not fresh):
            return out                  # metadata, a view or an alias: no traffic
        self.num_ops += 1
        if func.overloadpacket.__name__ not in _NO_TRAFFIC:
            seen = {_view_key(t): t.numel() * t.element_size() for t in ins + outs}
            self.cost.bytes += sum(seen.values())
        for t in fresh:
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            self._tracked.add(key)
            n = st.nbytes()
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def trace_cost(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its cost (module
    docstring).  Returns the JAX package's keys (``flops_per_device``,
    ``bytes_per_device``, ``collective_wire_bytes_per_device``: None,
    ``collective_counts``) for the whole step on the caller's devices, plus
    ``num_ops``, ``peak_live_bytes`` (beyond the arguments) and ``out``,
    ``fn``'s result."""
    cm = _CostMode()
    with cm, FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return {
        "flops_per_device": float(fc.get_total_flops()),
        "bytes_per_device": float(cm.cost.bytes),
        "collective_wire_bytes_per_device": None,
        "collective_counts": dict(cm.cost.coll_counts),
        "num_ops": cm.num_ops,
        "peak_live_bytes": cm.peak_live,
        "out": out,
    }
