"""Op-by-op cost of one step in eager PyTorch (the port's counterpart of
``repro.analysis.hlo``).

The JAX package reads its costs from compiled HLO text, multiplying loop
bodies by their trip counts.  Eager PyTorch compiles nothing and has no
HLO: each aten op is dispatched as the step runs, so :func:`trace_cost`
runs the step itself, on ``meta`` tensors for a dry-run (shapes only,
nothing allocated or computed) or on real ones, under a dispatch mode
of its own, and counts:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (its decompositions
    too): the dot-like products (``mm``, ``bmm``, ``addmm``,
    convolutions, ...) and the kernel operators' registered formulas
    (``kernels/ops.py``): the ops ``hlo.py`` charges as ``dot``, and
    ``des_place``'s operations;
  * HBM bytes: operands plus results of every op that is not a view
    (eager PyTorch fuses nothing, so each op reads and writes HBM once);
    an op's tensors are counted once each, and an ``empty`` moves nothing;
  * ops, and the high-water mark of live storage bytes the step allocates
    (storages its ops create, freed when their last tensor dies), and the
    largest single storage among them (its bytes, op and shape).

A dispatch mode is off while it handles an op, so a kernel operator's
body (the kernel's launch, or its plain version on the CPU) is one op:
the count is the same on the card, the CPU and ``meta``.

On DTensors (the per-device dry-run: ``parallel.sharding.distribute``)
the count moves below DTensor's dispatch: the mode hands a DTensor op on
(``NotImplemented``), DTensor runs it on one device's shards, and the mode
counts those local ops, the kernel operators still one op each, and the
shards' live bytes.  It also counts each collective DTensor issues (its
``_c10d_functional`` op) with the wire bytes ``repro.analysis.hlo``
charges, for a group of ``g`` ranks: all-gather ``out (g-1)/g``,
all-reduce ``2 out (g-1)/g``, reduce-scatter ``in (g-1)/g``, all-to-all
``max(in, out) (g-1)/g``; an all-to-all's output is charged as its own
storage, as a card's op allocates it (the op's ``meta`` kernel slices it
from a buffer the group's size).  The ops DTensor runs on global shapes to
propagate metadata (on fake tensors) are not the device's and are not
counted.  A step on plain tensors issues no collectives: its wire bytes
are ``None`` (not modelled), never 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops as _ops  # noqa: F401  (registers the kernel ops' FLOPs)
from repro_torch.models import rope

Tensor = torch.Tensor

#: ops that allocate without touching memory
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}

#: ops the flop counter hands back unhandled (metadata queries)
_METADATA = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
             "is_non_overlapping_and_dense", "size", "sym_size", "stride", "sym_stride",
             "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim",
             "layout"}

#: the collectives of ``torch.distributed._functional_collectives``, by
#: the name ``hlo.py`` counts them under, with the wire bytes a device
#: sends for ``(in bytes, out bytes, group size)``
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", lambda i, o, g: o * (g - 1) / g),
    "all_reduce": ("all-reduce", lambda i, o, g: 2.0 * o * (g - 1) / g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda i, o, g: i * (g - 1) / g),
    "all_to_all_single": ("all-to-all", lambda i, o, g: max(i, o) * (g - 1) / g),
    "shard_dim_alltoall": ("all-to-all", lambda i, o, g: max(i, o) * (g - 1) / g),
}
_COMM_NAMESPACES = ("_c10d_functional", "_dtensor")


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


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x) if isinstance(t, Tensor))


def _group_size(args) -> int:
    """The size of the process group a collective names (its last string
    argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class _CostMode(TorchDispatchMode):
    """Counts FLOPs (the flop counter's formulas), ops, their bytes, the
    live bytes of the storages they create and the collectives; on
    DTensors, of one device's shards (module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.num_ops = 0
        self.live = 0
        self.peak_live = 0
        self.largest = {"bytes": 0, "op": None, "shape": None}
        self.sharded = False
        self._deferred = False
        self.fallbacks: dict[str, int] = {}
        self.op_counts: dict[str, int] = {}
        self.wire_by_kind: dict[str, float] = {}
        self._propagating = 0
        self._tracked: set[int] = set()
        self._flops = FlopCounterMode(display=False)

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _track(self, outs, op: str) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            self._tracked.add(key)
            n = st.nbytes()
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            if n > self.largest["bytes"]:
                self.largest = {"bytes": n, "op": op, "shape": list(t.shape)}
            weakref.finalize(st, self._free, key, n)

    def _collective(self, func, args, out) -> None:
        name, wire = _COLLECTIVES[func.overloadpacket.__name__]
        g = _group_size(args)
        self.cost.coll_counts[name] = self.cost.coll_counts.get(name, 0) + 1
        sent = wire(_nbytes(args[0]), _nbytes(out), g) if g > 1 else 0.0
        self.cost.coll_bytes = (self.cost.coll_bytes or 0.0) + sent
        self.wire_by_kind[name] = self.wire_by_kind.get(name, 0.0) + sent
        self._track([t for t in tree_leaves(out) if isinstance(t, Tensor)],
                    func.overloadpacket.__name__)

    def _sharded(self, func, args, kwargs):
        """A DTensor op, handed back to DTensor under this mode (the next
        DTensor call it sees is this one: ``_deferred``); where DTensor has
        no strategy for its placements (this torch's DTensor raises), run
        on the inputs gathered whole instead (:meth:`_replicated`)."""
        self._deferred = True
        try:
            with self:
                return func(*args, **kwargs)
        except Exception as err:        # noqa: BLE001 — retried whole, else raised
            self._deferred = False
            try:
                return self._replicated(func, args, kwargs)
            except Exception:
                raise err from None

    def _replicated(self, func, args, kwargs):
        """``func`` on its DTensor inputs redistributed to ``Replicate`` (the
        gathers counted), its outputs replicated DTensors; an input the op
        writes gets its shard of the result back.  Counted by op name in
        ``fallbacks``."""
        from torch.distributed.tensor import Replicate
        from torch.utils._pytree import tree_map_only

        dts = [a for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]
        mesh = dts[0].device_mesh
        rep = [Replicate()] * mesh.ndim

        def whole(a):           # a replicated input: its shard itself
            return a.redistribute(mesh, rep).to_local()

        def wrap(t):
            return DTensor.from_local(t, mesh, rep, run_check=False)

        with self, torch.no_grad():
            full_args, full_kwargs = tree_map_only(DTensor, whole, (args, kwargs))
            out = func(*full_args, **full_kwargs)
            written = [(a, f) for a, f, spec in zip(args, full_args, func._schema.arguments)
                       if isinstance(a, DTensor) and spec.alias_info is not None
                       and spec.alias_info.is_write]
            for a, f in written:
                if list(a.placements) != rep:
                    a.to_local().copy_(wrap(f).redistribute(mesh, a.placements).to_local())
        name = func.overloadpacket.__name__
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        if written:
            return written[0][0] if len(written) == 1 else tuple(a for a, _ in written)
        return tree_map_only(Tensor, wrap, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.sharded = True
            if self._deferred:
                self._deferred = False
                return NotImplemented   # DTensor runs it on the shards, counted below
            return self._sharded(func, args, kwargs)
        if (self._propagating or any(issubclass(t, FakeTensor) for t in types)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None):
            return func(*args, **kwargs)  # DTensor's sharding propagation, global shapes
        if func.overloadpacket.__name__ in _METADATA:
            return NotImplemented
        if func.namespace in _COMM_NAMESPACES:
            out = func(*args, **kwargs)
            if (func.overloadpacket.__name__ == "shard_dim_alltoall"
                    and out.untyped_storage().nbytes() > out.nbytes):
                # the op's meta kernel returns its slice of a buffer the
                # group's size; a card's op returns a tensor of its own
                out = out.clone()
            if func.overloadpacket.__name__ in _COLLECTIVES:
                self._collective(func, args, out)
            return out
        if func is not torch.ops.prim.device.default:
            with self:                  # the flop counter's decompositions
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self._flops._count_flops(func.overloadpacket, out, args, kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_storages]
        if not outs or func.is_view or (not func._schema.is_mutable and not fresh):
            return out                  # metadata, a view or an alias: no traffic
        self.num_ops += 1
        self.op_counts[func.overloadpacket.__name__] = self.op_counts.get(
            func.overloadpacket.__name__, 0) + 1
        if func.overloadpacket.__name__ not in _NO_TRAFFIC:
            seen = {_view_key(t): t.numel() * t.element_size() for t in ins + outs}
            self.cost.bytes += sum(seen.values())
        self._track(fresh, func.overloadpacket.__name__)
        return out


#: DTensor's sharding propagator's entry points: the ops they run (on fake
#: tensors of the global shapes, once a schema) are no device's
_PROPAGATION = ("propagate", "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _propagation_marked(cm: _CostMode):
    """Mark ``cm`` as inside DTensor's sharding propagation while one of
    its entry points runs (each wrapped on the propagator for the block),
    so the mode passes those ops through uncounted."""
    prop = DTensor._op_dispatcher.sharding_propagator
    wrapped = []
    for name in _PROPAGATION:
        real = getattr(prop, name, None)
        if real is None:
            continue

        def marked(*a, _real=real, **k):
            cm._propagating += 1
            try:
                return _real(*a, **k)
            finally:
                cm._propagating -= 1

        setattr(prop, name, marked)
        wrapped.append(name)
    try:
        yield
    finally:
        for name in wrapped:
            delattr(prop, name)


def trace_cost(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its cost (module
    docstring).  Returns the JAX package's keys (``flops_per_device``,
    ``bytes_per_device``, ``collective_wire_bytes_per_device``,
    ``collective_counts``) plus ``num_ops`` (and ``op_counts``, by op
    name), ``peak_live_bytes`` (beyond the arguments), ``largest_alloc``
    (the largest storage an op created: its ``bytes``, the ``op`` and the
    ``shape`` of the tensor it returned, which may view only part of it),
    ``dtensor_fallbacks`` (the DTensor ops run on gathered inputs, by name)
    and ``out``, ``fn``'s result.  On plain tensors the count is the whole
    step's on the caller's devices and the wire bytes are ``None``; on
    DTensors it is one device's, with its wire bytes (0.0 where no
    collective ran).

    RoPE's per-device tables are dropped first, so every trace counts
    their construction and a count does not depend on what ran before it
    in the process."""
    rope.clear_tables()
    cm = _CostMode()
    with cm, _propagation_marked(cm):
        out = fn(*args, **kwargs)
    wire = cm.cost.coll_bytes
    if wire is None and cm.sharded:
        wire = 0.0
    return {
        "flops_per_device": float(cm._flops.get_total_flops()),
        "bytes_per_device": float(cm.cost.bytes),
        "collective_wire_bytes_per_device": wire,
        "collective_counts": dict(cm.cost.coll_counts),
        "collective_wire_bytes_by_kind": dict(cm.wire_by_kind),
        "num_ops": cm.num_ops,
        "peak_live_bytes": cm.peak_live,
        "largest_alloc": dict(cm.largest),
        "dtensor_fallbacks": dict(cm.fallbacks),
        "op_counts": dict(cm.op_counts),
        "out": out,
    }
