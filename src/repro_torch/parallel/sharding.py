"""Device meshes and lane sharding (port of the mesh half of
``repro.parallel.sharding``).

A :class:`Mesh` is an ordered tuple of ``torch.device`` s with named axes,
the counterpart of ``jax.sharding.Mesh``: ``mesh.shape`` maps each axis to
its size, and the devices are laid out row-major over the axes.  A mesh
may name one device more than once.  torch has a single CPU device, so a
mesh of four ``cpu`` entries is the port's counterpart of the JAX
package's ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, and on a
host with one card a mesh of ``cuda:0`` four times splits a batch into
four launches on that card.

Lane sharding is one process over the mesh's devices, as the JAX
package's ``shard_map`` over a 1-D mesh is: :func:`shard_lanes` pads the
lane axis by replicating lane 0 (every lane-carrying tensor, a fill mask
too), splits it into equal contiguous shards and moves shard ``k`` to the
mesh's ``k``-th device; the caller runs its
unsharded lane code on each shard; :func:`gather_lanes` brings the
results back, in lane order, onto the caller's device and slices the
padding off.  There is no process group and no fallback: a mesh entry that
names a card the host lacks raises.

The logical-axis rules of the JAX module live here too: every parameter
and activation carries a tuple of *logical* axis names, and a rule table
per execution mode (:data:`RULES`, the JAX package's verbatim) maps them
onto mesh axes:

  train:  DP over 'pod', FSDP (ZeRO-3) over 'data', TP over 'model'
  serve:  replicas over ('pod','data'), TP over 'model'  (weight-stationary)

:func:`logical_to_spec` turns a leaf's axes and shape into a :class:`P`
(the ``PartitionSpec`` counterpart), dropping a mapping whose dim the
mesh axes do not divide and using each mesh axis at most once;
:class:`NamedSharding` gives the per-device shard shape.  The dry-run
(``launch/dryrun.py``) reads the rules on a mesh of ``meta`` entries
(:func:`abstract_mesh_compat`), and ``models/moe.py``'s expert-parallel
branch reads the ambient :class:`ShardingCtx` (:func:`use_ctx`,
:func:`current_ctx`).  One process places nothing by a constraint:
:func:`constraint` and :func:`activation` check the leaf's rank and return
the tensor itself.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch._device import resolve_device

Tensor = torch.Tensor


def _canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card's index filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over named axes.

    ``devices`` holds ``prod(axis_sizes)`` entries (repeats allowed); each
    is checked on construction, so a card the host lacks raises here.
    """

    devices: tuple
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names must be distinct, got {self.axis_names}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")
        n = math.prod(self.axis_sizes)
        if len(self.devices) != n:
            raise ValueError(f"a mesh of shape {tuple(self.axis_sizes)} needs {n} "
                             f"devices, got {len(self.devices)}")
        object.__setattr__(self, "devices", tuple(_canonical(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes", tuple(int(s) for s in self.axis_sizes))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh_compat(shape, axes, *, devices) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes`` on exactly ``devices``
    (strings or ``torch.device`` s, row-major; repeats allowed)."""
    return Mesh(devices=tuple(devices), axis_names=tuple(axes),
                axis_sizes=tuple(int(s) for s in shape))


def mesh_axis_size(mesh: Mesh, axis: Any) -> int:
    """Size of a mesh axis, of a tuple of axes (their product), or 1 for
    ``None``."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return int(mesh.shape[axis])


# -- lane sharding ------------------------------------------------------------

def lane_devices(mesh: Mesh, axis: str) -> tuple:
    """The devices of a 1-D mesh over ``axis``, one a shard, re-checked
    against the cards present."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"lane sharding takes a 1-D mesh over {axis!r}; got "
                         f"axes {mesh.axis_names}")
    return tuple(_canonical(d) for d in mesh.devices)


def lane_padding(n: int, entries: int) -> tuple[int, int]:
    """``(lanes a shard, lanes of padding)`` for ``n`` lanes over
    ``entries`` shards: equal shards, and at least 2 lanes a shard when
    there is more than one (the JAX package's rule, which it keeps for an
    XLA fault; kept here so both split a batch alike)."""
    if n < 1:
        raise ValueError("lane sharding needs at least one lane")
    per = -(-n // entries)
    if entries > 1:
        per = max(per, 2)
    return per, per * entries - n


def map_tensors(fn: Callable, *trees):
    """``fn`` over the matching tensors of ``trees`` (a tensor, or
    dataclasses, tuples and lists of them; other values are taken from
    the first tree as they are)."""
    x = trees[0]
    if isinstance(x, Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        new = {f.name: map_tensors(fn, *(getattr(t, f.name) for t in trees))
               for f in dataclasses.fields(x)}
        if all(new[k] is getattr(x, k) for k in new):
            return x
        return dataclasses.replace(x, **new)
    if isinstance(x, (tuple, list)):
        items = [map_tensors(fn, *xs) for xs in zip(*trees)]
        if all(a is b for a, b in zip(items, x)):
            return x
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def _has_lanes(x: Tensor, axis: int, n: int, where: str) -> bool:
    """Whether ``x`` carries the lane axis (a tensor of rank <= ``axis``
    is shared by every lane); a lane axis of another length raises."""
    if x.dim() <= axis:
        return False
    if x.shape[axis] != n:
        raise ValueError(f"{where}: a leaf of shape {tuple(x.shape)} has "
                         f"{x.shape[axis]} lanes on axis {axis}, not {n}")
    return True


def shard_lanes(tree, devices: tuple, n: int, axis: int, where: str = "lanes") -> list:
    """``tree`` (``n`` lanes on ``axis``) as one tree a device: the lanes
    padded by :func:`lane_padding` with copies of lane 0, shard ``k``
    holding lanes ``[k * per, (k + 1) * per)``, contiguous, on
    ``devices[k]``; a tensor without the lane axis goes whole to every
    device."""
    per, pad = lane_padding(n, len(devices))

    def piece(k, dev):
        def leaf(x):
            if _has_lanes(x, axis, n, where):
                if pad:
                    shape = list(x.shape)
                    shape[axis] = pad
                    x = torch.cat([x, x.narrow(axis, 0, 1).expand(shape)], dim=axis)
                x = x.narrow(axis, k * per, per)
            return x.to(dev).contiguous()
        return map_tensors(leaf, tree)

    return [piece(k, dev) for k, dev in enumerate(devices)]


def gather_lanes(shards: list, n: int, axis: int, home: torch.device):
    """The shards' results joined on ``axis`` in shard order, on ``home``,
    cut to the first ``n`` lanes."""
    def join(*xs):
        return torch.cat([x.to(home) for x in xs], dim=axis).narrow(axis, 0, n).contiguous()

    return map_tensors(join, *shards)


def lane_mesh(axis: str, num_devices: "int | None" = None,
              device: "str | torch.device" = "cuda") -> Mesh:
    """A 1-D mesh over ``axis``: the first ``num_devices`` cards (default:
    every card) when ``device`` is a CUDA device, or ``num_devices``
    entries of the CPU (default 1) when it is ``"cpu"``.  Asking for more
    cards than the host has raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if num_devices is None else int(num_devices)
        if n > have:
            raise RuntimeError(f"a mesh of {n} cards requested, this host has {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n = 1 if num_devices is None else int(num_devices)
        devices = [dev] * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return make_mesh_compat((n,), (axis,), devices=devices)


# -- logical-axis rules -------------------------------------------------------

LogicalAxes = tuple[str | None, ...]


def abstract_mesh_compat(shape, axes) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes`` whose entries are all the
    ``meta`` device: the rules and shard shapes of a production mesh with
    no card behind it (the counterpart of ``jax.sharding.AbstractMesh``)."""
    return make_mesh_compat(shape, axes, devices=["meta"] * math.prod(shape))


#: mode -> logical axis -> mesh axis (or tuple of mesh axes)
RULES: dict[str, dict[str, Any]] = {
    "train": {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": "data",        # ZeRO-3: shard the replicated dim over data
        "embed_nofsdp": None,
        "heads": "model",
        "kv_heads": "model",
        "qk": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "moe_ff": None,
        "lora": None,
        "dstate": None,
        "conv": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "attn_q_seq": "model",   # context-parallel fallback for attention
        "frames": None,
        "patches": None,
        "cache_seq": None,
        "cache_heads": "model",
    },
    "serve": {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,          # weight-stationary TP: no FSDP gather latency
        "embed_nofsdp": None,
        "heads": "model",
        "kv_heads": "model",
        "qk": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "moe_ff": None,
        "lora": None,
        "dstate": None,
        "conv": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "attn_q_seq": "model",   # context-parallel fallback for attention
        "frames": None,
        "patches": None,
        "cache_seq": "model",
        "cache_heads": "model",
    },
}


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``'s counterpart): one
    entry a dim, each ``None`` (replicated), a mesh axis name, or a tuple
    of mesh axis names; trailing ``None`` s are trimmed."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def logical_to_spec(axes: LogicalAxes, shape: tuple[int, ...], mesh: Mesh,
                    mode: str = "train") -> P:
    """Map logical axes to a :class:`P`, dropping non-divisible shardings.

    Each dim's rule keeps the mesh axes present with size > 1 and not yet
    used by an earlier dim; the dim is replicated when none is left or
    their product does not divide it.
    """
    rules = RULES[mode]
    used: set[str] = set()
    parts: list[Any] = []
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            parts.append(None)
            continue
        flat = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        flat = tuple(a for a in flat
                     if a in mesh.shape and mesh.shape[a] > 1 and a not in used)
        if not flat or dim % mesh_axis_size(mesh, flat) != 0:
            parts.append(None)          # absent, or non-divisible -> replicate
            continue
        used.update(flat)
        parts.append(flat if len(flat) > 1 else flat[0])
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`P` on a mesh: how a global array splits into shards."""

    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """Each device's block of ``global_shape``; a dim its mesh axes do
        not divide raises, as ``jax.sharding.NamedSharding`` does."""
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            n = mesh_axis_size(self.mesh, entry)
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does not split "
                                 f"over {entry!r} ({n} ways)")
            out.append(dim // n)
        return tuple(out)


def _is_axes(x) -> bool:
    """Whether ``x`` is a leaf's logical axes (a tuple of names and Nones)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh: Mesh,
                   mode: str = "train") -> Any:
    """:class:`NamedSharding` s for a tree of axes beside a tree of shaped
    leaves (tensors or anything with ``.shape``), in the same structure."""
    def walk(axes, shaped):
        if _is_axes(axes):
            return NamedSharding(mesh, logical_to_spec(axes, tuple(shaped.shape),
                                                       mesh, mode))
        if isinstance(axes, dict):
            return {k: walk(axes[k], shaped[k]) for k in axes}
        if isinstance(axes, (list, tuple)):
            items = [walk(a, b) for a, b in zip(axes, shaped)]
            return type(axes)(*items) if hasattr(axes, "_fields") else type(axes)(items)
        raise TypeError(f"no axes at a leaf of type {type(axes).__name__}")

    return walk(axes_tree, shape_tree)


def constraint(x: Tensor, axes: LogicalAxes, mesh: Mesh | None,
               mode: str = "train") -> Tensor:
    """``with_sharding_constraint`` through logical axes (a no-op without a
    mesh).  One process holds the whole tensor, so there is nothing to
    move: under a mesh the spec is checked against ``x``'s rank, as JAX
    refuses a spec longer than it, and ``x`` itself comes back."""
    if mesh is not None and len(axes) > x.dim():
        raise ValueError(f"logical axes {axes} for a tensor of rank {x.dim()}")
    return x


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """The mesh and mode a step runs under, read by layers that split work
    over the mesh (the MoE's expert-parallel branch)."""

    mesh: Mesh | None = None
    mode: str = "train"

    def on(self, x: Tensor, *axes: str | None) -> Tensor:
        return constraint(x, tuple(axes), self.mesh, self.mode)


# -- ambient context ----------------------------------------------------------
# Step factories bind the ShardingCtx here for the length of a step, so deep
# layers read it without threading ctx through every call signature.

_AMBIENT: contextvars.ContextVar[ShardingCtx] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=ShardingCtx())


def current_ctx() -> ShardingCtx:
    return _AMBIENT.get()


@contextlib.contextmanager
def use_ctx(ctx: ShardingCtx):
    tok = _AMBIENT.set(ctx)
    try:
        yield ctx
    finally:
        _AMBIENT.reset(tok)


def activation(x: Tensor, *axes: str | None) -> Tensor:
    """Constrain an activation under the ambient :class:`ShardingCtx`: the
    rank checked, ``x`` itself returned (see :func:`constraint`)."""
    return _AMBIENT.get().on(x, *axes)
