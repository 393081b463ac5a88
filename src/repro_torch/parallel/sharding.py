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
:func:`current_ctx`).

The per-device dry-run runs a step on DTensors: :func:`device_mesh` gives
a :class:`Mesh`'s ``torch.distributed`` ``DeviceMesh`` (same axis names
and sizes) over a ``fake`` process group of ``mesh.size`` ranks in this
one process, which issues every collective a rank would and moves no
byte; :func:`to_placements` turns a :class:`NamedSharding` into DTensor
placements, and :func:`distribute` makes a DTensor of a global tensor's
shard.  On a DTensor, :func:`constraint` (and :func:`activation`)
redistributes to the placements the rules give, as
``with_sharding_constraint`` does under ``jit``; a plain tensor comes
back as it is, so a one-process step moves nothing.  Only the dry-run
creates a process group.  :func:`checkpoint` is a train step's remat
region on DTensors, which keeps its residuals split over ``model`` as
XLA keeps a partitioned step's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import weakref
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


# -- DTensor bridge (the per-device dry-run) ----------------------------------

_MESHES: dict[tuple, Any] = {}


def _fake_world(size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``size`` ranks
    (re-made when another size is asked for); a real process group already
    bound raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group of backend "
                               f"{dist.get_backend()!r} is bound; the dry-run's "
                               "fake group cannot replace it")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    # importing the module registers the ``fake`` backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def close_fake_world() -> None:
    """Take down the dry-run's ``fake`` process group, if one is bound."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
    _MESHES.clear()


def device_mesh(mesh: Mesh):
    """``mesh`` as a ``torch.distributed.device_mesh.DeviceMesh`` of the same
    axis names and sizes over a ``fake`` group of ``mesh.size`` ranks
    (:func:`_fake_world`): a DTensor on it runs rank 0's shard and issues
    rank 0's collectives.  ``meta`` entries make a ``cpu`` mesh (the
    shards are ``meta`` tensors), card entries a ``cuda`` one."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.ops import register_sharding_rules

    register_sharding_rules()
    kind = "cuda" if mesh.devices[0].type == "cuda" else "cpu"
    _fake_world(mesh.size)
    key = (mesh.devices[0].type, mesh.axis_names, mesh.axis_sizes)
    if key not in _MESHES:
        dm = DeviceMesh(kind, torch.arange(mesh.size).reshape(mesh.axis_sizes),
                        mesh_dim_names=mesh.axis_names)
        if mesh.devices[0].type == "meta":
            # DTensor moves a shard between dims with an all-to-all on a
            # card mesh and with an all-gather on a ``cpu`` one (gloo has
            # no all-to-all): a mesh of ``meta`` shards issues the card's
            dm._device_type = "cuda"
        _MESHES[key] = dm
    return _MESHES[key]


def to_placements(sharding: NamedSharding) -> list:
    """DTensor placements of a :class:`NamedSharding`, one a mesh axis:
    ``Shard(d)`` on each mesh axis that splits dim ``d`` (a dim split over
    a tuple of axes is ``Shard(d)`` on each of them, in the tuple's order,
    as ``P(("pod", "data"))`` splits it), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = sharding.mesh.axis_names
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(sharding.spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return out


def distribute(x: Tensor, sharding: NamedSharding, *, device=None) -> Tensor:
    """A DTensor of ``x``'s global shape and dtype placed by ``sharding``,
    its shard zeros (``x``'s values are not read) on ``device`` (default:
    the mesh's first entry; ``meta`` allocates nothing)."""
    from torch.distributed.tensor import DTensor

    dev = sharding.mesh.devices[0] if device is None else torch.device(device)
    local = torch.zeros(sharding.shard_shape(tuple(x.shape)), dtype=x.dtype, device=dev)
    shape = torch.Size(x.shape)
    stride = contiguous_strides(shape)
    return DTensor.from_local(local, device_mesh(sharding.mesh), to_placements(sharding),
                              run_check=False, shape=shape, stride=stride)


def contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, not read
    off a tensor: no op runs)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def splits(x: Tensor, *dims: int) -> bool:
    """Whether ``x`` is a DTensor split on each of ``dims`` (over some mesh
    axis): the helpers below take their per-shard form only then, so a
    DTensor on a mesh of size-1 axes runs the plain ops."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard

    split = {p.dim for p in x.placements if isinstance(p, Shard)}
    return all(d % x.dim() in split for d in dims)


def write_token(cache: Tensor, rows: Tensor, idx: Tensor, val: Tensor) -> None:
    """``cache[rows, idx] = val`` (``rows`` the ``arange`` of the batch),
    in place: a decode step's new cache entry at each row's position.  On a DTensor
    cache (rows and positions maybe split over the mesh) each shard writes
    the rows it holds whose position falls in its block of positions, as
    XLA partitions a dynamic update into a cache split on its sequence:
    ``val`` and ``idx`` are first placed as the cache's rows (and the
    other dims) are, so no shard gathers the cache."""
    if not any(splits(cache, d) for d in range(cache.dim())):
        cache[rows, idx] = val.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm, pl = cache.device_mesh, cache.placements
    val_pl = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1 else Replicate()
              for p in pl]
    idx_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    v = val.to(cache.dtype).redistribute(dm, val_pl).to_local()
    i = idx.redistribute(dm, idx_pl).to_local()
    loc = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, dm, pl)
    rel = i - offset[1]
    inside = ((rel >= 0) & (rel < loc.shape[1])).reshape((-1,) + (1,) * (v.dim() - 1))
    rel = rel.clamp(0, loc.shape[1] - 1)
    rows = rows[:loc.shape[0]]
    loc[rows, rel] = torch.where(inside, v, loc[rows, rel])


def embed_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``: the rows of an embedding table.  On a DTensor table
    each device looks up its own ids.  Where the rows (the vocabulary) are
    split over some mesh axes each shard looks up the ids in its block
    (clamped to it), zeroes the rest, and the result is a partial sum over
    those axes, as XLA partitions a gather from a split operand; where they
    are not, each device looks up its own ids, the table gathered on the
    axes that split the ids.  A table whose rows are whole but whose
    columns are split where the ids are (ZeRO-3's embedding under a
    vocabulary ``model`` does not divide) keeps its columns: the ids are
    gathered instead, each device looks up every row in its columns, and
    their gradient is whole there (the caller places the rows it wants, as
    ``lm.embed_tokens`` does).  The backward's scatter then runs on local
    tensors, where DTensor's own ``index`` leaves it an ``index_put`` that
    not every torch version places.  A plain table indexes as it is."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = table.device_mesh
    ipl = ids.placements if is_dtensor(ids) else [Replicate()] * dm.ndim
    split = any(isinstance(p, Shard) and p.dim == 0 for p in table.placements)
    # rows whole, columns split where the ids are: the ids are gathered
    columns = not split and any(
        isinstance(p, Shard) and isinstance(q, Shard) for p, q in zip(table.placements, ipl))
    x_pl, i_pl, o_pl, g_pl = [], [], [], []
    for p, q in zip(table.placements, ipl):
        if isinstance(p, Shard) and p.dim == 0:
            x_pl.append(p), i_pl.append(Replicate()), o_pl.append(Partial()), g_pl.append(p)
        elif columns and isinstance(p, Shard) and isinstance(q, Shard):
            x_pl.append(p), i_pl.append(Replicate()), g_pl.append(p)
            o_pl.append(Shard(ids.dim() + p.dim - 1))
        elif isinstance(q, Shard):
            x_pl.append(Replicate()), i_pl.append(q), o_pl.append(q), g_pl.append(Partial())
        else:
            x_pl.append(Replicate()), i_pl.append(Replicate()), o_pl.append(Replicate())
            g_pl.append(Replicate())
    xl = table.redistribute(dm, x_pl).to_local(grad_placements=g_pl)
    il = ids.redistribute(dm, i_pl).to_local() if is_dtensor(ids) else ids
    if split:
        _, offset = compute_local_shape_and_global_offset(table.shape, dm, x_pl)
        rel = il - offset[0]
        inside = (rel >= 0) & (rel < xl.shape[0])
        out = xl[rel.clamp(0, xl.shape[0] - 1)] * inside[..., None].to(xl.dtype)
    else:
        out = xl[il]
    shape = list(ids.shape) + list(table.shape[1:])
    return DTensor.from_local(out, dm, o_pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def channelwise(fn: Callable, x: Tensor, *params: Tensor) -> Tensor:
    """``fn(x, *params)`` for ``x [B, S, C]`` and ``params`` ``[..., C]``,
    ``fn`` acting on each batch row and channel apart (a depthwise conv
    over the sequence).  On a DTensor ``x`` each device runs ``fn`` on its
    shards: ``x`` split as it is on its rows and channels (its sequence
    gathered), each param split on its last dim as ``x``'s channels are; a
    param's gradient is a partial sum over the axes that split the rows."""
    if not is_dtensor(x):
        return fn(x, *params)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm, last = x.device_mesh, x.dim() - 1
    x_pl, split = [], []
    for p in x.placements:
        keep = isinstance(p, Shard) and p.dim in (0, last)
        x_pl.append(p if keep else Replicate())
        split.append(p.dim if keep else None)
    xl = x.redistribute(dm, x_pl).to_local(grad_placements=x_pl)
    locs = []
    for t in params:
        pl = [Shard(t.dim() - 1) if d == last else Replicate() for d in split]
        grad = [Shard(t.dim() - 1) if d == last else Partial() if d == 0 else Replicate()
                for d in split]
        locs.append(t.redistribute(dm, pl).to_local(grad_placements=grad))
    return DTensor.from_local(fn(xl, *locs), dm, x_pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _product_plan(x: Tensor, w: Tensor) -> tuple[list, ...]:
    """The placements, one a mesh axis, of a weight product ``x [..., K] @
    w [K, N]`` on DTensors, as XLA partitions a dot: ``(x, w, y, y out,
    dx, dx out, dw)``, each product formed in the first placement of its
    pair and leaving in the second.  On an axis that splits ``x``'s tokens
    (a dim but the last) ``w`` is gathered, ``y`` and ``dx`` split as
    ``x`` and ``dw`` is a partial sum; on one that splits the contraction
    (``x`` on K or ``w`` on its rows, the other sliced to match) ``y`` is
    a partial sum, reduced at once, and ``dx`` and ``dw`` split on K; on
    one that splits ``w``'s columns (``x`` gathered) ``y`` and ``dw``
    split on N and ``dx`` is a partial sum, left to its consumers (the
    q, k and v projections' add up before one reduction).  An axis that
    splits neither operand forms its share of the first token dim it
    divides, so no two devices form the same rows, and gathers ``y`` whole
    again (``dx`` stays split for its consumers); with no such dim (a
    decode step's one token), its share of the contraction, ``y`` reduced
    at once; with neither, all whole.  Such a split nests inside the axes
    already splitting that dim only where they come before it in the mesh
    (else the shards would be moved, a weight's among them)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.dim() - 1
    r, k = Replicate(), Shard(last)
    contraction = (k, Shard(0), Partial(), r, k, k, Shard(0))
    rows: list = []
    for p, q in zip(x.placements, w.placements):
        if isinstance(p, Shard) and p.dim != last:
            rows.append((p, r, p, p, p, p, Partial()))
        elif isinstance(q, Shard) and q.dim == 1:
            rows.append((r, q, k, k, Partial(), Partial(), q))
        elif isinstance(p, Shard) or (isinstance(q, Shard) and q.dim == 0):
            rows.append(contraction)
        else:
            rows.append(None)
    # the mesh axes splitting each dim of x: a new split of a dim nests
    # inside these, so only an axis after them all splits it in place
    axes = {d: [i for i, row in enumerate(rows) if row is not None and row[0] == Shard(d)]
            for d in range(last + 1)}

    def splits_in_place(i: int, d: int) -> bool:
        ways = math.prod(x.device_mesh.size(j) for j in axes[d]) * x.device_mesh.size(i)
        return all(j < i for j in axes[d]) and x.shape[d] % ways == 0

    for i, row in enumerate(rows):
        if row is not None:
            continue
        free = [d for d in range(last) if splits_in_place(i, d)]
        if free:
            axes[free[0]].append(i)
            t = Shard(free[0])
            rows[i] = (t, r, t, r, t, t, Partial())
        elif splits_in_place(i, last):
            axes[last].append(i)
            rows[i] = contraction
        else:
            rows[i] = (r,) * 7
    return tuple(list(col) for col in zip(*rows))


def _folded_mm(a: Tensor, b: Tensor) -> Tensor:
    """``torch.matmul(a, b)`` for a 2-D ``b`` as one ``mm`` over ``a``'s
    leading dims folded, as autograd's ``matmul`` folds them (without
    gradients ``matmul`` may broadcast ``b`` into a ``bmm`` instead, which
    a "dots" remat region does not keep)."""
    return torch.mm(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], b.shape[-1])


_PARTIAL_SUMS: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_partial_sums", default=False)


@contextlib.contextmanager
def partial_sums(on: bool = True):
    """While ``on``, a weight product split on its contraction leaves its
    output a partial sum (:func:`matmul`) instead of reducing it at once:
    for outputs added up before one reduction (a parallel block's
    attention and MLP, whose all-reduces XLA reassociates into one)."""
    tok = _PARTIAL_SUMS.set(bool(on))
    try:
        yield
    finally:
        _PARTIAL_SUMS.reset(tok)


def _placed(t: Tensor, mesh, formed: list, out: list, shape) -> Tensor:
    """Local ``t`` as a DTensor of ``shape`` placed ``formed``, moved to
    ``out``."""
    from torch.distributed.tensor import DTensor

    d = DTensor.from_local(t, mesh, formed, run_check=False, shape=torch.Size(shape),
                           stride=contiguous_strides(shape))
    return d if formed == out else d.redistribute(mesh, out)


class _Product(torch.autograd.Function):
    """``torch.matmul(x, w)`` of DTensors on each device's shards, forward
    and backward, by :func:`_product_plan`: no product sees a token
    gathered over an axis that splits the tokens or a ``w`` column
    gathered over one that splits the columns, whatever placements the
    gradient arrives in.  ``dw`` leaves in ``w``'s own placements (a
    partial sum reduce-scattered into its ZeRO-3 split)."""

    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import Partial, Replicate

        dm = x.device_mesh
        px, pw, py, ctx.y_out, ctx.pdx, ctx.dx_out, ctx.pdw = _product_plan(x, w)
        if _PARTIAL_SUMS.get():
            ctx.y_out = [p if isinstance(p, Partial) else o for p, o in zip(py, ctx.y_out)]
        # the gradient arrives whole where the product was a partial sum
        ctx.pdy = [Replicate() if isinstance(p, Partial) else p for p in py]
        xl = x.redistribute(dm, px).to_local()
        wl = w.redistribute(dm, pw).to_local()
        ctx.save_for_backward(xl, wl)
        ctx.mesh, ctx.x_shape, ctx.w_spec = dm, x.shape, (w.shape, list(w.placements))
        region = _REGION.get()
        if region is not None and region.replaying:
            return region.replay()
        y = _placed(_folded_mm(xl, wl), dm, py, ctx.y_out, (*x.shape[:-1], w.shape[-1]))
        if region is not None:
            region.record(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        xl, wl = ctx.saved_tensors
        dm = ctx.mesh
        dyl = dy.redistribute(dm, ctx.pdy).to_local()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _placed(_folded_mm(dyl, wl.t()), dm, ctx.pdx, ctx.dx_out, ctx.x_shape)
        if ctx.needs_input_grad[1]:
            shape, placements = ctx.w_spec
            dwl = torch.mm(xl.reshape(-1, xl.shape[-1]).t(), dyl.reshape(-1, dyl.shape[-1]))
            dw = _placed(dwl, dm, ctx.pdw, placements, shape)
        return dx, dw


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """``torch.matmul(x, w)`` for a weight product, ``x [..., K]`` and ``w
    [K, N]``.  On two DTensors, on each device's shards in its forward and
    its backward (:class:`_Product`), as XLA partitions the dot and its
    gradients; DTensor's own choice per op would gather the tokens or the
    columns in the backward.  Plain tensors run ``torch.matmul`` itself,
    but inside a ``"dots"`` region on DTensors (a device's shards, as the
    MoE's router sees them) :class:`_Dot`."""
    if not (is_dtensor(x) and is_dtensor(w)):
        if _REGION.get() is not None and w.dim() == 2:
            return _Dot.apply(x, w)
        return torch.matmul(x, w)
    return _Product.apply(x, w)


class _Dot(torch.autograd.Function):
    """``torch.matmul(x, w)`` of plain tensors, ``w`` 2-D, whose output a
    ``"dots"`` region records in its forward and replays in its recompute,
    as :class:`_Product` does for DTensors."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        region = _REGION.get()
        if region.replaying:
            return region.replay()
        y = _folded_mm(x, w)
        region.record(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _folded_mm(dy, w.t())
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.reshape(-1, x.shape[-1]).t(), dy.reshape(-1, dy.shape[-1]))
        return dx, dw


# -- the train step's checkpoint on DTensors -----------------------------------

#: the ``"dots"`` region whose forward or recompute is running (its weight
#: products recorded or replayed by :class:`_Product` and :class:`_Dot`)
_REGION: contextvars.ContextVar[_Region | None] = contextvars.ContextVar(
    "repro_torch_remat_region", default=None)


class _StopRecompute(Exception):
    """A region's recompute has given back every tensor its forward saved."""


class _Holder:
    """What a region's forward saves in place of a tensor: the tensors its
    recompute gives back, by the backward pass (graph task) that asked."""

    __slots__ = ("tensors", "__weakref__")

    def __init__(self):
        self.tensors: dict[int, Tensor] = {}


class _SeqShard:
    """A DTensor ``[B, S, ...]`` kept as the device's block of its sequence
    over ``model``, and put back whole (an all-gather) by :meth:`get`."""

    def __init__(self, t: Tensor, m: int, shard: list, requires_grad: bool):
        n = t.device_mesh.size(m)
        local = t.to_local()
        rows = local.shape[1] // n
        r = t.device_mesh.get_local_rank(m)
        # a copy: a view of the slice would keep the whole block alive
        self.local = local.narrow(1, r * rows, rows).clone(memory_format=torch.contiguous_format)
        self.mesh, self.placements, self.shard = t.device_mesh, list(t.placements), shard
        self.shape, self.requires_grad = t.shape, requires_grad

    def get(self) -> Tensor:
        from torch.distributed.tensor import DTensor

        t = DTensor.from_local(self.local, self.mesh, self.shard, run_check=False,
                               shape=self.shape, stride=contiguous_strides(self.shape))
        return t.redistribute(self.mesh, self.placements).requires_grad_(self.requires_grad)


def _stash(t):
    """``t`` as a region keeps it: a floating DTensor ``[B, S, ...]``
    replicated over a ``model`` axis that divides its local sequence (and
    no later axis splits) as a :class:`_SeqShard` (a slice, no
    collective); anything else as it is."""
    if not is_dtensor(t) or t.dim() < 3 or not t.dtype.is_floating_point:
        return t
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return t
    m, pl = names.index("model"), list(t.placements)
    n = t.device_mesh.size(m)
    if (n == 1 or not isinstance(pl[m], Replicate) or t.to_local().shape[1] % n
            or any(isinstance(p, Shard) and p.dim == 1 for p in pl[m + 1:])):
        return t
    return _SeqShard(t.detach(), m, pl[:m] + [Shard(1)] + pl[m + 1:], t.requires_grad)


def _blank(like: Tensor) -> Callable[[], Tensor]:
    """What makes an uninitialized tensor of ``like``'s shape, dtype and
    device (of a DTensor's placements too), keeping nothing of ``like``."""
    local = like.to_local() if is_dtensor(like) else like
    shape, dtype, device = local.shape, local.dtype, local.device
    if not is_dtensor(like):
        return lambda: torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    mesh, placements, whole = like.device_mesh, list(like.placements), like.shape
    return lambda: DTensor.from_local(torch.empty(shape, dtype=dtype, device=device), mesh,
                                      placements, run_check=False, shape=whole,
                                      stride=contiguous_strides(whole))


def _storage_key(t: Tensor) -> int:
    """The identity of the storage under ``t`` (a DTensor's local tensor's,
    an unwaited collective's result's)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    while True:
        if is_dtensor(t):
            t = t._local_tensor
        elif isinstance(t, AsyncCollectiveTensor):
            t = t.elem
        else:
            return id(t.untyped_storage())


def _provenance_mode():
    """A dispatch mode that follows which of a region's weight products each
    storage made in its forward derives from (``src``: storage -> product
    indices), every op's outputs from its inputs; a storage freed and its
    id reused only adds indices (a product kept that need not be)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Provenance(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.src: dict[int, frozenset] = {}

        def of(self, t: Tensor) -> frozenset:
            return self.src.get(_storage_key(t), frozenset())

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            src = frozenset().union(*(self.of(t) for t in tree_leaves((args, kwargs))
                                      if isinstance(t, Tensor)))
            if src:
                for t in tree_leaves(out):
                    if isinstance(t, Tensor):
                        key = _storage_key(t)
                        self.src[key] = self.src.get(key, frozenset()) | src
            return out

    return Provenance()


class _Region:
    """One call of a checkpointed region on DTensors (:func:`checkpoint`).

    Forward: the region runs with gradients on, each tensor its autograd
    graph saves replaced by a :class:`_Holder` (nothing kept); the
    arguments are kept through :func:`_stash`.  Under ``dots`` each weight
    product's output (:class:`_Product`) is recorded, a dispatch mode
    follows what each storage derives from, and once the region has run
    the outputs some saved tensor derives from are kept (:func:`_stash`),
    the others dropped.  Backward: the first holder unpacked runs the
    region again on the arguments put back (the recompute), each product
    replaying its kept output (a dropped one gives an uninitialized
    placeholder of its shape and placements: nothing saved reads it), the
    ``i``-th tensor saved filling the ``i``-th holder; it stops at the last
    one, as ``torch.utils.checkpoint``'s early stop does."""

    def __init__(self, fn: Callable, dots: bool):
        self.fn, self.dots = fn, dots
        self.inputs: list = []
        self.holders: list = []
        self.products: list = []
        self.needed: set[int] = set()
        self.provenance = None
        self.replaying, self.cursor = False, 0
        self.recomputed: set[int] = set()

    def run(self, args: tuple):
        with torch.no_grad():
            self.inputs = [_stash(a) for a in args]
        if self.dots:
            self.provenance = _provenance_mode()
        tok = _REGION.set(self if self.dots else None)
        try:
            with (torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack),
                  self.provenance or contextlib.nullcontext()):
                out = self.fn(*args)
        finally:
            _REGION.reset(tok)
        self.provenance = None
        with torch.no_grad():
            self.products = [(_stash(y) if i in self.needed else None, blank)
                             for i, (y, blank) in enumerate(self.products)]
        return out

    def record(self, y: Tensor) -> None:
        """A product's output ``y`` in the forward."""
        self.provenance.src[_storage_key(y)] = frozenset((len(self.products),))
        self.products.append((y.detach(), _blank(y)))

    def replay(self) -> Tensor:
        """The next product's output in the recompute: kept, or a
        placeholder of its shape (and placements)."""
        kept, blank = self.products[self.cursor]
        self.cursor += 1
        if kept is None:
            return blank()
        return kept.get() if isinstance(kept, _SeqShard) else kept.detach()

    def _pack(self, t: Tensor) -> _Holder:
        holder = _Holder()
        self.holders.append(weakref.ref(holder))
        if self.provenance is not None:
            self.needed |= self.provenance.of(t)
        return holder

    def _unpack(self, holder: _Holder) -> Tensor:
        gid = torch._C._current_graph_task_id()
        if gid not in self.recomputed:
            self._recompute(gid)
            self.recomputed.add(gid)
        return holder.tensors.pop(gid)

    def _recompute(self, gid: int) -> None:
        args = [a.get() if isinstance(a, _SeqShard) else a for a in self.inputs]
        n, count = len(self.holders), 0

        def pack(t: Tensor) -> Tensor:
            nonlocal count
            if count == n:
                raise RuntimeError("a region's recompute saved more tensors than its forward")
            holder = self.holders[count]()
            count += 1
            if holder is not None:
                holder.tensors[gid] = t.detach()
            if count == n:
                raise _StopRecompute
            # not ``t``: a node saving its own output would hold itself
            # through it, a cycle that keeps every recomputed tensor alive
            return t.detach()

        self.replaying, self.cursor = True, 0
        tok = _REGION.set(self if self.dots else None)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                    torch.enable_grad():
                self.fn(*args)
        except _StopRecompute:
            pass
        finally:
            _REGION.reset(tok)
            self.replaying = False
        if count < n:
            raise RuntimeError(f"a region's recompute saved {count} tensors, its forward {n}")


def checkpoint(fn: Callable, *args, dots: bool = False):
    """``fn(*args)`` as a checkpointed region of DTensors
    (:class:`_Region`), as XLA keeps a partitioned step's remat
    residuals: an argument ``[B, S, ...]`` replicated over ``model`` is
    kept as the device's block of its sequence and gathered again when the
    backward recomputes the region; under ``dots`` the weight products'
    outputs that the backward reads are kept too, so split, and no 2-D
    product is recomputed."""
    return _Region(fn, dots).run(args)


def kernel_placements(x: Tensor, heads: int, groups: int = 0) -> list:
    """The placements a kernel operator's operands take on each mesh axis
    (its sharding rule's strategies, ``kernels/ops.py``), chosen from
    ``x``'s own: split on the heads (dim ``heads``) where ``x`` is and the
    axis divides ``groups`` (the kv heads or SSM groups; 0: no such
    check), on the batch (dim 0) where ``x`` is, else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    dm = x.device_mesh
    out = []
    for i, p in enumerate(x.placements):
        if (isinstance(p, Shard) and p.dim == heads
                and (not groups or groups % dm.size(i) == 0)):
            out.append(Shard(heads))
        elif isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def on_shards(fn: Callable, args: list, placements: list, outs: list) -> tuple:
    """``fn`` on one device's shards of DTensor ``args``: each redistributed
    to its ``placements`` (a list a mesh axis), ``fn`` run on the local
    tensors, and its results (``None`` passed through) made DTensors by
    ``outs``, a ``(placements, global shape)`` each.  The way a kernel's
    backward runs per shard, as its forward does under its sharding
    rule."""
    from torch.distributed.tensor import DTensor

    dm = args[0].device_mesh
    local = [a.redistribute(dm, pl).to_local() for a, pl in zip(args, placements)]
    return tuple(None if t is None else DTensor.from_local(
        t.contiguous(), dm, pl, run_check=False, shape=shape,
        stride=contiguous_strides(shape))
        for t, (pl, shape) in zip(fn(*local), outs))


def shard_einsum(eq: str, a: Tensor, b: Tensor, rule: Callable) -> Tensor:
    """``torch.einsum(eq, a, b)`` of two DTensors on each device's shards:
    ``rule(p)`` maps each of ``b``'s placements to ``(a's, b's, the
    output's)`` on that mesh axis (a contraction over a split dim gives a
    ``Partial`` output), so a product over a dim ``b`` keeps split (a
    cache's sequence) runs where the shards lie, one product a shard,
    where DTensor's einsum would merge that dim and gather ``b``.  For a
    step under ``no_grad`` (decode)."""
    from torch.distributed.tensor import DTensor

    dm = b.device_mesh
    pls = [rule(p) for p in b.placements]
    al = a.redistribute(dm, [p[0] for p in pls]).to_local()
    bl = b.redistribute(dm, [p[1] for p in pls]).to_local()
    ins, out = eq.replace(" ", "").split("->")
    size = {c: n for t, x in zip(ins.split(","), (a, b)) for c, n in zip(t, x.shape)}
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(torch.einsum(eq, al, bl), dm, [p[2] for p in pls],
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


class _ShardedNLL(torch.autograd.Function):
    """The NLL summed over a chunk's non-ignored labels, of DTensor logits
    ``[..., V]`` split on their rows, their vocabulary or both, on each
    device's shard, forward and backward.  Forward: the shard's row max,
    all-reduced over the axes that split the vocabulary, the shard's sum of
    exponentials and its picked logit (the label's, where it falls in the
    shard's block of the vocabulary), all-reduced over them together, the
    log-sum-exp, and the masked sum, a partial sum over the axes that split
    the rows.  Backward: ``g (softmax - onehot) mask`` of the shard in
    float32, cast to the logits' dtype, left in their placements: no
    collective and no buffer beyond the shard.  DTensor's own ops would
    place the gradient from the one it gets (over the whole vocabulary, or
    at the global batch's rows for a rows-split ``gather``)."""

    @staticmethod
    def forward(ctx, logits, labels, ignore):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        dm, pl, last = logits.device_mesh, list(logits.placements), logits.dim() - 1
        vocab = [isinstance(p, Shard) and p.dim == last for p in pl]
        rows_pl = [p if isinstance(p, Shard) and not v else Replicate()
                   for p, v in zip(pl, vocab)]
        yl = labels.redistribute(dm, rows_pl).to_local()
        xl = logits.to_local()
        _, offset = compute_local_shape_and_global_offset(logits.shape, dm, pl)
        rows = logits.shape[:-1]

        def over_vocab(t: Tensor, op: str, lead=()) -> Tensor:
            if not any(vocab):
                return t
            shape = torch.Size((*lead, *rows))
            shard = [Shard(p.dim + len(lead)) if isinstance(p, Shard) else p for p in rows_pl]
            t_pl = [Partial(op) if v else q for v, q in zip(vocab, shard)]
            return DTensor.from_local(t, dm, t_pl, run_check=False, shape=shape,
                                      stride=contiguous_strides(shape)).redistribute(
                dm, shard).to_local()

        mask = yl != ignore
        rel = yl.long() - offset[last]
        inside = mask & (rel >= 0) & (rel < xl.shape[-1])
        rel = rel.clamp(0, xl.shape[-1] - 1)
        xf = xl.to(torch.float32, copy=True)
        picked = torch.gather(xf, -1, rel[..., None])[..., 0] * inside
        m = over_vocab(xf.amax(dim=-1), "max")
        sums = over_vocab(torch.stack([xf.sub_(m[..., None]).exp_().sum(dim=-1), picked]),
                          "sum", (2,))
        lse = sums[0].log() + m
        ctx.save_for_backward(xl, rel, lse, mask, inside)
        ctx.mesh, ctx.placements, ctx.shape = dm, pl, logits.shape
        total = ((lse - sums[1]) * mask).sum()
        return DTensor.from_local(total, dm, [Partial() if isinstance(p, Shard) else Replicate()
                                              for p in rows_pl],
                                  run_check=False, shape=torch.Size(()), stride=())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        xl, rel, lse, mask, inside = ctx.saved_tensors
        dm = ctx.mesh
        if is_dtensor(g):
            g = g.redistribute(dm, [Replicate()] * dm.ndim).to_local()
        g = g.float()
        grad = xl.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        grad.mul_((g * mask)[..., None])
        grad.scatter_add_(-1, rel[..., None], -(g * inside)[..., None])
        return (DTensor.from_local(grad.to(xl.dtype), dm, ctx.placements, run_check=False,
                                   shape=ctx.shape, stride=contiguous_strides(ctx.shape)),
                None, None)


def nll_sum(logits: Tensor, labels: Tensor, ignore: int = -100) -> Tensor:
    """The NLL of DTensor ``logits [..., V]`` summed over DTensor ``labels``
    other than ``ignore``, log-sum-exp and picked logit in float32, on each
    device's shard forward and backward (:class:`_ShardedNLL`); a partial
    sum over the axes that split the rows."""
    return _ShardedNLL.apply(_reduced(logits), labels, ignore)


def _reduced(t: Tensor) -> Tensor:
    """DTensor ``t`` with every ``Partial`` placement all-reduced."""
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def softmax_last(x: Tensor) -> Tensor:
    """``torch.softmax(x, -1)``.  On a DTensor split on its last dim (a
    decode step's logits over a sequence-split cache) the softmax of the
    shards: each shard's max, their max (an all-reduce of the rows), each
    shard's sum of exponentials, their sum (another) and the division, as
    XLA partitions the reduction; DTensor's own ``softmax`` would gather
    the logits whole on every device."""
    if not splits(x, -1):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - _reduced(x.detach().amax(dim=-1, keepdim=True)))
    return e / _reduced(e.sum(dim=-1, keepdim=True))


def argmax_last(x: Tensor) -> Tensor:
    """``torch.argmax(x, -1)``.  On a DTensor, on each device's shards: each
    shard's first maximum and its global index (the shard's offset added);
    where the last dim (the vocabulary) is split, the rows' max over the
    shards (an all-reduce) and the least index among the shards that hold
    it (another), which is ``torch.argmax``'s first occurrence: ties across
    shards resolve as on the whole row.  The result is split as ``x``'s
    other dims are."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    x = _reduced(x)
    dm, last, shape = x.device_mesh, x.dim() - 1, x.shape[:-1]
    xl = x.to_local()
    idx = torch.argmax(xl, dim=-1, keepdim=True)
    top = torch.gather(xl, -1, idx)[..., 0]
    _, offset = compute_local_shape_and_global_offset(x.shape, dm, x.placements)
    on_last = [isinstance(p, Shard) and p.dim == last for p in x.placements]

    def over_shards(t: Tensor, op: str) -> Tensor:
        pl = [Partial(op) if s else p for s, p in zip(on_last, x.placements)]
        return _reduced(DTensor.from_local(t, dm, pl, run_check=False, shape=shape,
                                           stride=contiguous_strides(shape))).to_local()

    mine = over_shards(top, "max") == top
    none = torch.full_like(idx[..., 0], x.shape[-1])
    first = over_shards(torch.where(mine, idx[..., 0] + offset[last], none), "min")
    return DTensor.from_local(first, dm, [Replicate() if s else p
                                          for s, p in zip(on_last, x.placements)],
                              run_check=False, shape=shape, stride=contiguous_strides(shape))


def cumsum(x: Tensor, dim: int) -> Tensor:
    """``torch.cumsum(x, dim)``.  On a DTensor not split on ``dim``, on
    each device's shards (:func:`on_shards`), forward and backward: the
    backward's ``flip`` then acts on local tensors, where DTensor's own
    ``cumsum`` leaves its backward a DTensor ``flip`` that not every torch
    version places."""
    if not is_dtensor(x) or splits(x, dim):
        return torch.cumsum(x, dim=dim)
    x = _reduced(x)
    pl = list(x.placements)
    return on_shards(lambda t: (torch.cumsum(t, dim=dim),), [x], [pl], [(pl, x.shape)])[0]


def unsplit(y: Tensor, dim: int, lead: int) -> Tensor:
    """A DTensor ``y`` with dim ``dim`` gathered over every mesh axis that
    splits it but does not divide ``lead``, the first of the dims ``dim``
    is about to be viewed as (a product's flattened output unflattened
    into heads a model axis does not divide: no shard can view it); any
    other tensor as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard

    dim %= y.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and lead % y.device_mesh.size(i) else p for i, p in enumerate(y.placements)]
    return y if pl == list(y.placements) else y.redistribute(y.device_mesh, pl)


class _Merge(torch.autograd.Function):
    """``t.reshape(shape)`` merging ``t``'s dims from ``dim`` on into dim
    ``dim`` of ``shape``, its gradient first :func:`unsplit` there (the
    backward views the merged dim apart again).  A strided shard whose
    dims merge is made contiguous on the device, placements kept, so the
    merge is a ``view`` (DTensor's ``reshape`` copies into an
    ``_unsafe_view``, and its copy of a partial sum reduce-scatters it,
    unevenly where ``model`` does not divide the heads)."""

    @staticmethod
    def forward(ctx, t, shape, dim):
        from torch.distributed.tensor import DTensor

        ctx.in_shape, ctx.dim = t.shape, dim
        local = t.to_local()
        if t.dim() > len(shape) and not (local.is_contiguous() and t.is_contiguous()):
            t = DTensor.from_local(local.contiguous(), t.device_mesh, t.placements,
                                   run_check=False, shape=t.shape,
                                   stride=contiguous_strides(t.shape))
        return t.view(shape)

    @staticmethod
    def backward(ctx, g):
        return unsplit(g, ctx.dim, ctx.in_shape[ctx.dim]).reshape(ctx.in_shape), None, None


def merge(t: Tensor, shape, dim: int) -> Tensor:
    """``t.reshape(shape)``, where ``shape`` merges ``t``'s dims from ``dim``
    on into one; on a DTensor through :class:`_Merge`, so the gradient's
    view apart finds a dim a shard can view."""
    if not is_dtensor(t):
        return t.reshape(shape)
    return _Merge.apply(t, tuple(shape), dim)


def write_rows(x: Tensor, rows: Tensor, pos: Tensor, val: Tensor) -> Tensor:
    """``x[rows, pos] = val`` (``rows [B, 1]`` the batch's ``arange``,
    ``pos [B, P]``, ``val [B, P, ...]``): in place on a plain tensor; on a
    DTensor ``x`` split on its rows (not on ``pos``'s dim), out of place on
    each device's shard, ``pos`` and ``val`` placed as ``x``'s rows are
    (DTensor has no in-place rule for it)."""
    if not is_dtensor(x):
        x[rows, pos] = val.to(x.dtype)
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm, pl = x.device_mesh, x.placements
    if any(isinstance(p, Shard) and p.dim == 1 for p in pl):
        raise NotImplementedError("a row write into a DTensor split on the written dim")
    rows_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    loc = x.to_local()
    v = val.to(x.dtype).redistribute(dm, pl).to_local()
    i = pos.redistribute(dm, rows_pl).to_local()
    loc = loc.index_put((rows[:loc.shape[0]], i), v)
    return DTensor.from_local(loc, dm, pl, run_check=False, shape=x.shape, stride=x.stride())


def constraint(x: Tensor, axes: LogicalAxes, mesh: Mesh | None,
               mode: str = "train") -> Tensor:
    """``with_sharding_constraint`` through logical axes (a no-op without a
    mesh).  Under a mesh the spec is checked against ``x``'s rank, as JAX
    refuses a spec longer than it; a DTensor is redistributed to the
    placements :func:`logical_to_spec` gives (a ``Partial`` sum becomes a
    reduce-scatter or an all-reduce, a gather an all-gather), and any
    other tensor comes back itself: one process holds it whole."""
    if mesh is None:
        return x
    if len(axes) > x.dim():
        raise ValueError(f"logical axes {axes} for a tensor of rank {x.dim()}")
    if not is_dtensor(x):
        return x
    want = to_placements(NamedSharding(mesh, logical_to_spec(
        tuple(axes) + (None,) * (x.dim() - len(axes)), tuple(x.shape), mesh, mode)))
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


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
def use_ctx(ctx: ShardingCtx | None):
    """Bind ``ctx`` as the ambient context for the block; ``None`` keeps the
    one already bound (an entry called without a ``ctx``)."""
    if ctx is None:
        yield _AMBIENT.get()
        return
    tok = _AMBIENT.set(ctx)
    try:
        yield ctx
    finally:
        _AMBIENT.reset(tok)


def activation(x: Tensor, *axes: str | None) -> Tensor:
    """Constrain an activation under the ambient :class:`ShardingCtx` (see
    :func:`constraint`: a DTensor is redistributed, a plain tensor comes
    back itself)."""
    return _AMBIENT.get().on(x, *axes)
