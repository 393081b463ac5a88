"""Mixture-of-Experts FFN (Qwen1.5-MoE, DeepSeek-V2): capacity-based
scatter dispatch, as in the JAX package.

Each token is routed to its top-k experts; the tokens of an expert fill a
buffer of ``capacity`` rows in token order, later ones past it are
dropped; the expert FFN runs as one batched product over ``[E, cap, d]``
(a library GEMM, which the JAX package also leaves to XLA), and each
token sums its experts' outputs weighted by their gates.

Two orders are pinned to the JAX package's:

- **ties among router probabilities**: ``jax.lax.top_k`` puts the lower
  expert index first among equal values, and ``torch.topk`` promises no
  order; :func:`route` takes the top k of a stable descending sort.  The
  order sets both the experts and the slot order, which sets capacity
  positions;
- **dispatch**: kept tokens land in distinct buffer rows (positions are
  unique), so they are written by index (``index_copy_``), dropped ones
  into one spare row that is cut off: no accumulation, no float atomics.

Expert parallelism follows the JAX package's ``shard_map`` branch, in one
process over a :class:`~repro_torch.parallel.sharding.Mesh`: under a
:class:`~repro_torch.parallel.sharding.ShardingCtx` whose mesh has a
``model`` axis of size > 1 that divides the padded expert count, the batch
splits into blocks over the ``("pod", "data")`` axes present, and each
block runs :func:`_moe_local` once a model shard, on that mesh entry's
device, with the shard's experts.  Each block routes with the capacity of
its own token count, as a ``shard_map`` shard does, so a mesh with more
than one batch block is not the one-shard result: it is the sharded one.
The shards' ``y`` are summed in shard order on the caller's device (the
``psum`` over ``model``), ``aux`` is their sum over the shard count, then
the mean over the blocks (the ``pmean`` over the batch axes).

On a DTensor ``x`` (the per-device dry-run) the branch is the
``shard_map`` itself (:func:`_moe_sharded`): each device's block of
tokens and its shard's experts (the weights gathered over the other axes
as ``shard_map``'s ``in_specs`` ask) through :func:`_moe_local` on the
local tensors, then ``y`` summed over ``model`` and ``aux`` averaged,
collectives DTensor issues; a gradient of an input replicated over an
axis the work splits is a partial sum there, as the ``shard_map``
transpose sums it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, dense, swiglu
from repro_torch.parallel.sharding import Mesh, ShardingCtx, current_ctx, is_dtensor

Tensor = torch.Tensor

#: experts are padded so every supported model-axis size divides the count
EXPERT_PAD_TO = 16


def padded_experts(cfg: ModelConfig) -> int:
    return math.ceil(cfg.n_experts / EXPERT_PAD_TO) * EXPERT_PAD_TO


def moe_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    e = padded_experts(cfg)
    f = cfg.moe_d_ff
    s = {
        "router": ParamSpec((L, d, cfg.n_experts), (None, "embed", None),
                            scale=0.1),
        "w_gate": ParamSpec((L, e, d, f), (None, "experts", "embed", "moe_ff")),
        "w_up": ParamSpec((L, e, d, f), (None, "experts", "embed", "moe_ff")),
        "w_down": ParamSpec((L, e, f, d), (None, "experts", "moe_ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff
        s["ws_gate"] = ParamSpec((L, d, fs), (None, "embed", "ff"))
        s["ws_up"] = ParamSpec((L, d, fs), (None, "embed", "ff"))
        s["ws_down"] = ParamSpec((L, fs, d), (None, "ff", "embed"))
    return s


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    e = padded_experts(cfg)
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / e)
    return max(8, math.ceil(c / 8) * 8)


def route(x: Tensor, router: Tensor, cfg: ModelConfig, e_pad: int
          ) -> tuple[Tensor, Tensor, Tensor]:
    """``(probs [..., T, e_pad] f32, gates [..., T, k] f32, ids [..., T, k]
    int64)``: the router's softmax over the real experts (pad experts at
    -1e30), its top k in descending order, lower index first among ties,
    and their gates (normalized over the k with ``router_scale``)."""
    logits = dense(x, router).float()                        # [..., T, E_real]
    if e_pad > cfg.n_experts:                                # mask pad experts
        logits = torch.nn.functional.pad(logits, (0, e_pad - cfg.n_experts),
                                         value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = srt[..., :cfg.top_k], order[..., :cfg.top_k]
    if cfg.router_scale:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, ids


def dispatch(ids: Tensor, el: int, e0: int, cap: int) -> tuple[Tensor, Tensor]:
    """``(keep [..., T, k] bool, slot_idx [..., T, k] int64)``: each (token,
    slot)'s row ``local expert * cap + position`` in the dispatch buffer of
    the ``el`` experts from ``e0`` on, slot by slot and in token order
    within a slot (each leading index, a batch block, on its own); a token
    whose expert is not owned or already holds ``cap`` tokens is dropped
    (``keep`` False, row ``el * cap``)."""
    counts = ids.new_zeros(ids.shape[:-2] + (el,))
    experts = torch.arange(el, device=ids.device)
    keeps, slots = [], []
    for eid in ids.unbind(-1):
        lid = eid - e0                                        # local expert id
        own = (lid >= 0) & (lid < el)
        # one_hot by comparison: torch's one_hot checks its range with a
        # host read on the CPU, and dispatches other ops on each device
        oh = (lid.clamp(0, el - 1)[..., None] == experts).long() * own[..., None]
        pos = counts.unsqueeze(-2) + torch.cumsum(oh, dim=-2) - oh  # pre-increment
        pos = torch.sum(pos * oh, dim=-1)                     # [..., T]
        counts = counts + oh.sum(dim=-2)
        keep = own & (pos < cap)
        keeps.append(keep)
        slots.append(torch.where(keep, lid * cap + pos, el * cap))
    return torch.stack(keeps, dim=-1), torch.stack(slots, dim=-1)


def _moe_local(
    x: Tensor,            # [Tl, d] this shard's tokens, or [nb, Tl, d] blocks
    router: Tensor,       # [d, E_real]
    w_gate: Tensor,       # [El, d, f]   this shard's experts
    w_up: Tensor,
    w_down: Tensor,       # [El, f, d]
    *,
    cfg: ModelConfig,
    e0: int,              # first owned expert id
    n_shards: int,
) -> tuple[Tensor, Tensor]:
    """Shard-local capacity routing + expert FFN.  Returns (y, aux_loss).

    ``x`` ``[nb, Tl, d]`` runs ``nb`` batch blocks at once, each routed and
    dispatched on its own (its own capacity and aux, ``aux [nb]``), as
    ``nb`` calls on ``[Tl, d]`` would; the expert products take every
    block's rows of an expert in one batched product.
    """
    blocks = x.dim() == 3
    xb = x if blocks else x[None]
    nb, tl, d = xb.shape
    el = w_gate.shape[0]
    e_pad = el * n_shards
    cap = _capacity(tl, cfg)
    probs, gates, ids = route(x, router, cfg, e_pad)
    keep, slot_idx = dispatch(ids, el, e0, cap)
    if not blocks:
        probs, gates, ids, keep, slot_idx = (t[None] for t in (probs, gates, ids, keep,
                                                                 slot_idx))

    # Switch-style load-balance auxiliary loss (over real experts)
    experts = torch.arange(e_pad, device=x.device)
    density = (ids[..., None] == experts).any(dim=-2).float().mean(dim=-2)  # [nb, E]
    aux = torch.sum(density * probs.mean(dim=-2), dim=-1) * cfg.n_experts

    # dispatch: tokens -> [El, cap, d] buffers a block for owned experts,
    # plus one spare row a block (index el * cap) that takes every dropped
    # token
    rows_per_block = el * cap + 1
    base = (torch.arange(nb, device=x.device) * rows_per_block)[:, None] if nb > 1 else 0
    buf = torch.zeros((nb * rows_per_block, d), dtype=x.dtype, device=x.device)
    xflat = xb.reshape(nb * tl, d)
    for rows in slot_idx.unbind(-1):
        buf.index_copy_(0, (rows + base).reshape(-1), xflat)
    # every block's rows of an expert side by side: [El, nb * cap, d]
    eb = (buf.reshape(nb, rows_per_block, d)[:, :el * cap]
          .reshape(nb, el, cap, d).transpose(0, 1).reshape(el, nb * cap, d))
    h = swiglu(torch.bmm(eb, w_gate), torch.bmm(eb, w_up))
    out = torch.bmm(h.to(x.dtype), w_down)
    out = out.reshape(el, nb, cap, d).transpose(0, 1).reshape(nb * el * cap, d)

    y = torch.zeros_like(xb)
    g = (gates * keep).to(x.dtype)
    gbase = (torch.arange(nb, device=x.device) * (el * cap))[:, None] if nb > 1 else 0
    for slot in range(cfg.top_k):
        rows = slot_idx[..., slot].clamp(max=el * cap - 1) + gbase
        y = y + g[..., slot, None] * out[rows]
    return (y, aux) if blocks else (y[0], aux[0])


def expert_parallel(mesh: Mesh | None, cfg: ModelConfig) -> bool:
    """Whether :func:`moe_ffn` splits the experts over ``mesh`` (the JAX
    package's condition for its ``shard_map`` branch)."""
    return (mesh is not None and "model" in mesh.shape
            and mesh.shape["model"] > 1
            and padded_experts(cfg) % mesh.shape["model"] == 0)


def _mesh_entry(mesh: Mesh, coords: dict[str, int]):
    """The device at ``coords`` (axis -> index; an axis not named: 0)."""
    flat = 0
    for name, size in zip(mesh.axis_names, mesh.axis_sizes):
        flat = flat * size + coords.get(name, 0)
    return mesh.devices[flat]


def _batch_blocks(mesh: Mesh) -> list[dict[str, int]]:
    """The batch blocks of ``mesh`` in ``shard_map``'s order: the
    coordinates over the ``("pod", "data")`` axes present, row-major."""
    blocks: list[dict[str, int]] = [{}]
    for a in ("pod", "data"):
        if a in mesh.shape:
            blocks = [{**c, a: i} for c in blocks for i in range(mesh.shape[a])]
    return blocks


def _moe_expert_parallel(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor,
                         mesh: Mesh) -> tuple[Tensor, Tensor]:
    """Each batch block through each model shard's experts on that mesh
    entry's device; a shard's consecutive blocks that share a device run
    as one :func:`_moe_local` call on ``[blocks, Tl, d]``."""
    b, s, d = x.shape
    n_shards = mesh.shape["model"]
    blocks = _batch_blocks(mesh)
    nb = len(blocks)
    if b % nb:
        raise ValueError(f"a batch of {b} does not split into {nb} blocks "
                         f"over the mesh's batch axes")
    xb = x.reshape(nb, (b // nb) * s, d)
    el = padded_experts(cfg) // n_shards
    home = x.device
    y = aux = None
    for k in range(n_shards):
        runs: list[list] = []                   # [device, first block, end]
        for j, coords in enumerate(blocks):
            dev = _mesh_entry(mesh, {**coords, "model": k})
            if runs and runs[-1][0] == dev:
                runs[-1][2] = j + 1
            else:
                runs.append([dev, j, j + 1])
        experts = slice(k * el, (k + 1) * el)
        ys, auxes = [], []
        for dev, j0, j1 in runs:
            yk, ak = _moe_local(
                xb[j0:j1].to(dev), p["router"].to(dev), p["w_gate"][experts].to(dev),
                p["w_up"][experts].to(dev), p["w_down"][experts].to(dev),
                cfg=cfg, e0=k * el, n_shards=n_shards)
            ys.append(yk.to(home))
            auxes.append(ak.to(home))
        yk, ak = (ys[0], auxes[0]) if len(ys) == 1 else (torch.cat(ys), torch.cat(auxes))
        y = yk if y is None else y + yk           # the psum over 'model'
        aux = ak if aux is None else aux + ak
    # aux: the psum over 'model' / n_shards, then the pmean over the blocks
    return y.reshape(b, s, d), (aux / n_shards).sum() / nb


def _moe_sharded(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """The expert-parallel branch on DTensors (module docstring): one
    device's shards through :func:`_moe_local`, ``y`` placed back as ``x``
    (the ``psum`` over ``model``, an all-reduce) and ``aux`` replicated
    (its ``psum`` over ``model`` and ``pmean`` over the batch axes)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = x.device_mesh
    names = dm.mesh_dim_names
    batch = {a for a in ("pod", "data") if a in names}
    nb = math.prod(dm.size(names.index(a)) for a in batch)
    b, s, d = x.shape
    if b % nb:
        raise ValueError(f"a batch of {b} does not split into {nb} blocks "
                         f"over the mesh's batch axes")
    n_shards = dm.size(names.index("model"))
    rep = Replicate()

    def local(t, split, grad):
        pl = [split(a) for a in names]
        return t.redistribute(dm, pl).to_local(grad_placements=[grad(a, q)
                                                                for a, q in zip(names, pl)])

    def part(a, q):                    # replicated -> a partial-sum gradient
        return q if isinstance(q, Shard) else Partial()

    x_pl = lambda a: Shard(0) if a in batch else rep  # noqa: E731
    xl = local(x, x_pl, part)
    rl = local(p["router"], lambda a: rep, part)
    ws = [local(p[k], lambda a: Shard(0) if a == "model" else rep, part)
          for k in ("w_gate", "w_up", "w_down")]
    bl, sl = xl.shape[:2]
    el = ws[0].shape[0]
    y, aux = _moe_local(xl.reshape(bl * sl, d), rl, *ws, cfg=cfg,
                        e0=dm.get_local_rank("model") * el, n_shards=n_shards)
    y = DTensor.from_local(y.reshape(bl, sl, d), dm,
                           [Shard(0) if a in batch else Partial() for a in names],
                           run_check=False, shape=x.shape, stride=x.stride())
    aux = DTensor.from_local(aux / n_shards, dm,
                             [Partial("avg") if a in batch else Partial() for a in names],
                             run_check=False, shape=torch.Size(()), stride=())
    return (y.redistribute(dm, [x_pl(a) for a in names]),
            aux.redistribute(dm, [rep] * len(names)))


def moe_ffn(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor,
            ctx: ShardingCtx | None = None) -> tuple[Tensor, Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux scalar).

    ``ctx`` (default: the ambient one, :func:`current_ctx`) decides the
    branch: experts split over its mesh's ``model`` axis where
    :func:`expert_parallel` holds (a batch the batch axes do not divide
    raises ``ValueError``, as ``shard_map`` refuses it), all experts on
    ``x``'s device otherwise (the JAX package's mesh-less branch).
    """
    b, s, d = x.shape
    mesh = (current_ctx() if ctx is None else ctx).mesh
    if expert_parallel(mesh, cfg):
        y, aux = (_moe_sharded(cfg, p, x) if is_dtensor(x)
                  else _moe_expert_parallel(cfg, p, x, mesh))
    else:
        yflat, aux = _moe_local(x.reshape(b * s, d), p["router"], p["w_gate"],
                                p["w_up"], p["w_down"], cfg=cfg, e0=0, n_shards=1)
        y = yflat.reshape(b, s, d)
    if cfg.n_shared_experts:
        h = swiglu(dense(x, p["ws_gate"]), dense(x, p["ws_up"]))
        y = y + dense(h, p["ws_down"])
    return y, aux
