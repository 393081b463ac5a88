"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``
tensors (port of ``repro.launch.dryrun``).

For each cell: the production mesh of ``meta`` entries
(``make_production_mesh(device="meta")``), the params, AdamW moments,
decode state and batch as DTensors over that mesh's ``DeviceMesh`` (a
``fake`` process group of 256 or 512 ranks in this one process), each
leaf placed by the cell's rules as JAX's ``in_shardings`` place it, its
shard a ``meta`` tensor (nothing allocated); the step factory under a
``ShardingCtx`` of that mesh, whose ``activation`` constraints
redistribute the activations; then one run of the step under
``analysis.cost.trace_cost``, which counts one device's shard below
DTensor: its FLOPs, bytes, ops and live bytes, and every collective
DTensor issues, with its wire bytes.  The outputs are placed as JAX's
``out_shardings`` ask (a train step's params and moments as they came
in, the metrics replicated; a decode step's state as it came in, its
token replicated where JAX leaves the choice to the compiler), and that
placing is part of the step.

The record is the JAX dry-run's: per device, the argument bytes (exact:
each leaf's ``NamedSharding.shard_shape``), the output bytes (the
outputs' shards), the temp bytes (the shard's live-byte peak beyond its
arguments and outputs), the alias bytes (the donated arguments, as
JAX's ``donate_argnums``: params and moments for train, the decode
state for decode, none for prefill) and the peak, arg + out + temp -
alias; the per-device FLOPs and bytes as counted on the shard, the
collective wire bytes and counts, and the global FLOPs and bytes of the
same step on plain ``meta`` tensors beside them; the H100 roofline over
the per-device count.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
        --cells mamba2-370m:train_4k,seamless-m4t-medium:decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the cells written
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --shape train_4k \
        --layers 2 --out results/dryrun_torch_2l   # every arch cut to 2 layers

Each record's ``dtensor_fallbacks`` counts the ops this torch's DTensor
could not place, run on their inputs gathered whole (``analysis.cost``);
torch versions differ there, so check it on the host that will run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._tree import leaves
from repro_torch.analysis.cost import trace_cost
from repro_torch.analysis.roofline import make_roofline, model_flops_for
from repro_torch.configs import all_archs, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, batch_axes, cell_supported, input_structs
from repro_torch.launch.steps import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
    param_specs_for,
    state_specs_for,
)
from repro_torch.models.common import abstract_params, specs_to_shardings
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state
from repro_torch.parallel.sharding import (
    P,
    NamedSharding,
    ShardingCtx,
    distribute,
    is_dtensor,
    logical_to_spec,
    make_mesh_compat,
    to_placements,
)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, mode: str):
    structs = input_structs(cfg, shape)
    axes = batch_axes(cfg, shape)
    return {
        k: NamedSharding(mesh, logical_to_spec(axes[k], tuple(v.shape), mesh, mode))
        for k, v in structs.items()
    }


def sharded_bytes(tensors, shardings) -> int:
    """Bytes a device holds of a tree of tensors beside a tree of
    :class:`NamedSharding` s of the same structure."""
    ts, ss = leaves(tensors), leaves(shardings)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} tensors for {len(ss)} shardings")
    return sum(math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
               for t, s in zip(ts, ss))


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts,
    tuples, lists, NamedTuples)."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        items = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else type(a)(items)
    return fn(a, b)


def place_args(tree, shardings):
    """A tree of DTensors of ``tree``'s global shapes, placed by the
    matching ``shardings`` (their shards ``meta`` tensors)."""
    return _tree_map2(distribute, tree, shardings)


def place_outputs(tree, shardings):
    """Redistribute the DTensors of ``tree`` to the matching
    ``shardings`` (``None``: leave that subtree as the step placed it); a
    plain tensor is left alone."""
    if shardings is None:
        return tree

    def one(x, sh):
        if sh is None or not is_dtensor(x):
            return x
        return x.redistribute(x.device_mesh, to_placements(sh))

    return _tree_map2(one, tree, shardings)


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree of tensors: a DTensor's shard, a
    plain tensor whole (replicated)."""
    return sum((x.to_local() if is_dtensor(x) else x).nbytes for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def _replicated(tree, mesh):
    return _tree_map2(lambda x, _: NamedSharding(mesh, P()), tree, tree)


def step_parts(cfg: ModelConfig, shape: ShapeSpec, mesh, mode: str) -> dict:
    """The step of a cell on ``mesh`` with its abstract arguments, their
    shardings, the output shardings JAX's ``jit`` asks for, and the
    argument and donated (alias) bytes a device."""
    ctx = ShardingCtx(mesh=mesh, mode=mode)
    dtype = getattr(torch, cfg.dtype)
    pspecs = param_specs_for(cfg)
    p_abs = abstract_params(pspecs, dtype)
    p_shard = specs_to_shardings(pspecs, mesh, mode)
    b_abs = input_structs(cfg, shape)
    b_shard = batch_shardings(cfg, shape, mesh, mode)
    arg_bytes = sharded_bytes(p_abs, p_shard) + sharded_bytes(b_abs, b_shard)
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        o_abs = abstract_opt_state(p_abs, opt_cfg)
        # moments shard exactly like their parameter; step is replicated
        o_shard = type(o_abs)(step=NamedSharding(mesh, P()), mu=p_shard, nu=p_shard)
        alias = sharded_bytes(p_abs, p_shard) + sharded_bytes(o_abs, o_shard)
        return dict(step=make_train_step(cfg, opt_cfg, ctx), args=(p_abs, o_abs, b_abs),
                    shards=(p_shard, o_shard, b_shard), arg_bytes=arg_bytes + sharded_bytes(o_abs, o_shard), alias=alias,
                    grad_bytes=sharded_bytes(p_abs, p_shard), grad_leaves=len(leaves(p_abs)),
                    out_shards=lambda out: (p_shard, o_shard, _replicated(out[2], mesh)))
    if shape.kind == "prefill":
        return dict(step=make_prefill_step(cfg, ctx), args=(p_abs, b_abs),
                    shards=(p_shard, b_shard), arg_bytes=arg_bytes, alias=0,
                    out_shards=lambda out: None)
    sspecs = state_specs_for(cfg, shape.batch, shape.seq)
    s_abs = abstract_params(sspecs, dtype)
    s_shard = specs_to_shardings(sspecs, mesh, mode)
    alias = sharded_bytes(s_abs, s_shard)
    return dict(step=make_serve_step(cfg, ctx), args=(p_abs, s_abs, b_abs),
                shards=(p_shard, s_shard, b_shard), arg_bytes=arg_bytes + alias, alias=alias,
                out_shards=lambda out: (NamedSharding(mesh, P()), s_shard))


def trace_mesh(mesh, shape: ShapeSpec):
    """The mesh and shape a cell is traced on.  A mesh without a ``pod``
    axis as it is.  With one (``pod x data x model``), no DTensor mesh of
    three axes: a serve cell's ``pod`` and ``data`` only ever split the
    batch together, so they merge into one ``data`` axis of their product
    (the same shards and collectives); a train cell's ``pod`` is pure data
    parallelism (the rules place nothing else on it), so each pod runs the
    ``data x model`` step on its ``1 / pod`` of the batch, and the
    gradients' all-reduce over ``pod`` is added by hand
    (:func:`dryrun_cell`).  Returns ``(mesh, shape, pods)``."""
    if "pod" not in mesh.shape:
        return mesh, shape, 1
    pod, data, model = (mesh.shape[a] for a in ("pod", "data", "model"))
    kind = mesh.devices[0]
    if shape.kind != "train":
        return make_mesh_compat((pod * data, model), ("data", "model"),
                                devices=[kind] * mesh.size), shape, 1
    if shape.batch % pod:
        raise ValueError(f"a batch of {shape.batch} does not split over {pod} pods")
    return (make_mesh_compat((data, model), ("data", "model"), devices=[kind] * (data * model)),
            dataclasses.replace(shape, batch=shape.batch // pod), pod)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                verbose: bool = True, mesh=None) -> dict:
    """One cell's record (module docstring); ``mesh`` (default: the
    production mesh of ``meta`` entries) may be any mesh of ``meta`` or
    card entries over ``("data", "model")`` or ``("pod", "data",
    "model")``, ``arch`` a registry name or a ``ModelConfig`` and
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeSpec``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    name = arch if isinstance(arch, str) else arch.name
    mesh_name = "multi" if multi_pod else "single"
    meta = {"arch": name, "shape": shape.name, "mesh": mesh_name}
    if isinstance(arch, str):
        ok, reason = cell_supported(arch, shape.name)
        if not ok:
            return {**meta, "status": "skipped", "reason": reason}
    cfg = get_config(arch) if isinstance(arch, str) else arch
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta") if mesh is None else mesh
    chips = mesh.size
    mode = "train" if shape.kind == "train" else "serve"
    real = step_parts(cfg, shape, mesh, mode)
    tmesh, tshape, pods = trace_mesh(mesh, shape)
    run = real if tmesh is mesh else step_parts(cfg, tshape, tmesh, mode)

    def placed_step(*a):
        out = run["step"](*a)
        return place_outputs(out, run["out_shards"](out))

    t0 = time.time()
    glob = trace_cost(real["step"], *real["args"])
    del glob["out"]
    t_global = time.time() - t0
    t0 = time.time()
    with implicit_replication():
        traced = trace_cost(placed_step, *(place_args(a, sh)
                                           for a, sh in zip(run["args"], run["shards"])))
    t_trace = time.time() - t0
    out_bytes = local_bytes(traced.pop("out"))
    temp = max(traced["peak_live_bytes"] - out_bytes, 0)
    wire = traced["collective_wire_bytes_per_device"]
    counts = dict(traced["collective_counts"])
    if pods > 1:                # each gradient leaf's all-reduce over 'pod'
        wire += 2.0 * run["grad_bytes"] * (pods - 1) / pods
        counts["all-reduce"] = counts.get("all-reduce", 0) + run["grad_leaves"]

    cost = {
        "flops_per_device": traced["flops_per_device"],
        "bytes_per_device": traced["bytes_per_device"],
        "collective_wire_bytes_per_device": wire,
        "collective_counts": counts,
        "collective_wire_bytes_by_kind": traced["collective_wire_bytes_by_kind"],
        "num_ops": traced["num_ops"],
        "flops_global": glob["flops_per_device"],
        "bytes_global": glob["bytes_per_device"],
        "num_ops_global": glob["num_ops"],
        "dtensor_fallbacks": traced["dtensor_fallbacks"],
        "traced_mesh": dict(tmesh.shape),
        "pod_all_reduce_by_hand": pods > 1,
    }
    mf = model_flops_for(cfg, shape.kind, shape.batch, shape.seq,
                         shape.kind == "train")
    roof = make_roofline(cost, mf, chips)
    arg_bytes, alias = real["arg_bytes"], real["alias"]

    out = {
        **meta,
        "status": "ok",
        "chips": chips,
        "trace_s": round(t_trace, 2),
        "trace_global_s": round(t_global, 2),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": temp,
            "alias_bytes_per_device": alias,
            "peak_bytes_per_device": arg_bytes + out_bytes + temp - alias,
            "peak_live_bytes_per_device": traced["peak_live_bytes"],
            "largest_alloc_per_device": traced["largest_alloc"],
            "peak_live_bytes_global": glob["peak_live_bytes"],
        },
        "cost": cost,
        "roofline": roof.to_dict(),
    }
    if verbose:
        print(f"[{name} x {shape.name} x {mesh_name}] ok "
              f"trace {t_trace:.1f}s peak {out['memory']['peak_bytes_per_device'] / 2**30:.2f} "
              f"GiB/dev dominant={roof.dominant} "
              f"terms(c/m/n)=({roof.compute_s:.4f}/{roof.memory_s:.4f}/"
              f"{roof.collective_s:.4f})s "
              f"useful={roof.useful_flops_fraction:.2f}", flush=True)
    return out


def cut_layers(arch: str, layers: int) -> ModelConfig:
    """``arch``'s config at full width cut to ``layers`` layers (an
    enc-dec's encoder and decoder each)."""
    cfg = get_config(arch)
    repl = {"num_layers": layers}
    if cfg.family == "encdec":
        repl.update(enc_layers=layers, dec_layers=layers)
    return dataclasses.replace(cfg, **repl)


def summary_table(out_dir: str) -> str:
    """A markdown table of the cells in ``out_dir``, a row an arch and a
    column a shape: the dominant term (C compute, M memory, N collective)
    and bound ms, the useful-FLOPs fraction, the peak GiB a device and the
    collective ms, each ``single / multi`` mesh."""
    cells = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                c = json.load(f)
            cells[(c["arch"], c["shape"], c["mesh"])] = c

    def entry(arch, shape):
        pair = [cells.get((arch, shape, m)) for m in ("single", "multi")]
        if any(c is None for c in pair):
            return "-"
        if any(c["status"] != "ok" for c in pair):
            return " / ".join(c["status"] for c in pair)
        r = [c["roofline"] for c in pair]
        gib = [c["memory"]["peak_bytes_per_device"] / 2**30 for c in pair]
        dom = "/".join(dict.fromkeys({"compute": "C", "memory": "M", "collective": "N"}[x["dominant"]]
                                     for x in r))
        return (f"{dom} {r[0]['bound_s'] * 1e3:.4g} / {r[1]['bound_s'] * 1e3:.4g} ms; "
                f"u {r[0]['useful_flops_fraction']:.3f} / {r[1]['useful_flops_fraction']:.3f}; "
                f"{gib[0]:.2f} / {gib[1]:.2f} GiB; "
                f"n {r[0]['collective_s'] * 1e3:.4g} / {r[1]['collective_s'] * 1e3:.4g} ms")

    shapes = list(dict.fromkeys(s for _, s, _ in cells))
    rows = ["| arch | " + " | ".join(shapes) + " |", "| --- |" + " --- |" * len(shapes)]
    for arch in dict.fromkeys(a for a, _, _ in cells):
        rows.append(f"| {arch} | " + " | ".join(entry(arch, s) for s in shapes) + " |")
    status = [c["status"] for c in cells.values()]
    rows.append(f"\n{len(status)} cells: {status.count('ok')} ok, "
                f"{status.count('skipped')} skipped, {status.count('error')} errors")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape pairs, in place of --arch/--shape")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this many layers (an enc-dec's encoder and "
                         "decoder each)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the cells in --out and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(summary_table(args.out))
        raise SystemExit(0)

    archs = all_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    if args.cells:
        pairs = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        pairs = [(arch, shape) for arch in archs for shape in shapes]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in pairs:
        for mesh_name in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[{arch} x {shape} x {mesh_name}] cached", flush=True)
                continue
            cut = args.layers is not None and cell_supported(arch, shape)[0]
            try:
                res = dryrun_cell(cut_layers(arch, args.layers) if cut else arch, shape,
                                  mesh_name == "multi")
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()}
                print(f"[{arch} x {shape} x {mesh_name}] ERROR {e!r}",
                      flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    print(f"dry-run complete; {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
