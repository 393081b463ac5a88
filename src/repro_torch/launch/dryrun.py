"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``
tensors (port of ``repro.launch.dryrun``).

For each cell: the production mesh of ``meta`` entries
(``make_production_mesh(device="meta")``), abstract params, AdamW moments,
decode state and batch (``meta`` tensors: nothing allocated), the step
factory under a ``ShardingCtx`` of that mesh, then one run of the step at
its global shape under ``analysis.cost.trace_cost``, which records the
FLOPs, bytes, ops and live bytes, and the H100 roofline over them.

There is no SPMD partitioner in eager PyTorch, so what the JAX dry-run
reads from the compiled per-device program is not claimed here: per-device
temp bytes and collective traffic are ``None``.  The per-device argument
bytes are exact (each leaf's ``NamedSharding.shard_shape`` under the
cell's rules, as JAX's ``in_shardings`` place them); ``cost`` is the
global count over ``chips``, the evenly split figure.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the cells written
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

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
from repro_torch.parallel.sharding import P, NamedSharding, ShardingCtx, logical_to_spec


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


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(arch, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        return {**meta, "status": "skipped", "reason": reason}

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = mesh.size
    mode = "train" if shape.kind == "train" else "serve"
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
        arg_bytes += sharded_bytes(o_abs, o_shard)
        step, args = make_train_step(cfg, opt_cfg, ctx), (p_abs, o_abs, b_abs)
    elif shape.kind == "prefill":
        step, args = make_prefill_step(cfg, ctx), (p_abs, b_abs)
    else:
        sspecs = state_specs_for(cfg, shape.batch, shape.seq)
        s_abs = abstract_params(sspecs, dtype)
        arg_bytes += sharded_bytes(s_abs, specs_to_shardings(sspecs, mesh, mode))
        step, args = make_serve_step(cfg, ctx), (p_abs, s_abs, b_abs)

    t0 = time.time()
    traced = trace_cost(step, *args)
    t_trace = time.time() - t0

    cost = {
        "flops_per_device": traced["flops_per_device"] / chips,
        "bytes_per_device": traced["bytes_per_device"] / chips,
        "collective_wire_bytes_per_device": None,
        "collective_counts": traced["collective_counts"],
        "flops_global": traced["flops_per_device"],
        "bytes_global": traced["bytes_per_device"],
        "num_ops": traced["num_ops"],
    }
    mf = model_flops_for(cfg, shape.kind, shape.batch, shape.seq,
                         shape.kind == "train")
    roof = make_roofline(cost, mf, chips)

    out = {
        **meta,
        "status": "ok",
        "chips": chips,
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "peak_live_bytes_global": traced["peak_live_bytes"],
            "temp_bytes_per_device": None,
        },
        "cost": cost,
        "roofline": roof.to_dict(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] ok "
              f"trace {t_trace:.1f}s args {arg_bytes / 2**30:.2f} GiB/dev "
              f"dominant={roof.dominant} "
              f"terms(c/m)=({roof.compute_s:.4f}/{roof.memory_s:.4f})s "
              f"useful={roof.useful_flops_fraction:.2f}", flush=True)
    return out


def summary_table(out_dir: str) -> str:
    """A markdown table of the cells in ``out_dir``, a row an arch and a
    column a shape: the dominant term (C compute, M memory) and bound ms,
    the useful-FLOPs fraction and the argument GiB a device, each ``single
    / multi`` mesh; the collective term is not modelled."""
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
        gib = [c["memory"]["argument_bytes_per_device"] / 2**30 for c in pair]
        dom = "/".join(dict.fromkeys(x["dominant"][0].upper() for x in r))
        return (f"{dom} {r[0]['bound_s'] * 1e3:.4g} / {r[1]['bound_s'] * 1e3:.4g} ms; "
                f"u {r[0]['useful_flops_fraction']:.3f} / {r[1]['useful_flops_fraction']:.3f}; "
                f"{gib[0]:.2f} / {gib[1]:.2f} GiB")

    shapes = list(dict.fromkeys(s for _, s, _ in cells))
    rows = ["| arch | " + " | ".join(shapes) + " |", "| --- |" + " --- |" * len(shapes)]
    for arch in dict.fromkeys(a for a, _, _ in cells):
        rows.append(f"| {arch} | " + " | ".join(entry(arch, s) for s in shapes) + " |")
    status = [c["status"] for c in cells.values()]
    rows.append(f"\n{len(status)} cells: {status.count('ok')} ok, "
                f"{status.count('skipped')} skipped, {status.count('error')} errors; "
                "collective term not modelled (None) in every cell")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
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

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[{arch} x {shape} x {mesh_name}] cached", flush=True)
                    continue
                try:
                    res = dryrun_cell(arch, shape, mesh_name == "multi")
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
