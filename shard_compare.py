#!/usr/bin/env python3
"""One device's shard step on the card, for checkouts of the port, in
turns: the ms of ``chip_smoke.py`` phase 17 (e)'s card-shard steps.

Run from the repository root with the roots of the checkouts to compare,
for example a parent commit unpacked into a directory that ``.gitignore``
lists (``git archive``) and this tree, in the order parent, this, this,
parent:

    python3 shard_compare.py build/parent . . build/parent

Each argument runs in a process of its own, with that checkout's ``src/``
first on the path and its own kernel build: each arch of ``ARCHS`` at full
width cut to 2 layers, a train step on ``[8, 256]`` and a prefill of
``[4, 2048]`` in bf16, through that checkout's ``launch.dryrun.step_parts``
over a ``(data 2, model 2)`` mesh of ``cuda:0`` entries: the arguments
DTensors of zeros on ``cuda:0`` shards in one ``fake`` process group, so
the card runs one device's shard of every product and no collective moves
a byte.  A warm-up call, then the median wall ms of ``--runs`` calls, each
synchronized (``chip_smoke.shard_step_ms``); a step with an op the
checkout's torch cannot place on DTensors is not timed (torch 2.11 has no
``flip`` for Mamba2's train step).  One JSON line per checkout;
a table across the runs, under the card's name and power limit, ends the
output.  The script needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = ("smollm-360m", "mamba2-370m", "stablelm-3b")
CELLS = (("train", 8, 256), ("prefill", 4, 2048))


def one(root: pathlib.Path, runs: int) -> dict:
    """The shard steps through ``root``'s port."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke as cs

    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, shapes
    from repro_torch.parallel import sharding

    _build.build(("flash_attention", "ssd_chunk"))
    axes, grid = ("data", "model"), (2, 2)
    mesh = sharding.make_mesh_compat(grid, axes, devices=["cuda:0"] * (grid[0] * grid[1]))
    out: dict = {"root": str(root)}
    try:
        for arch in ARCHS:
            cfg = cs.lm_config(arch, num_layers=2)
            for kind, b, s in CELLS:
                mode = "train" if kind == "train" else "serve"
                parts = dryrun.step_parts(cfg, shapes.ShapeSpec(kind, kind, s, b), mesh, mode)
                args = [dryrun.place_args(a, sh) for a, sh in zip(parts["args"], parts["shards"])]

                def step(*a, parts=parts):
                    res = parts["step"](*a)
                    return dryrun.place_outputs(res, parts["out_shards"](res))

                try:
                    cs.shard_step_ms(torch, step, args, 1)
                    out[f"{arch} {kind}"] = cs.shard_step_ms(torch, step, args, runs)
                except NotImplementedError as e:    # an op this torch's DTensor cannot place
                    out[f"{arch} {kind}"] = None
                    out.setdefault("not timed", {})[f"{arch} {kind}"] = str(e)[:200]
                del args
                torch.cuda.empty_cache()
    finally:
        sharding.close_fake_world()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--runs", type=int, default=5, help="timed calls a step and root")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("shard_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(pathlib.Path(args.roots[0]).resolve(), args.runs)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows, failed = [], 0
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", "--runs", str(args.runs), root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"shard_compare: {root} failed ({proc.returncode}): {proc.stderr[-3000:]}")
            continue
        print(lines[-1], flush=True)
        rows.append(json.loads(lines[-1]))
    print(f"\ncard: {card}")
    keys = [f"{a} {k}" for a in ARCHS for k, _, _ in CELLS]
    print("| shard step ms (median of %d) | " % args.runs
          + " | ".join(r["root"] for r in rows) + " |")
    print("| --- |" + " --- |" * len(rows))
    for k in keys:
        print(f"| {k} | " + " | ".join("not timed" if r[k] is None else f"{r[k]:.2f}"
                                       for r in rows) + " |")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
