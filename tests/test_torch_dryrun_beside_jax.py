"""The port's per-device dry-run beside the JAX dry-run's compiled
per-device program, recorded, not equated: reduced SmolLM-360M and
Mamba2-370M (2 layers, ``reduce_config(..., 8)``), a train step and a
prefill of ``[8, 256]``, over an 8-entry ``(data 2, model 4)`` mesh.  The
port traces DTensors on ``meta`` shards (``launch.dryrun.dryrun_cell``);
JAX compiles with the same rules on 8 forced CPU devices (in a subprocess)
and ``repro.analysis.hlo.analyze_compiled_text`` reads the program.  XLA's
partitioner picks other collectives and fuses, so only their presence is
asserted; run with ``-s`` to print the table PERF.md records.  At full
width (2 layers, ``[2, 2048]``) the FLOPs are held to JAX's: SmolLM-360M's
prefill and the train cells of SmolLM-360M, StableLM-3B, Mamba2-370M and
Qwen1.5-MoE.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, k) for a in ("smollm-360m", "mamba2-370m") for k in ("train", "prefill")]
MESH = (2, 4)

JAX_CELLS = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.analysis.hlo import analyze_compiled_text
    from repro.configs import get_config
    from repro.launch.shapes import ShapeSpec, batch_axes, input_structs
    from repro.launch.steps import (make_prefill_step, make_train_step, param_specs_for)
    from repro.launch.train import reduce_config
    from repro.models.common import abstract_params, specs_to_shardings
    from repro.optim.adamw import AdamWConfig, abstract_opt_state
    from repro.parallel.sharding import ShardingCtx, logical_to_spec, make_mesh_compat

    mesh = make_mesh_compat(MESH, ("data", "model"), devices=jax.devices()[:8])
    out = {}
    for arch, kind in CELLS:
        cfg = dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=2)
        shape = ShapeSpec(kind, kind, 256, 8)
        mode = "train" if kind == "train" else "serve"
        ctx = ShardingCtx(mesh=mesh, mode=mode)
        pspecs = param_specs_for(cfg)
        p_abs = abstract_params(pspecs, jnp.dtype(cfg.dtype))
        p_shard = specs_to_shardings(pspecs, mesh, mode)
        b_abs = input_structs(cfg, shape)
        axes = batch_axes(cfg, shape)
        b_shard = {k: NamedSharding(mesh, logical_to_spec(axes[k], v.shape, mesh, mode))
                   for k, v in b_abs.items()}
        if kind == "train":
            opt = AdamWConfig()
            o_abs = abstract_opt_state(p_abs, opt)
            o_shard = type(o_abs)(step=NamedSharding(mesh, P()), mu=p_shard, nu=p_shard)
            fn = jax.jit(make_train_step(cfg, opt, ctx), in_shardings=(p_shard, o_shard, b_shard),
                         out_shardings=(p_shard, o_shard, None), donate_argnums=(0, 1))
            lowered = fn.lower(p_abs, o_abs, b_abs)
        else:
            fn = jax.jit(make_prefill_step(cfg, ctx), in_shardings=(p_shard, b_shard))
            lowered = fn.lower(p_abs, b_abs)
        parsed = analyze_compiled_text(lowered.compile().as_text(), 8)
        out[f"{arch} {kind}"] = {k: parsed[k] for k in (
            "flops_per_device", "bytes_per_device", "collective_wire_bytes_per_device",
            "collective_counts")}
    print("JSON" + json.dumps(out))
""").replace("MESH", repr(MESH)).replace("CELLS", repr(CELLS))


@pytest.fixture(scope="module")
def jax_cells():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_CELLS], capture_output=True, text=True,
                         timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


def test_per_device_counts_beside_jax(jax_cells):
    rows = []
    try:
        for arch, kind in CELLS:
            cfg = dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=2)
            out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec(kind, kind, 256, 8), False,
                                     verbose=False,
                                     mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
            c, j = out["cost"], jax_cells[f"{arch} {kind}"]
            assert c["flops_per_device"] > 0 and j["flops_per_device"] > 0
            assert c["collective_counts"] and j["collective_counts"]
            rows.append(f"| {arch} {kind} | {c['flops_per_device']:.6g} | "
                        f"{j['flops_per_device']:.6g} | "
                        f"{c['flops_per_device'] / j['flops_per_device']:.3f} | "
                        f"{c['collective_counts']} | {j['collective_counts']} | "
                        f"{c['collective_wire_bytes_per_device']:.6g} | "
                        f"{j['collective_wire_bytes_per_device']:.6g} |")
    finally:
        sharding.close_fake_world()
    print("\n| cell | port FLOPs/dev | JAX FLOPs/dev | port / JAX | port collectives | "
          "JAX collectives | port wire B | JAX wire B |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    print("\n".join(rows))


#: the probe's cells: SmolLM-360M at full width, 2 layers, ``[2, 2048]``,
#: on the same mesh; its 5 kv heads do not split over ``model`` 4, so the
#: attention splits its query rows there (``models.attention``); and the
#: full-width train cells of StableLM-3B, Mamba2-370M and Qwen1.5-MoE
FULL_CELLS = ([("smollm-360m", k) for k in ("prefill", "train")]
              + [(a, "train") for a in ("stablelm-3b", "mamba2-370m", "qwen2-moe-a2.7b")])
FULL_B, FULL_S = 2, 2048
#: the prefill's port / JAX per-device FLOPs (1.821 before the row split)
FULL_PREFILL_RATIO = (0.93, 1.00)
#: a full-width train cell's port / JAX per-device FLOPs (SmolLM 1.654,
#: StableLM 2.533, Mamba2 1.844, Qwen1.5-MoE 2.134 while DTensor placed
#: each backward product itself)
FULL_TRAIN_RATIO = (0.90, 1.10)

JAX_FULL_CELLS = (JAX_CELLS.replace("reduce_config(get_config(arch), 8)", "get_config(arch)")
                  .replace("ShapeSpec(kind, kind, 256, 8)",
                           f"ShapeSpec(kind, kind, {FULL_S}, {FULL_B})")
                  .replace(repr(CELLS), repr(FULL_CELLS)))


@pytest.fixture(scope="module")
def jax_full_cells():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_FULL_CELLS], capture_output=True,
                         text=True, timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


def test_full_width_smollm_beside_jax(jax_full_cells):
    """The probe's prefill: port / JAX per-device FLOPs in
    ``FULL_PREFILL_RATIO``.  Per device (batch 1 of 2, the rows of a
    512-row shard), both count the MLP and the q/k/v/o projections on row
    shards alike (2.015625216e10); the flash call is the rest.  The port
    charges the last shard's causal pairs, ``512 x 513 / 2 + 512 x 1536 =
    917,760`` a (head, layer) at ``2 (64 + 64)`` FLOPs each (7.0483968e9
    over 15 heads and 2 layers); JAX's CPU HLO charges its scan's full
    block, ``512 x 2048`` pairs (8.05306368e9): the difference is the
    block's masked pairs exactly (C.4's causal-pairs divergence), 0.964.
    The train cell's ratio is in ``FULL_TRAIN_RATIO``; run with ``-s`` to
    print both rows."""
    from repro_torch.kernels.ops import causal_pairs

    rows = []
    try:
        for arch, kind in FULL_CELLS[:2]:
            cfg = dataclasses.replace(get_config(arch), num_layers=2)
            out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec(kind, kind, FULL_S, FULL_B), False,
                                     verbose=False,
                                     mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
            c, j = out["cost"], jax_full_cells[f"{arch} {kind}"]
            ratio = c["flops_per_device"] / j["flops_per_device"]
            if kind == "prefill":
                lo, hi = FULL_PREFILL_RATIO
                assert lo <= ratio <= hi, ratio
                m = FULL_S // MESH[1]
                masked = m * FULL_S - causal_pairs(m, FULL_S, True)
                assert j["flops_per_device"] - c["flops_per_device"] == \
                    cfg.num_layers * cfg.n_heads * 2 * (2 * cfg.head_dim) * masked
            else:
                lo, hi = FULL_TRAIN_RATIO
                assert lo <= ratio <= hi, ratio
            rows.append(f"| {arch} {kind} full [{FULL_B}, {FULL_S}] | "
                        f"{c['flops_per_device']:.6g} | {j['flops_per_device']:.6g} | "
                        f"{ratio:.3f} | {c['collective_counts']} | {j['collective_counts']} | "
                        f"{c['collective_wire_bytes_per_device']:.6g} | "
                        f"{j['collective_wire_bytes_per_device']:.6g} |")
    finally:
        sharding.close_fake_world()
    print("\n" + "\n".join(rows))


@pytest.mark.parametrize("arch", [a for a, _ in FULL_CELLS[2:]])
def test_full_width_train_beside_jax(jax_full_cells, arch):
    """A full-width train cell (2 layers, ``[2, 2048]``): port / JAX
    per-device FLOPs in ``FULL_TRAIN_RATIO``, each weight product's
    backward on the device's own tokens and split (``sharding.matmul``);
    run with ``-s`` to print the row."""
    try:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec("train", "train", FULL_S, FULL_B), False,
                                 verbose=False,
                                 mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
    finally:
        sharding.close_fake_world()
    c, j = out["cost"], jax_full_cells[f"{arch} train"]
    ratio = c["flops_per_device"] / j["flops_per_device"]
    lo, hi = FULL_TRAIN_RATIO
    assert lo <= ratio <= hi, ratio
    print(f"\n| {arch} train full [{FULL_B}, {FULL_S}] | {c['flops_per_device']:.6g} | "
          f"{j['flops_per_device']:.6g} | {ratio:.3f} | {c['collective_counts']} | "
          f"{j['collective_counts']} | {c['collective_wire_bytes_per_device']:.6g} | "
          f"{j['collective_wire_bytes_per_device']:.6g} |")


#: reduced Mamba2-370M's train cell at its vocabulary (6285, which 4 does
#: not divide) and at 6288 (which it does)
VOCAB_CELLS = (6285, 6288)

JAX_VOCAB_CELLS = (JAX_CELLS.replace(f"for arch, kind in {CELLS!r}:",
                                     f"for vocab in {VOCAB_CELLS!r}:\n"
                                     "    arch, kind = 'mamba2-370m', 'train'")
                   .replace("num_layers=2)", "num_layers=2, vocab=vocab)")
                   .replace('out[f"{arch} {kind}"]', 'out[f"{vocab} {kind}"]'))


@pytest.fixture(scope="module")
def jax_vocab_cells():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_VOCAB_CELLS], capture_output=True,
                         text=True, timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


def test_ce_rows_split_where_model_does_not_divide_the_vocabulary(jax_vocab_cells):
    """Reduced Mamba2-370M's train cell: at a vocabulary ``model`` (4)
    divides (6288) the port's per-device count is JAX's within 5 %; at its
    own (6285) the port splits the CE's rows over ``model`` and counts the
    same as at 6288 within 0.1 %, where XLA keeps most of the CE
    replicated (JAX's count recorded beside it; run with ``-s``)."""
    port = {}
    try:
        for vocab in VOCAB_CELLS:
            cfg = dataclasses.replace(reduce_config(get_config("mamba2-370m"), 8),
                                      num_layers=2, vocab=vocab)
            out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec("train", "train", 256, 8), False,
                                     verbose=False,
                                     mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
            port[vocab] = out["cost"]["flops_per_device"]
    finally:
        sharding.close_fake_world()
    jax = {v: jax_vocab_cells[f"{v} train"]["flops_per_device"] for v in VOCAB_CELLS}
    assert abs(port[6288] / jax[6288] - 1) <= 0.05, (port, jax)
    assert abs(port[6285] / port[6288] - 1) <= 1e-3, port
    print("\n" + "\n".join(f"| mamba2-370m train, vocabulary {v} | {port[v]:.6g} | {jax[v]:.6g} | "
                           f"{port[v] / jax[v]:.3f} |" for v in VOCAB_CELLS))


#: reduced SmolLM-360M's decode step, ``[8]`` tokens against a 1024-token
#: cache on the same mesh: the serve rules split the cache's sequence over
#: ``model``, and each device keeps its block (the decode softmax's max
#: and sum all-reduced as rows, ``sharding.softmax_last``)
DECODE_CELLS = [("smollm-360m", "decode")]
DECODE_S = 1024
#: the port's wire bytes a device over JAX's (35.7x at full width while
#: DTensor gathered the softmax's logits)
DECODE_WIRE_RATIO = 2.0

JAX_DECODE_CELLS = (
    JAX_CELLS.replace("make_prefill_step, make_train_step, param_specs_for",
                      "make_prefill_step, make_serve_step, make_train_step, "
                      "param_specs_for, state_specs_for")
    .replace("    else:\n        fn = jax.jit(make_prefill_step",
             "    elif kind == 'decode':\n"
             "        sspecs = state_specs_for(cfg, shape.batch, shape.seq)\n"
             "        s_abs = abstract_params(sspecs, jnp.dtype(cfg.dtype))\n"
             "        s_shard = specs_to_shardings(sspecs, mesh, mode)\n"
             "        fn = jax.jit(make_serve_step(cfg, ctx), in_shardings=(p_shard, s_shard, b_shard),\n"
             "                     out_shardings=(None, s_shard), donate_argnums=(1,))\n"
             "        lowered = fn.lower(p_abs, s_abs, b_abs)\n"
             "    else:\n        fn = jax.jit(make_prefill_step")
    .replace("ShapeSpec(kind, kind, 256, 8)", f"ShapeSpec(kind, kind, {DECODE_S}, 8)")
    .replace(repr(CELLS), repr(DECODE_CELLS)))


@pytest.fixture(scope="module")
def jax_decode_cells():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_DECODE_CELLS], capture_output=True,
                         text=True, timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


def test_reduced_decode_beside_jax(jax_decode_cells):
    """Reduced SmolLM-360M's decode step on the ``(data 2, model 4)`` mesh:
    the port's wire bytes a device at most ``DECODE_WIRE_RATIO`` times
    JAX's, and no op falls back; run with ``-s`` to print the row."""
    arch, kind = DECODE_CELLS[0]
    try:
        cfg = dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=2)
        out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec(kind, kind, DECODE_S, 8), False,
                                 verbose=False,
                                 mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
    finally:
        sharding.close_fake_world()
    c, j = out["cost"], jax_decode_cells[f"{arch} {kind}"]
    assert c["dtensor_fallbacks"] == {}
    ratio = c["collective_wire_bytes_per_device"] / j["collective_wire_bytes_per_device"]
    assert ratio <= DECODE_WIRE_RATIO, (c["collective_wire_bytes_per_device"],
                                        j["collective_wire_bytes_per_device"])
    print(f"\n| {arch} decode, reduced, `[8]` x {DECODE_S} | {c['flops_per_device']:.6g} | "
          f"{j['flops_per_device']:.6g} | {c['flops_per_device'] / j['flops_per_device']:.3f} | "
          f"{c['collective_counts']} | {j['collective_counts']} | "
          f"{c['collective_wire_bytes_per_device']:.6g} | "
          f"{j['collective_wire_bytes_per_device']:.6g} | {ratio:.3f} |")
