"""What the train step's checkpoint keeps a layer, a device, beside JAX's.
The production 16x16 mesh of ``meta`` entries, ``train_4k``, full width at
two depths: SmolLM-360M under ``remat="dots"`` and ``"full"`` at 2 and 8
layers, Command R+ under ``"dots"`` at 2 and 4.  A layer's share is the
temp bytes a device (``launch.dryrun.dryrun_cell``; JAX's
``memory_analysis()`` on 256 forced CPU devices, in a subprocess) at the
deeper cut less the shallower, over the layers between.  Each region keeps
its residuals split over ``model`` on the sequence
(``parallel.sharding.checkpoint``, ROADMAP C.13), so the port keeps at most
``PER_LAYER_RATIO`` times JAX's share in every cell.  Run with ``-s`` to
print the table ROADMAP C.13 records.  The full checkpoint keeps less a
layer than the selective one on both sides."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
#: (arch, remat, shallow and deep layer counts)
CELLS = [("smollm-360m", "dots", (2, 8)), ("smollm-360m", "full", (2, 8)),
         ("command-r-plus-104b", "dots", (2, 4))]
#: the port's bytes a layer over JAX's, at most
PER_LAYER_RATIO = 1.10

JAX_TEMP = textwrap.dedent("""
    import dataclasses, json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.shapes import SHAPES, batch_axes, input_structs
    from repro.launch.steps import make_train_step, param_specs_for
    from repro.models.common import abstract_params, specs_to_shardings
    from repro.optim.adamw import AdamWConfig, abstract_opt_state
    from repro.parallel.sharding import ShardingCtx, logical_to_spec, make_mesh_compat

    mesh = make_mesh_compat((16, 16), ("data", "model"), devices=jax.devices()[:256])
    ctx = ShardingCtx(mesh=mesh, mode="train")
    shape = SHAPES["train_4k"]
    out = {}
    for arch, remat, depths in CELLS:
        for layers in depths:
            cfg = dataclasses.replace(get_config(arch), num_layers=layers, remat=remat)
            pspecs = param_specs_for(cfg)
            p_abs = abstract_params(pspecs, jnp.dtype(cfg.dtype))
            p_shard = specs_to_shardings(pspecs, mesh, "train")
            b_abs = input_structs(cfg, shape)
            axes = batch_axes(cfg, shape)
            b_shard = {k: NamedSharding(mesh, logical_to_spec(axes[k], v.shape, mesh, "train"))
                       for k, v in b_abs.items()}
            opt = AdamWConfig()
            o_abs = abstract_opt_state(p_abs, opt)
            o_shard = type(o_abs)(step=NamedSharding(mesh, P()), mu=p_shard, nu=p_shard)
            fn = jax.jit(make_train_step(cfg, opt, ctx),
                         in_shardings=(p_shard, o_shard, b_shard),
                         out_shardings=(p_shard, o_shard, None), donate_argnums=(0, 1))
            mem = fn.lower(p_abs, o_abs, b_abs).compile().memory_analysis()
            out[f"{arch} {remat} {layers}"] = mem.temp_size_in_bytes
    print("JSON" + json.dumps(out))
""").replace("CELLS", repr(CELLS))


@pytest.fixture(scope="module")
def jax_temp():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_TEMP], capture_output=True, text=True,
                         timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


def port_temp(arch: str, remat: str, layers: int) -> int:
    import dataclasses

    cfg = dataclasses.replace(dryrun.cut_layers(arch, layers), remat=remat)
    try:
        out = dryrun.dryrun_cell(cfg, "train_4k", False, verbose=False)
    finally:
        sharding.close_fake_world()
    return out["memory"]["temp_bytes_per_device"]


def test_checkpoint_per_layer_beside_jax(jax_temp):
    rows, per = [], {}
    for arch, remat, (lo, hi) in CELLS:
        port = [port_temp(arch, remat, n) for n in (lo, hi)]
        jax_ = [jax_temp[f"{arch} {remat} {n}"] for n in (lo, hi)]
        p, j = ((t[1] - t[0]) / (hi - lo) / 2**30 for t in (port, jax_))
        assert p > 0 and j > 0, (arch, remat, port, jax_)
        per[(arch, remat)] = (p, j)
        rows.append(f"| {arch} `{remat}` ({lo} -> {hi} layers) | {p:.3f} | {j:.3f} | "
                    f"{p / j:.2f} |")
    print("\n| cell | port GiB a layer | JAX GiB a layer | port / JAX |\n"
          "| --- | --- | --- | --- |\n" + "\n".join(rows))
    for side in (0, 1):
        assert per[("smollm-360m", "full")][side] < per[("smollm-360m", "dots")][side]
    for cell, (p, j) in per.items():
        assert p <= PER_LAYER_RATIO * j, (cell, p, j)
