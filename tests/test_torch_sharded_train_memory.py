"""Per-device memory of the sharded train step beside JAX's: the
production 16x16 mesh of ``meta`` entries, ``train_4k`` (``[256, 4096]``),
full width cut to 2 layers (an enc-dec's encoder and decoder each), for
SmolLM-360M and Command R+ (the CE's logits split on their vocabulary over
``model``) and Mamba2-370M, MiniCPM3-4B and Seamless-M4T-medium (their
rows, where ``model`` 16 does not divide the vocabulary).

The port's temp bytes a device (``launch.dryrun.dryrun_cell``) are at most
JAX's ``memory_analysis()`` temp for the same cell (compiled on 256
forced CPU devices in a subprocess), and no storage a device allocates
that holds the vocabulary, or a device's split of it (a CE chunk's logits
and their gradient, the unembedding's products), exceeds twice the
device's f32 shard of one chunk's logits.  While DTensor placed the CE's
backward itself it built that gradient at the global batch's rows or over
the whole vocabulary on every device: 4.92-280 GiB of temp against JAX's
2.32-129.  A cell traces in 5-10 s, and JAX compiles it in ~7 s.

The meta count also charges a ``shard_dim_alltoall`` its own output, as a
card's op allocates it: the op's meta kernel returns a slice of a buffer
of the group's size (MiniCPM3's embedding rows placed on the batch read
5120 MiB for a 320 MiB output)."""

import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cost  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402
from repro_torch.models.lm import LOSS_CHUNK  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import P, NamedSharding  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("smollm-360m", "command-r-plus-104b", "mamba2-370m", "minicpm3-4b",
         "seamless-m4t-medium")
LAYERS = 2
DATA, MODEL = 16, 16
SHAPE = SHAPES["train_4k"]


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
    for arch in ARCHS:
        cfg = get_config(arch)
        repl = {"num_layers": LAYERS}
        if cfg.family == "encdec":
            repl.update(enc_layers=LAYERS, dec_layers=LAYERS)
        cfg = dataclasses.replace(cfg, **repl)
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
        fn = jax.jit(make_train_step(cfg, opt, ctx), in_shardings=(p_shard, o_shard, b_shard),
                     out_shardings=(p_shard, o_shard, None), donate_argnums=(0, 1))
        out[arch] = fn.lower(p_abs, o_abs, b_abs).compile().memory_analysis().temp_size_in_bytes
    print("JSON" + json.dumps(out))
""").replace("ARCHS", repr(ARCHS)).replace("LAYERS", repr(LAYERS))


@pytest.fixture(scope="module")
def jax_temp():
    """JAX's per-device temp bytes of each cell."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_TEMP], capture_output=True, text=True,
                         timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert lines, run.stdout + run.stderr
    return json.loads(lines[-1][4:])


@functools.lru_cache(maxsize=None)
def traced(arch: str) -> tuple[dict, list]:
    """The cell's dry-run record and every storage of 1 MiB or more the
    sharded trace allocated, ``(bytes, op, shape)``."""
    seen = []
    real = cost._CostMode._track

    def track(self, outs, *op):
        if self.sharded:
            seen.extend((t.untyped_storage().nbytes(), *op, tuple(t.shape)) for t in outs
                        if t.untyped_storage().nbytes() >= 2**20)
        return real(self, outs, *op)

    try:
        with mock.patch.object(cost._CostMode, "_track", track):
            out = dryrun.dryrun_cell(dryrun.cut_layers(arch, LAYERS), SHAPE, False,
                                     verbose=False)
    finally:
        sharding.close_fake_world()
    return out, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_train_temp_per_device_at_most_jax(arch, jax_temp):
    out, _ = traced(arch)
    temp = out["memory"]["temp_bytes_per_device"]
    print(f"\n| {arch} | port temp {temp / 2**30:.3f} GiB | JAX temp "
          f"{jax_temp[arch] / 2**30:.3f} GiB | port peak "
          f"{out['memory']['peak_bytes_per_device'] / 2**30:.3f} GiB | largest "
          f"{out['memory']['largest_alloc_per_device']} |")
    assert out["cost"]["dtensor_fallbacks"] == {}
    assert 0 < temp <= jax_temp[arch], (temp / 2**30, jax_temp[arch] / 2**30)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_ce_storage_beyond_twice_its_f32_shard(arch):
    """Every storage holding the vocabulary (whole, where the rows split,
    or a device's split of it) is at most twice the device's f32 shard of
    one chunk's logits, ``[B / data, chunk, V]`` split over ``model``; the
    record's largest allocation is the largest storage seen."""
    out, seen = traced(arch)
    vocab = get_config(arch).vocab
    shard = 4 * (SHAPE.batch // DATA) * LOSS_CHUNK * vocab / MODEL
    dims = {vocab} | ({vocab // MODEL} if vocab % MODEL == 0 else set())
    held = [r for r in seen if dims & set(r[-1])]
    assert held, arch
    over = [r for r in held if r[0] > 2 * shard]
    assert not over, (shard, sorted(over, reverse=True)[:4])
    largest = out["memory"]["largest_alloc_per_device"]
    assert largest["bytes"] == max(r[0] for r in seen), largest
    assert largest["bytes"] <= out["memory"]["peak_live_bytes_per_device"]
    assert set(largest) == {"bytes", "op", "shape"}


def test_meta_alltoall_charges_its_own_output():
    """A redistribute from a split of the columns to one of the rows over
    an axis of 16 (an all-to-all; MiniCPM3's embedding rows) is charged
    its output's bytes on ``meta``, not the 16 times larger buffer its
    meta kernel slices the output from."""
    mesh = sharding.abstract_mesh_compat((16,), ("data",))
    try:
        x = sharding.distribute(torch.empty((64, 256, 320), dtype=torch.bfloat16,  # tracecheck: disable=TC005 — bf16 LM embedding rows
                                            device="meta"),
                                NamedSharding(mesh, P(None, None, "data")))
        from torch.distributed.tensor import Shard

        got = cost.trace_cost(lambda: x.redistribute(x.device_mesh, [Shard(0)]))
    finally:
        sharding.close_fake_world()
    local = got["out"].to_local()
    assert tuple(local.shape) == (4, 256, 320)
    assert got["collective_counts"] == {"all-to-all": 1}
    assert got["largest_alloc"] == {"bytes": local.nbytes, "op": "shard_dim_alltoall",
                                    "shape": [4, 256, 320]}
    assert got["peak_live_bytes"] == local.nbytes
