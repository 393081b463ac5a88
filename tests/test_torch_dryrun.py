"""The port's meta passes against the JAX package: abstract parameters,
optimizer state and caches; the op-by-op cost count (``analysis/cost.py``,
the counterpart of ``analysis/hlo.py``) on a known program and on reduced
models, ``meta`` against the CPU; the H100 roofline's model FLOPs; and one
dry-run cell's per-device argument bytes against a sum over JAX's
partition specs.
"""

import dataclasses
import math
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jax_roofline  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.analysis import cost, roofline  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.launch import dryrun, shapes, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.common import abstract_params, axes_tree, spec_leaves  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _name(dt) -> str:
    return str(dt).split(".")[1] if isinstance(dt, torch.dtype) else str(jnp.dtype(dt))


def _jax_flat(tree):
    """(shape, dtype name) of a JAX tree's leaves in ``jax.tree`` order."""
    import jax
    return [(tuple(x.shape), _name(x.dtype)) for x in jax.tree.leaves(tree)]


def _flat(tree):
    return [(tuple(x.shape), _name(x.dtype)) for x in leaves(tree)]


@pytest.mark.parametrize("arch", all_archs())
def test_abstract_params_opt_state_and_caches_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    dt = getattr(torch, cfg.dtype)
    jp = jax_common.abstract_params(jax_steps.param_specs_for(jcfg), jnp.dtype(jcfg.dtype))
    specs = steps.param_specs_for(cfg)
    p = abstract_params(specs, dt)
    assert all(x.device.type == "meta" for x in leaves(p))
    assert _flat(p) == _jax_flat(jp)
    assert [a for _, a in sorted((k, s.axes) for k, s in spec_leaves(specs))] == \
        [a for _, a in sorted((k, a) for k, a in _axes_items(axes_tree(specs)))]
    jo = jax_adamw.abstract_opt_state(jp, jax_adamw.AdamWConfig())
    o = abstract_opt_state(p, AdamWConfig())
    assert _flat(o) == _jax_flat(jo)
    assert o.step.dtype == torch.int32 and o.step.shape == () and o.step.device.type == "meta"
    js = jax_common.abstract_params(jax_steps.state_specs_for(jcfg, 8, 128), jnp.dtype(jcfg.dtype))
    assert _flat(abstract_params(steps.state_specs_for(cfg, 8, 128), dt)) == _jax_flat(js)
    if cfg.family == "encdec":
        return
    for layers in (None, 3):
        jc = jax_blocks.init_attn_cache(jcfg, 2, 16, jnp.dtype(jcfg.dtype), layers=layers)
        c = blocks.init_attn_cache(cfg, 2, 16, dt, layers=layers, device="meta")
        assert _flat(c) == _jax_flat(jc)
    c = blocks.init_attn_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert not c["k"].any() and not c["v"].any()


def _axes_items(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _axes_items(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _scan_tanh(ws, x):
    """6 layers of ``tanh(c @ w)``, the JAX package's trip-count program."""
    for w in ws.unbind(0):
        x = torch.tanh(x @ w)
    return x.sum()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_trace_cost_counts_a_known_program(device):
    L, B, D = 6, 8, 64
    ws = torch.zeros((L, D, D), device=device)
    x = torch.zeros((B, D), device=device)
    got = cost.trace_cost(_scan_tanh, ws, x)
    assert got["flops_per_device"] == L * 2 * B * D * D
    # 6 matmuls, 6 tanh, one sum; each reads its operands and writes its result
    assert got["num_ops"] == 2 * L + 1
    f4 = 4
    want_bytes = L * f4 * (B * D + D * D + B * D) + L * f4 * 2 * B * D + f4 * (B * D + 1)
    assert got["bytes_per_device"] == want_bytes
    assert got["collective_wire_bytes_per_device"] is None
    assert got["collective_counts"] == {}
    # at most three [B, D] activations live at once: the layer's input, its
    # product and its tanh, before the loop drops the input
    assert got["peak_live_bytes"] == 3 * f4 * B * D


def test_trace_cost_counts_kernel_ops_by_their_formula():
    from repro_torch.kernels import ops
    for device in ("cpu", "meta"):
        q = torch.zeros((2, 4, 40, 32), device=device)
        kv = torch.zeros((2, 2, 56, 32), device=device)
        got = cost.trace_cost(lambda: ops.flash_attention(q, kv, kv))
        assert got["flops_per_device"] == 2 * 64 * 2 * 4 * (40 * 41 // 2 + 40 * 16)
        assert got["num_ops"] == 1
        x = torch.zeros((3, 16, 4, 8), device=device)
        ssd = (x, torch.zeros((3, 16, 4), device=device), torch.zeros(4, device=device),
               torch.zeros((3, 16, 2, 6), device=device),
               torch.zeros((3, 16, 2, 6), device=device), torch.zeros(4, device=device))
        got = cost.trace_cost(lambda: ops.ssd_chunk(*ssd))
        assert got["flops_per_device"] == ops.ssd_chunk_flops(3, 16, 4, 8, 2, 6)
        assert got["num_ops"] == 1
    assert ops.causal_pairs(4, 4, False) == 16 and ops.causal_pairs(4, 6, True) == 18
    assert ops.causal_pairs(6, 4, True) == 10
    with pytest.raises(ValueError, match="meta"):
        ops.power_sim(torch.zeros((4, 3), device="meta"), p_idle=1.0, p_max=2.0, r=1.0,
                      peak_tflops=1.0, dt_seconds=1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.des_readout(torch.zeros((4, 3), device="meta"), p_idle=1.0, p_max=2.0, r=1.0)


def _reduced(arch):
    return dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=2,
                               dtype="float32")


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_count_equals_cpu_count(arch, kind):
    cfg = _reduced(arch)
    specs = steps.param_specs_for(cfg)
    pm = abstract_params(specs, torch.float32)
    pc = init_params(specs, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    shape = shapes.ShapeSpec("t", kind, 128, 2)
    bm, bc = shapes.input_structs(cfg, shape), shapes.concrete_inputs(cfg, shape, device="cpu")
    if kind == "train":
        step = steps.make_train_step(cfg, AdamWConfig())
        am = (pm, abstract_opt_state(pm, AdamWConfig()), bm)
        ac = (pc, init_opt_state(pc, AdamWConfig()), bc)
    else:
        step = steps.make_prefill_step(cfg)
        am, ac = (pm, bm), (pc, bc)
    step(*am), step(*ac)       # warm the per-device caches (RoPE's frequencies)
    m, c = cost.trace_cost(step, *am), cost.trace_cost(step, *ac)
    assert m["flops_per_device"] == c["flops_per_device"] > 0
    assert abs(m["bytes_per_device"] / c["bytes_per_device"] - 1) <= 0.01
    assert m["num_ops"] == c["num_ops"]
    assert abs(m["peak_live_bytes"] / c["peak_live_bytes"] - 1) <= 0.01
    out = leaves(m["out"])
    assert all(t.device.type == "meta" for t in out)


def test_model_flops_match_jax():
    for arch in all_archs():
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for shape in shapes.SHAPES.values():
            for train in (False, True):
                assert roofline.model_flops_for(cfg, shape.kind, shape.batch, shape.seq,
                                                train) == \
                    jax_roofline.model_flops_for(jcfg, shape.kind, shape.batch, shape.seq,
                                                 train)


def test_roofline_takes_only_the_modelled_terms():
    parsed = {"flops_per_device": 989.4e12, "bytes_per_device": 6.7e12,
              "collective_wire_bytes_per_device": None}
    r = roofline.make_roofline(parsed, 1e12, 4)
    assert r.collective_s is None and r.dominant == "memory" and r.bound_s == 2.0
    assert r.compute_s == 1.0
    parsed["collective_wire_bytes_per_device"] = 1.35e12
    r = roofline.make_roofline(parsed, 1e12, 4)
    assert r.dominant == "collective" and r.bound_s == 3.0
    d = r.to_dict()
    assert d["collective_s"] == 3.0 and d["chips"] == 4


def _jax_sharded_bytes(items, mesh, mode):
    """Bytes a device holds of ``(shape, axes, itemsize)`` leaves, from
    JAX's partition specs."""
    total = 0
    for shp, ax, itemsize in items:
        spec = jax_sharding.logical_to_spec(ax, shp, mesh, mode)
        per = list(shp)
        for i, entry in enumerate(spec):
            per[i] //= jax_sharding.mesh_axis_size(mesh, entry)
        total += math.prod(per) * itemsize
    return total


def test_dryrun_cell_argument_bytes_match_jax_specs():
    out = dryrun.dryrun_cell("smollm-360m", "decode_32k", False, verbose=False)
    assert out["status"] == "ok" and out["chips"] == 256
    jcfg = jax_get_config("smollm-360m")
    shape = jax_shapes.SHAPES["decode_32k"]
    mesh = jax_sharding.abstract_mesh_compat((16, 16), ("data", "model"))
    isz = jnp.dtype(jcfg.dtype).itemsize
    items = [(s.shape, s.axes, jnp.dtype(s.dtype).itemsize if s.dtype else isz)
             for tree in (jax_steps.param_specs_for(jcfg),
                          jax_steps.state_specs_for(jcfg, shape.batch, shape.seq))
             for s in jax_common.jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))]
    axes = jax_shapes.batch_axes(jcfg, shape)
    items += [(tuple(v.shape), axes[k], jnp.dtype(v.dtype).itemsize)
              for k, v in jax_shapes.input_structs(jcfg, shape).items()]
    assert out["memory"]["argument_bytes_per_device"] == _jax_sharded_bytes(
        items, mesh, "serve")
    assert out["memory"]["peak_live_bytes_global"] > 0
    assert out["memory"]["temp_bytes_per_device"] is None
    c, r = out["cost"], out["roofline"]
    assert c["collective_wire_bytes_per_device"] is None and r["collective_s"] is None
    assert c["flops_per_device"] == c["flops_global"] / 256
    assert r["dominant"] in ("compute", "memory") and r["bound_s"] > 0
    assert 0 < r["useful_flops_fraction"] <= 1


def test_long_context_cell_is_skipped_for_a_dense_arch():
    out = dryrun.dryrun_cell("smollm-360m", "long_500k", True, verbose=False)
    assert out["status"] == "skipped" and "full-attention" in out["reason"]


def test_dryrun_cli_writes_cells_and_exits_by_failures(tmp_path):
    argv = ["--arch", "stablelm-3b", "--shape", "long_500k", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as done:
        dryrun.main(argv)
    assert done.value.code == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "stablelm-3b__long_500k__multi.json", "stablelm-3b__long_500k__single.json"]
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert done.value.code == 1
    table = dryrun.summary_table(str(tmp_path))
    assert "| arch | decode_32k | long_500k |" in table
    assert "| stablelm-3b | - | skipped / skipped |" in table
    assert "3 cells: 0 ok, 2 skipped, 1 errors" in table
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--help"],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1]
                                                / "src")})
    assert "--skip-existing" in run.stdout, run.stderr
