"""The per-device dry-run: DTensors over a ``fake`` process group in one
process (``parallel.sharding.device_mesh``), counted below DTensor by
``analysis.cost.trace_cost``.  Collectives and their wire bytes against
hand counts (a sharded matmul's all-reduce, a ZeRO-3 gather, the MoE
branch's ``psum``), a data-only mesh against the global count, a mesh of
size-1 axes against the plain count, a cell's output and alias bytes
against JAX's partition specs, and the restored ``activation`` sites
moving nothing on plain tensors.  Reduced configs only.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import dryrun, shapes, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import abstract_params, init_params, specs_to_shardings  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    P,
    NamedSharding,
    ShardingCtx,
    abstract_mesh_compat,
    make_mesh_compat,
)

from test_torch_dryrun import _jax_sharded_bytes  # noqa: E402
from test_torch_moe_ep import CFG as MOE_CFG  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    sharding.close_fake_world()


def _mesh(data, model):
    return abstract_mesh_compat((data, model), ("data", "model"))


def _reduced(arch, layers=2):
    return dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=layers)


def _placed(shape, mesh, *spec, dtype=torch.float32):
    return sharding.distribute(torch.empty(shape, dtype=dtype, device="meta"),
                               NamedSharding(mesh, P(*spec)))


def test_sharded_matmul_all_reduce_wire_bytes_by_hand():
    """``[8, 64] @ [64, 32]`` with the contraction split over ``model`` (4):
    a partial sum, replicated by one all-reduce of the ``[8, 32]`` f32
    output, ``2 out (g - 1) / g`` on the wire."""
    mesh = _mesh(1, 4)
    x = _placed((8, 64), mesh, None, "model")
    w = _placed((64, 32), mesh, "model", None)
    dm = sharding.device_mesh(mesh)
    from torch.distributed.tensor import Replicate

    out = cost.trace_cost(lambda a, b: (a @ b).redistribute(dm, [Replicate()] * 2), x, w)
    assert out["collective_counts"] == {"all-reduce": 1}
    assert out["collective_wire_bytes_per_device"] == 2 * (8 * 32 * 4) * 3 / 4
    assert out["flops_per_device"] == 2 * 8 * 16 * 32          # the local block
    assert out["out"].to_local().shape == (8, 32)


def test_zero3_gather_of_an_embed_split_weight_by_hand():
    """A train-mode weight ``("embed", "ff")`` on a ``(data 4, model 2)``
    mesh is split on ``embed`` over ``data`` (ZeRO-3); gathering it whole
    over ``data`` is one all-gather of ``out (g - 1) / g``."""
    mesh = _mesh(4, 2)
    sh = NamedSharding(mesh, sharding.logical_to_spec(("embed", "ff"), (64, 32), mesh, "train"))
    assert sh.spec == P("data", "model")
    w = sharding.distribute(torch.empty((64, 32), dtype=torch.float32, device="meta"), sh)
    from torch.distributed.tensor import Replicate, Shard

    dm = sharding.device_mesh(mesh)
    out = cost.trace_cost(lambda t: t.redistribute(dm, [Replicate(), Shard(1)]), w)
    assert out["collective_counts"] == {"all-gather": 1}
    gathered = 64 * (32 // 2) * 4                                # [64, 16] f32
    assert out["collective_wire_bytes_per_device"] == gathered * 3 / 4


def test_moe_branch_psum_counted_once_a_layer():
    """The expert-parallel branch on DTensors over ``model`` (4): the shard's
    ``_moe_local`` on its experts, ``y``'s ``psum`` one all-reduce of the
    local ``[B, S, d]`` block, ``aux``'s one of a scalar; the weights are
    already placed as ``shard_map`` asks (experts over ``model``), so no
    gather."""
    cfg = ModelConfig(**MOE_CFG).validate()
    mesh = _mesh(1, 4)
    specs = moe.moe_specs(cfg, 1)
    p_abs = {k: v[0] for k, v in abstract_params(specs, torch.float32).items()}
    sh = specs_to_shardings({k: dataclasses.replace(s, shape=s.shape[1:], axes=s.axes[1:])
                             for k, s in specs.items()}, mesh, "serve")
    p = {k: sharding.distribute(v, sh[k]) for k, v in p_abs.items() if k in
         ("router", "w_gate", "w_up", "w_down")}
    x = _placed((4, 8, cfg.d_model), mesh, None, None, None)
    ctx = ShardingCtx(mesh=mesh, mode="serve")
    out = cost.trace_cost(lambda x_, p_: moe.moe_ffn(
        dataclasses.replace(cfg, n_shared_experts=0), p_, x_, ctx), x, p)
    y, aux = out["out"]
    assert y.shape == (4, 8, cfg.d_model) and aux.shape == ()
    assert out["collective_counts"] == {"all-reduce": 2}
    y_bytes = 4 * 8 * cfg.d_model * 4
    assert out["collective_wire_bytes_per_device"] == (2 * y_bytes + 2 * 4) * 3 / 4
    assert out["dtensor_fallbacks"] == {}


def _cell(cfg, kind, b, s, mesh):
    return dryrun.dryrun_cell(cfg, shapes.ShapeSpec(kind, kind, s, b), False, verbose=False,
                              mesh=mesh)


def test_data_only_mesh_splits_a_prefill_exactly():
    """A ``(data 8, model 1)`` serve mesh on a reduced SmolLM prefill: each
    device runs one batch row, so its FLOPs times 8 are the global count,
    and nothing is communicated."""
    out = _cell(_reduced("smollm-360m"), "prefill", 8, 256, _mesh(8, 1))
    c = out["cost"]
    assert c["flops_per_device"] * 8 == c["flops_global"]
    assert c["collective_counts"] == {} and c["collective_wire_bytes_per_device"] == 0.0
    assert out["roofline"]["collective_s"] == 0.0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_by_one_mesh_is_the_global_record(kind):
    """On a ``(1, 1)`` mesh every DTensor is whole: the per-device count
    is the plain one (FLOPs, bytes, ops), wire bytes 0."""
    c = _cell(_reduced("smollm-360m"), kind, 4, 256, _mesh(1, 1))["cost"]
    assert c["flops_per_device"] == c["flops_global"]
    assert c["bytes_per_device"] == c["bytes_global"]
    assert c["num_ops"] == c["num_ops_global"]
    assert c["collective_counts"] == {} and c["collective_wire_bytes_per_device"] == 0.0


def _jax_items(jcfg, tree):
    isz = jnp.dtype(jcfg.dtype).itemsize
    from repro.models import common as jax_common

    return [(s.shape, s.axes, jnp.dtype(s.dtype).itemsize if s.dtype else isz)
            for s in jax_common.jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_output_and_alias_bytes_match_jax_specs(kind):
    """A reduced SmolLM cell on a ``(data 2, model 4)`` mesh: the output
    bytes a device holds are JAX's ``out_shardings`` (train: params and
    both moments placed as they came in, the six metrics replicated
    scalars; decode: the state as it came in, the ``[B]`` token
    replicated), the alias bytes the donated arguments (params and
    moments; the state)."""
    cfg = _reduced("smollm-360m")
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config("smollm-360m"), 8), num_layers=2)
    jmesh = jax_sharding.abstract_mesh_compat((2, 4), ("data", "model"))
    b, s = 8, 256
    out = _cell(cfg, kind, b, s, _mesh(2, 4))
    m = out["memory"]
    if kind == "train":
        items = _jax_items(jcfg, jax_steps.param_specs_for(jcfg))
        params = _jax_sharded_bytes(items, jmesh, "train")
        # the AdamW moments are float32 and placed as their parameter; the
        # step count an int32 scalar, replicated
        moments = _jax_sharded_bytes([(shp, ax, 4) for shp, ax, _ in items], jmesh, "train")
        assert m["alias_bytes_per_device"] == params + 2 * moments + 4
        assert m["output_bytes_per_device"] == params + 2 * moments + 4 + 6 * 4
    else:
        state = _jax_sharded_bytes(_jax_items(jcfg, jax_steps.state_specs_for(jcfg, b, s)),
                                   jmesh, "serve")
        assert m["alias_bytes_per_device"] == state
        assert m["output_bytes_per_device"] == state + b * 4
    assert m["peak_bytes_per_device"] == (m["argument_bytes_per_device"]
                                          + m["output_bytes_per_device"]
                                          + m["temp_bytes_per_device"]
                                          - m["alias_bytes_per_device"])
    assert out["roofline"]["collective_s"] > 0


def test_constraint_on_a_plain_tensor_is_the_same_object():
    x = torch.ones(4, 6)
    mesh = make_mesh_compat((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert sharding.constraint(x, ("batch", "ff"), mesh) is x
    assert sharding.constraint(x, ("batch", "ff"), None) is x
    with sharding.use_ctx(ShardingCtx(mesh=mesh)):
        assert sharding.activation(x, "batch", None) is x


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m", "qwen2-moe-a2.7b"])
def test_activation_sites_move_nothing_on_plain_tensors(arch, monkeypatch):
    """The restored ``activation`` sites leave a one-process step bit for
    bit: a forward, the loss and every gradient under a 2x2 CPU mesh
    (the MoE's expert-parallel branch included) equal the same step with
    every site made the identity, as the port had them before."""
    cfg = dataclasses.replace(_reduced(arch), dtype="float32", remat="dots")
    p = init_params(steps.param_specs_for(cfg), torch.Generator().manual_seed(3),
                    torch.float32, device="cpu")
    batch = shapes.concrete_inputs(cfg, shapes.ShapeSpec("t", "train", 64, 2), seed=4,
                                   device="cpu")
    mesh = make_mesh_compat((1, 2), ("data", "model"), devices=["cpu"] * 2)
    opt = AdamWConfig()

    def run():
        step = steps.make_train_step(cfg, opt, ShardingCtx(mesh=mesh))
        new, _, metrics = step(p, init_opt_state(p, opt), batch)
        logits = steps.make_prefill_step(cfg, ShardingCtx(mesh=mesh, mode="serve"))(p, batch)
        return new, metrics, logits

    with_sites = run()
    ident = lambda x, *axes: x  # noqa: E731
    for mod in ("lm", "blocks", "attention", "mla", "mamba2"):
        monkeypatch.setattr(f"repro_torch.models.{mod}.activation", ident)
    without = run()
    a, b = leaves(list(with_sites)), leaves(list(without))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
