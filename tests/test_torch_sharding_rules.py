"""The port's logical-axis sharding rules against the JAX package.

``repro_torch.parallel.sharding.logical_to_spec`` on a mesh of ``meta``
entries must give JAX's ``PartitionSpec`` on its ``AbstractMesh``, leaf by
leaf, for every architecture's parameters, decode state and batch, in
both modes and on both production meshes; ``NamedSharding.shard_shape``
must equal JAX's on a real 8-device CPU mesh (a subprocess with forced
host devices); and the ambient context nests and restores.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.launch import shapes, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.common import spec_leaves  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    P,
    NamedSharding,
    ShardingCtx,
    abstract_mesh_compat,
    activation,
    current_ctx,
    logical_to_spec,
    make_mesh_compat,
    use_ctx,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_leaves(specs, prefix=""):
    """``(path, ParamSpec)`` of a JAX spec tree, keys sorted."""
    if hasattr(specs, "axes"):
        return [(prefix, specs)]
    out = []
    for k in sorted(specs):
        out += _jax_leaves(specs[k], f"{prefix}/{k}" if prefix else k)
    return out


def _leaves_of(arch):
    """Every (path, shape, axes) the rules see for ``arch``, from both
    packages: parameters, the decode state at batch 128 x 32768, and each
    shape's batch inputs."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = [(p, s.shape, s.axes) for p, s in
            _jax_leaves(jax_steps.param_specs_for(jcfg))
            + [("state/" + p, s) for p, s in
               _jax_leaves(jax_steps.state_specs_for(jcfg, 128, 32768))]]
    got = [(p, s.shape, s.axes) for p, s in
           spec_leaves(steps.param_specs_for(cfg))
           + [("state/" + p, s) for p, s in
              spec_leaves(steps.state_specs_for(cfg, 128, 32768))]]
    for name, jshape in jax_shapes.SHAPES.items():
        jstructs, jaxes = (jax_shapes.input_structs(jcfg, jshape),
                           jax_shapes.batch_axes(jcfg, jshape))
        shape = shapes.SHAPES[name]
        structs, axes = shapes.input_structs(cfg, shape), shapes.batch_axes(cfg, shape)
        want += [(f"{name}/{k}", tuple(v.shape), jaxes[k]) for k, v in sorted(jstructs.items())]
        got += [(f"{name}/{k}", tuple(v.shape), axes[k]) for k, v in sorted(structs.items())]
    return want, got


@pytest.mark.parametrize("arch", all_archs())
def test_logical_to_spec_matches_jax_on_production_meshes(arch):
    want, got = _leaves_of(arch)
    assert got == want
    for mesh_name, (shape, axes) in MESHES.items():
        jmesh = jax_sharding.abstract_mesh_compat(shape, axes)
        mesh = abstract_mesh_compat(shape, axes)
        assert mesh.size == 256 * (2 if mesh_name == "multi" else 1)
        assert all(d.type == "meta" for d in mesh.devices)
        for mode in ("train", "serve"):
            for path, shp, ax in want:
                jspec = jax_sharding.logical_to_spec(ax, shp, jmesh, mode)
                spec = logical_to_spec(ax, shp, mesh, mode)
                assert isinstance(spec, P)
                assert tuple(spec) == tuple(jspec), (mesh_name, mode, path, shp, ax)


def test_production_mesh_of_meta_entries():
    for multi, (shape, axes) in ((False, MESHES["single"]), (True, MESHES["multi"])):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        assert mesh.axis_names == axes and mesh.axis_sizes == shape
        assert {d.type for d in mesh.devices} == {"meta"}
    with pytest.raises(ValueError, match="cards or of meta"):
        make_production_mesh(device="cpu")


def test_sharding_rule_cases():
    """The cases of the JAX package's own rules test."""
    mesh = make_mesh_compat((1, 1), ("data", "model"), devices=["cpu"])
    assert logical_to_spec(("batch", "embed"), (8, 16), mesh, "train") == P()
    mesh = abstract_mesh_compat((4, 2), ("data", "model"))
    assert logical_to_spec(("batch", "ff"), (8, 16), mesh, "train") == P("data", "model")
    # non-divisible dims drop their sharding
    assert logical_to_spec(("batch", "ff"), (6, 16), mesh, "train") == P(None, "model")
    # an axis is consumed at most once
    assert logical_to_spec(("ff", "vocab"), (16, 32), mesh, "train") == P("model")
    # a rule over several axes keeps those present with size > 1, as a tuple
    mesh = abstract_mesh_compat((2, 4, 2), ("pod", "data", "model"))
    assert logical_to_spec(("batch", None), (16, 3), mesh, "serve") == P(("pod", "data"))
    assert P(None, "model", None, None) == P(None, "model")


SHARD_SHAPES = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from jax.sharding import NamedSharding
    from repro.configs import all_archs, get_config
    from repro.launch import shapes, steps
    from repro.parallel.sharding import logical_to_spec, make_mesh_compat

    def leaves(specs, prefix=""):
        if hasattr(specs, "axes"):
            return [(prefix, specs)]
        out = []
        for k in sorted(specs):
            out += leaves(specs[k], f"{prefix}/{k}" if prefix else k)
        return out

    mesh = make_mesh_compat((2, 4), ("data", "model"))
    out = {}
    for arch in all_archs():
        cfg = get_config(arch)
        items = [(p, s.shape, s.axes) for p, s in
                 leaves(steps.param_specs_for(cfg))
                 + leaves(steps.state_specs_for(cfg, 8, 64))]
        sh = shapes.SHAPES["decode_32k"]
        items += [(k, tuple(v.shape), shapes.batch_axes(cfg, sh)[k])
                  for k, v in sorted(shapes.input_structs(cfg, sh).items())]
        for mode in ("train", "serve"):
            for path, shp, ax in items:
                ns = NamedSharding(mesh, logical_to_spec(ax, shp, mesh, mode))
                out[f"{arch}|{mode}|{path}"] = [list(shp), list(ax),
                                                list(ns.shard_shape(shp))]
    print("JSON" + json.dumps(out))
""")


def test_shard_shape_matches_jax_named_sharding():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", SHARD_SHAPES], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert line, run.stdout + run.stderr
    want = json.loads(line[0][4:])
    mesh = make_mesh_compat((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert len(want) > 500
    for key, (shp, ax, jshard) in want.items():
        mode = key.split("|")[1]
        ns = NamedSharding(mesh, logical_to_spec(tuple(ax), tuple(shp), mesh, mode))
        assert list(ns.shard_shape(tuple(shp))) == jshard, key
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, P("model")).shard_shape((6,))


def test_ambient_context_nests_and_activation_is_identity():
    assert current_ctx() == ShardingCtx()
    outer = ShardingCtx(mesh=make_mesh_compat((1, 2), ("data", "model"),
                                              devices=["cpu"] * 2), mode="serve")
    inner = ShardingCtx(mesh=abstract_mesh_compat((2, 2), ("data", "model")))
    x = torch.ones((4, 3))
    with use_ctx(outer) as got:
        assert got is outer and current_ctx() is outer
        with use_ctx(inner):
            assert current_ctx() is inner
            assert activation(x, "batch", None) is x
        assert current_ctx() is outer
        assert activation(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank"):
            activation(x, "batch", None, None)
    assert current_ctx() == ShardingCtx()
    assert sharding.constraint(x, ("batch", None, None), None) is x   # no mesh: no-op
    assert ShardingCtx().on(x, "batch") is x
