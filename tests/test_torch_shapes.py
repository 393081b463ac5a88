"""The port's dry-run shapes against the JAX package's
(``repro.launch.shapes``): the four assigned shapes, the cell rule, the
logical axes of each input, the inputs' shapes and dtypes for every
(arch x shape), ``concrete_inputs``' fields other than the token draws,
and the SURF-SARA datacenter config.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import surf_sara as jax_surf_sara  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro_torch.configs import all_archs, get_config, surf_sara  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402

#: the token fields, drawn from a torch.Generator where JAX draws from its key
TOKEN_FIELDS = ("tokens", "labels", "token")


def _dtype_name(dt) -> str:
    return str(jnp.dtype(dt)) if not isinstance(dt, torch.dtype) else str(dt).split(".")[1]


def test_shape_table_and_cell_rule_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}
    for arch in all_archs():
        for name in shapes.SHAPES:
            assert shapes.cell_supported(arch, name) == jax_shapes.cell_supported(arch, name)
    skipped = [(a, s) for a in all_archs() for s in shapes.SHAPES
               if not shapes.cell_supported(a, s)[0]]
    assert len(skipped) == 8 and {s for _, s in skipped} == {"long_500k"}


@pytest.mark.parametrize("arch", all_archs())
def test_axes_and_input_structs_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert shapes.batch_axes(cfg, shape) == jax_shapes.batch_axes(jcfg, jshape)
        assert shapes._frames_for(cfg, shape.seq) == jax_shapes._frames_for(jcfg, jshape.seq)
        got = shapes.input_structs(cfg, shape)
        want = jax_shapes.input_structs(jcfg, jshape)
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert _dtype_name(v.dtype) == _dtype_name(want[k].dtype), (name, k)


@pytest.mark.parametrize("arch", all_archs())
def test_concrete_inputs_match_jax_but_the_token_draws(arch):
    jcfg = jax_reduce_config(jax_get_config(arch), 8)
    cfg = reduce_config(get_config(arch), 8)
    for name, big in shapes.SHAPES.items():
        shape = dataclasses.replace(big, seq=64, batch=2)
        want = jax_shapes.concrete_inputs(jcfg, dataclasses.replace(
            jax_shapes.SHAPES[name], seq=64, batch=2), seed=3)
        got = shapes.concrete_inputs(cfg, shape, seed=3, device="cpu")
        assert list(got) == list(want)
        for k, v in got.items():
            w = np.asarray(want[k].astype(jnp.float32))
            assert tuple(v.shape) == w.shape and _dtype_name(v.dtype) == \
                _dtype_name(want[k].dtype), (name, k)
            if k in TOKEN_FIELDS:
                t = v.numpy()
                assert t.min() >= 0 and t.max() < min(cfg.vocab, 1000)
            else:
                np.testing.assert_array_equal(v.float().numpy(), w, err_msg=f"{name} {k}")
        if "labels" in got:            # one seed gives both, as one JAX key does
            assert torch.equal(got["tokens"], got["labels"])
    again = shapes.concrete_inputs(cfg, shapes.ShapeSpec("t", "train", 64, 2), seed=3,
                                   device="cpu")
    assert torch.equal(again["tokens"], shapes.concrete_inputs(
        cfg, shapes.ShapeSpec("t", "train", 64, 2), seed=3, device="cpu")["tokens"])


def test_surf_sara_config_matches_jax():
    assert dataclasses.asdict(surf_sara.config()) == dataclasses.asdict(jax_surf_sara.config())
    assert surf_sara.config().num_hosts == 277
