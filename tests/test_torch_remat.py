"""``cfg.remat`` of the port against the JAX package's.

``"dots"`` (every config's default) is a selective checkpoint that keeps
the outputs of the 2-D products and recomputes the rest, as JAX's
``checkpoint_dots_with_no_batch_dims``: a train step's dot FLOPs (the
port's ``analysis.cost.trace_cost`` on ``meta``) are within 2 % of JAX's
HLO count (``repro.analysis.hlo.analyze_compiled_text`` of the compiled
step) for every arch at ``reduce_config(cfg, 8)``, batch ``[2, 256]``.  Op
by op (``FlopCounterMode``), ``"dots"`` recomputes no ``mm`` (its ``mm``
FLOPs equal ``"none"``'s) and recomputes the batched products and the two
kernel operators as ``"full"`` does, which also recomputes the ``mm``s.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.analysis.hlo import analyze_compiled_text  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models.common import abstract_params as jax_abstract_params  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.launch import shapes, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state  # noqa: E402

BATCH, SEQ = 2, 256
#: port / JAX dot FLOPs of a "dots" train step
FLOPS_RTOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_train_flops(arch: str) -> float:
    cfg = jax_reduce_config(jax_get_config(arch), 8)
    assert cfg.remat == "dots"
    p = jax_abstract_params(jax_steps.param_specs_for(cfg), jnp.dtype(cfg.dtype))
    opt = jax_adamw.AdamWConfig()
    batch = jax_shapes.input_structs(cfg, jax_shapes.ShapeSpec("t", "train", SEQ, BATCH))
    lowered = jax.jit(jax_steps.make_train_step(cfg, opt)).lower(
        p, jax_adamw.abstract_opt_state(p, opt), batch)
    return analyze_compiled_text(lowered.compile().as_text(), 1)["flops_per_device"]


def port_train_step(arch: str, remat: str):
    """``(step, args)`` of the reduced arch's train step on ``meta``."""
    cfg = dataclasses.replace(reduce_config(get_config(arch), 8), remat=remat)
    p = abstract_params(steps.param_specs_for(cfg), getattr(torch, cfg.dtype))
    batch = shapes.input_structs(cfg, shapes.ShapeSpec("t", "train", SEQ, BATCH))
    opt = AdamWConfig()
    return steps.make_train_step(cfg, opt), (p, abstract_opt_state(p, opt), batch)


def flops_by_op(arch: str, remat: str) -> dict[str, int]:
    step, args = port_train_step(arch, remat)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("arch", all_archs())
def test_dots_train_flops_match_jax_and_keep_only_mm(arch):
    step, args = port_train_step(arch, "dots")
    got = cost.trace_cost(step, *args)["flops_per_device"]
    want = jax_train_flops(arch)
    assert abs(got / want - 1) <= FLOPS_RTOL, (got, want)
    by = {m: flops_by_op(arch, m) for m in ("none", "dots", "full")}
    assert sum(by["dots"].values()) == got
    assert by["dots"]["aten.mm"] == by["none"]["aten.mm"]      # no 2-D product recomputed
    assert by["full"]["aten.mm"] > by["none"]["aten.mm"]       # every one the backward reads
    kernel = "repro_torch.ssd_chunk" if "repro_torch.ssd_chunk" in by["dots"] else \
        "repro_torch.flash_attention"
    # the kernel operator and the batched products are recomputed by both
    for op in (kernel, "aten.bmm"):
        assert by["dots"].get(op, 0) == by["full"].get(op, 0), op
    assert by["dots"][kernel] == 2 * by["none"][kernel]       # forward + recompute
    assert set(by["dots"]) == set(by["full"]) == set(by["none"])
