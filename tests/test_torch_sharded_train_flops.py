"""The per-device train step at full width: every arch, 2 layers, ``[2,
2048]``, over a ``(data 2, model 4)`` mesh of ``meta`` entries
(``launch.dryrun.dryrun_cell``).  Each device's FLOPs stay within 10 % of
the plain step's count over the 8 devices, and no local product of the
sharded trace takes the whole vocabulary or the whole batch's tokens:
each weight product's backward runs on the device's own tokens and its
own split of the weight (``parallel.sharding.matmul``), where DTensor's
own choice per op would gather them.  Full width on ``meta`` allocates
nothing; a cell traces in ~4-12 s.

The record (:func:`products`) wraps the flop counter's ``_count_flops``
for the length of a cell: each product's name, operand shapes and FLOPs,
apart for the plain trace and the sharded one."""

import dataclasses
import functools
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.models.lm import LOSS_CHUNK  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESH = (2, 4)
B, S = 2, 2048
#: per-device FLOPs / (plain FLOPs / devices); 1.54-2.59 while DTensor
#: placed each backward product itself (Seamless 1.058)
SHARE_BAR = 1.10
#: the products the record holds apart (2-D and batched dots)
PRODUCTS = ("mm", "addmm", "bmm")


@dataclasses.dataclass
class Traced:
    cfg: object
    cost: dict
    plain: list      # (op, operand shapes, FLOPs) of the plain trace
    local: list      # the same of the sharded trace, one device's


@functools.lru_cache(maxsize=None)
def products(arch: str) -> Traced:
    """The cell of ``arch`` traced, with every product's record."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    record, traces = [], []
    real_count, real_trace = FlopCounterMode._count_flops, dryrun.trace_cost

    def count(self, func, out, args, kwargs):
        before = self.get_total_flops()
        r = real_count(self, func, out, args, kwargs)
        if func.__name__ in PRODUCTS:
            record.append((func.__name__,
                           tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)),
                           self.get_total_flops() - before))
        return r

    def trace(*a, **k):
        traces.append(len(record))
        return real_trace(*a, **k)

    try:
        with mock.patch.object(FlopCounterMode, "_count_flops", count), \
                mock.patch.object(dryrun, "trace_cost", trace):
            out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec("train", "train", S, B), False,
                                     verbose=False,
                                     mesh=sharding.abstract_mesh_compat(MESH, ("data", "model")))
    finally:
        sharding.close_fake_world()
    assert len(traces) == 2, traces
    return Traced(cfg, out["cost"], record[traces[0]:traces[1]], record[traces[1]:])


ARCHS = all_archs()


def widths(cfg) -> set:
    """The arch's integer fields and the widths its projections make of
    them (heads x head dim, MLA's heads x its query and key-value head
    dims, the SSM's inner width)."""
    out = {v for v in dataclasses.asdict(cfg).values() if isinstance(v, int)}
    out |= {cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim,
            cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim),
            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)}
    if cfg.family in ("ssm", "hybrid"):
        out.add(cfg.expand * cfg.d_model)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_per_device_within_the_plain_share(arch):
    t = products(arch)
    devices = MESH[0] * MESH[1]
    share = t.cost["flops_global"] / devices
    # no product runs on gathered inputs (torch 2.11's DTensor gathers for a
    # few other ops: Mamba2's cumsum backward, an index_put of Seamless's)
    assert not set(t.cost["dtensor_fallbacks"]) & set(PRODUCTS), t.cost["dtensor_fallbacks"]
    assert t.cost["flops_per_device"] <= SHARE_BAR * share, (
        t.cost["flops_per_device"] / share,
        sorted(t.local, key=lambda r: -r[2])[:6])


@pytest.mark.parametrize("arch", ARCHS)
def test_no_local_product_takes_the_whole_vocabulary_or_batch(arch):
    """The vocabulary: a product holding all of it does at most the
    device's share of a CE chunk's product (only where ``model`` does not
    divide the vocabulary: the chunk's rows split over it instead).  The
    tokens: no 2-D product (the weight products, folded) holds all ``B x
    S`` of the batch (the device's share is ``B x S / data``), where that
    count is no width of the arch (:func:`widths`: Seamless's ``d_ff``,
    Zamba2's SSM width and DeepSeek's key-value expansion are 4096, so a
    dim says nothing there)."""
    t = products(arch)
    cfg, data, model = t.cfg, MESH[0], MESH[1]
    chunk_share = 2 * cfg.vocab * cfg.d_model * B * min(LOSS_CHUNK, S) / (data * model)
    assert t.local and t.plain
    for op, shp, flops in t.local:
        dims = {d for s in shp for d in s}
        if cfg.vocab in dims:
            assert cfg.vocab % model, (op, shp)
            assert flops <= chunk_share, (op, shp, flops, chunk_share)
        if op != "bmm" and B * S not in widths(cfg):
            assert B * S not in dims, (op, shp)
    assert any(cfg.vocab in {d for s in shp for d in s} for _, shp, _ in t.plain)
