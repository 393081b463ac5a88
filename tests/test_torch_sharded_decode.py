"""The per-device decode step, and the ops DTensor places differently
between torch versions.

At full width (``decode_32k``: ``[128]`` tokens against a 32768-token
cache, the 16x16 ``(data, model)`` mesh of ``meta`` entries,
``launch.dryrun.dryrun_cell``) the serve rules split the cache's sequence
over ``model``.  The decode softmax then runs on the shards
(``sharding.softmax_last``: a max and a sum all-reduced as rows), where
DTensor's own softmax gathered the f32 logits whole on every device:
92-97 % of each cell's wire bytes before.  Each cell's wire bytes a device
are held to a tenth of the parent's, no cell falls back on an op DTensor
cannot place (``dtensor_fallbacks``), nothing moves by all-to-all, and no
cell's FLOPs a device rise.  The seven cells trace in ~35 s.

On reduced configs over ``(data, model)`` meshes, the ops that torch
2.11's DTensor does not place never reach DTensor:
the SSD's ``cumsum`` (its backward's ``flip``), the embedding's backward
``index_put`` and the greedy ``argmax`` run on each device's shards.  On
plain tensors the helpers are the plain ops, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cost  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

#: the parent's per-device wire bytes and FLOPs of each full-width
#: decode_32k cell (torch 2.13, single mesh)
PARENT = {
    "smollm-360m": (486443280.0, 2375024640.0),
    "qwen2-vl-7b": (817261200.0, 13646954496.0),
    "minicpm3-4b": (2540672400.0, 49500426240.0),
    "deepseek-v2-lite-16b": (461821590.0, 30949244928.0),
    "command-r-plus-104b": (6446655120.0, 155348631552.0),
    "stablelm-3b": (169222800.0, 8035041280.0),
    "seamless-m4t-medium": (33307140.0, 1306736640.0),
}
#: the share of the parent's wire bytes a cell may keep: a tenth where the
#: gathered softmax was most of them; StableLM and Seamless moved their
#: logits by all-to-all instead
CEILING = {"stablelm-3b": 0.5, "seamless-m4t-medium": 0.5}


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    yield
    sharding.close_fake_world()


@pytest.mark.parametrize("arch", list(PARENT))
def test_full_width_decode_keeps_the_cache_split(arch):
    """decode_32k on the 16x16 mesh: no fallback, no all-to-all, wire
    bytes a device at most the arch's share of the parent's, and FLOPs a
    device no higher than the parent's."""
    out = dryrun.dryrun_cell(arch, "decode_32k", False, verbose=False)
    c = out["cost"]
    wire, flops = PARENT[arch]
    assert c["dtensor_fallbacks"] == {}, c["dtensor_fallbacks"]
    assert "all-to-all" not in c["collective_wire_bytes_by_kind"], \
        c["collective_wire_bytes_by_kind"]
    assert c["collective_wire_bytes_per_device"] <= CEILING.get(arch, 0.1) * wire, \
        (c["collective_wire_bytes_per_device"], wire)
    assert c["flops_per_device"] <= flops, (c["flops_per_device"], flops)


#: ops torch 2.11's DTensor has no strategy for where the port met them:
#: each now runs on local tensors
UNPLACED_211 = {"flip", "index_put", "index_put_", "_index_put_impl_", "argmax", "cumsum"}

#: reduced cells that reached them: (arch, kind, seq, batch, mesh); the
#: SSD's cumsum (Mamba2, Zamba2), the embedding's backward where ``model``
#: does not divide the vocabulary (Mamba2, MiniCPM3, Seamless; on a mesh
#: whose ``data`` is 1 nothing splits the table or the ids, and the
#: gradient still arrives split), the greedy argmax of one row (Zamba2's
#: long decode) and Seamless's cross-attention
REDUCED_CELLS = [("mamba2-370m", "train", 256, 8, (2, 4)),
                 ("mamba2-370m", "train", 256, 8, (1, 4)),
                 ("zamba2-1.2b", "train", 256, 8, (2, 4)),
                 ("minicpm3-4b", "train", 256, 8, (2, 4)),
                 ("seamless-m4t-medium", "train", 256, 8, (2, 4)),
                 ("zamba2-1.2b", "decode", 1024, 1, (2, 4)),
                 ("seamless-m4t-medium", "decode", 256, 8, (2, 4)),
                 ("command-r-plus-104b", "decode", 256, 8, (2, 4))]


@pytest.mark.parametrize("arch,kind,seq,batch,mesh", REDUCED_CELLS)
def test_reduced_cells_keep_211_gaps_off_dtensor(monkeypatch, arch, kind, seq, batch, mesh):
    """On a ``(data, model)`` mesh, none of :data:`UNPLACED_211` reaches
    DTensor's dispatch in the cell's trace, and nothing falls back."""
    seen = []
    real = cost._CostMode._sharded

    def spy(self, func, args, kwargs):
        seen.append(func.overloadpacket.__name__)
        return real(self, func, args, kwargs)

    monkeypatch.setattr(cost._CostMode, "_sharded", spy)
    cfg = dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=2)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=1, dec_layers=2)
    out = dryrun.dryrun_cell(cfg, shapes.ShapeSpec(kind, kind, seq, batch), False,
                             verbose=False,
                             mesh=sharding.abstract_mesh_compat(mesh, ("data", "model")))
    assert out["cost"]["dtensor_fallbacks"] == {}
    assert seen, "no DTensor op traced"
    assert not UNPLACED_211 & set(seen), sorted(UNPLACED_211 & set(seen))


# -- plain tensors keep their ops and bits ------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def test_helpers_on_plain_tensors_are_the_plain_ops():
    """``softmax_last``, ``argmax_last`` and ``cumsum`` on plain tensors
    equal ``torch.softmax``, ``torch.argmax`` and ``torch.cumsum`` bit for
    bit, ties to the first index included."""
    x = torch.from_numpy(_rng(1).normal(0, 3, (4, 5, 3, 257)).astype(np.float32))
    assert torch.equal(sharding.softmax_last(x), torch.softmax(x, dim=-1))
    ties = torch.from_numpy(_rng(2).integers(0, 4, (6, 300)).astype(np.float32))
    for t in (x, ties):
        assert torch.equal(sharding.argmax_last(t), torch.argmax(t, dim=-1))
    assert torch.equal(sharding.argmax_last(ties), (ties == 3).to(torch.int64).argmax(-1))
    leaf = x.clone().requires_grad_()
    got = sharding.cumsum(leaf, 2)
    want_leaf = x.clone().requires_grad_()
    want = torch.cumsum(want_leaf, dim=2)
    assert torch.equal(got, want)
    g = torch.from_numpy(_rng(3).normal(0, 1, x.shape).astype(np.float32))
    assert torch.equal(torch.autograd.grad(got, leaf, g)[0],
                       torch.autograd.grad(want, want_leaf, g)[0])


def _decode_steps(q, k_cache, v_cache, cache_len, scale):
    """The decode's plain steps as written before the sharded paths: one
    product over the cache, the live mask, the softmax, the second
    product."""
    b, _, hq, d = q.shape
    _, t, hkv, _ = k_cache.shape
    qg = (q * scale).reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    if cache_len is not None:
        live = torch.arange(t)[None] < cache_len[:, None]
        logits = logits.masked_fill(~live[:, None, None], attention.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [None, (3, 64, 17)])
def test_plain_decode_attention_is_its_plain_steps(dtype_name, lengths):
    """``decode_attention`` on plain tensors (15 query heads over 5 kv
    heads), in a model dtype, equals its plain steps bit for bit."""
    dtype = getattr(torch, dtype_name)
    rng = _rng(4)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype)
               for s in ((3, 1, 15, 16), (3, 64, 5, 16), (3, 64, 5, 16)))
    cache_len = None if lengths is None else torch.tensor(lengths)
    got = attention.decode_attention(q, k, v, cache_len=cache_len)
    assert torch.equal(got, _decode_steps(q, k, v, cache_len, 16 ** -0.5))
