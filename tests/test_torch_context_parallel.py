"""Context parallelism of the port's attention: where the mesh's ``model``
axis does not divide the kv heads, the flash call splits its query rows
over ``model`` (the JAX package's ``attn_q_seq``), shard ``r`` attending
the causal prefix of the keys (``models.attention.flash_rows``).

The shards at every coordinate, put together, against the unsplit plain
call and JAX's ``chunked_attention`` on the CPU (its ``xla`` route),
forward and gradient; on a ``fake`` ``(data 2, model 4)`` mesh of
DTensors, the flash operands' placements, the per-device charge (the
last shard's pairs: a step waits for its slowest device) and the CE's
rows split where ``model`` does not divide the vocabulary.  Small widths.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.analysis.cost import trace_cost  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import P, NamedSharding, ShardingCtx, use_ctx  # noqa: E402

KV_CHUNK = 64
#: (hq, hkv): MQA and SmolLM-360M's grouping
HEADS = [(3, 1), (15, 5)]
#: (d, dv): equal, and MiniCPM3's MLA pair
DIMS = [(16, 16), (96, 64)]
#: (sq, skv, causal): self-attention, a causal query block at the end of
#: longer keys, a non-causal cross-attention
MASKS = [(256, 256, True), (128, 192, True), (128, 192, False)]
#: test_kernels.py's f32 bar of the attention sweep
JAX_RTOL, JAX_ATOL = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    sharding.close_fake_world()


def _inputs(hq, hkv, d, dv, sq, skv, b=2, seed=7):
    """q ``[B, Hq, Sq, D]``, k, v, and an upstream gradient, N(0, 1) f32."""
    rng = np.random.default_rng(seed + hq + d + sq + skv)
    return tuple(rng.normal(0, 1, shape).astype(np.float32) for shape in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv), (b, hq, sq, dv)))


def _shards(q, k, v, dout, tp, causal):
    """Each shard's ``(out, lse, dq, dk, dv)`` through the per-shard
    functions, at every coordinate ``r``."""
    m = q.shape[2] // tp
    scale = q.shape[-1] ** -0.5
    out = []
    for r in range(tp):
        rows = slice(r * m, (r + 1) * m)
        o, lse = attention.flash_rows(q[:, :, rows], k, v, r, tp, causal=causal,
                                      scale=scale, return_lse=True)
        grads = attention.flash_rows_backward(q[:, :, rows], k, v, o, lse, dout[:, :, rows],
                                              r, tp, causal=causal, scale=scale,
                                              kv_chunk=KV_CHUNK)
        out.append((o, lse) + grads)
    return out


@functools.lru_cache(maxsize=None)
def _jax_attention(hq, hkv, d, dv, sq, skv, causal):
    """JAX's ``chunked_attention`` (``xla``) on the inputs, and ``jax.grad``
    of ``sum(out * dout)``: ``(out, dq, dk, dv)`` on the kernel layout."""
    q, k, v, dout = (jnp.asarray(a).transpose(0, 2, 1, 3)
                     for a in _inputs(hq, hkv, d, dv, sq, skv))

    def f(q_, k_, v_):
        out = jax_attention.chunked_attention(q_, k_, v_, causal=causal, kv_chunk=KV_CHUNK)
        return (out * dout).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return tuple(np.asarray(t).transpose(0, 2, 1, 3) for t in (out,) + grads)


CASES = [(tp, *h, *dd, *mk) for tp in (2, 4) for h in HEADS for dd in DIMS for mk in MASKS]


@pytest.mark.parametrize("tp,hq,hkv,d,dv,sq,skv,causal", CASES)
def test_row_shards_put_together_match_unsplit_and_jax(tp, hq, hkv, d, dv, sq, skv, causal):
    """The shards' outputs and lse, concatenated on the rows, equal the
    unsplit plain call (rtol 1e-6) and JAX's ``chunked_attention``."""
    q, k, v, dout = map(torch.from_numpy, _inputs(hq, hkv, d, dv, sq, skv))
    shards = _shards(q, k, v, dout, tp, causal)
    out = torch.cat([s[0] for s in shards], dim=2)
    lse = torch.cat([s[1] for s in shards], dim=2)
    want, want_lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _jax_attention(hq, hkv, d, dv, sq, skv, causal)[0],
                               rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("tp,hq,hkv,d,dv,sq,skv,causal", CASES)
def test_row_shard_gradients_put_together_match_unsplit_and_jax(tp, hq, hkv, d, dv, sq,
                                                                skv, causal):
    """dq concatenated on the rows, dk and dv summed over the shards, equal
    unsplit ``FlashAttention``'s and ``jax.grad`` of JAX's, rtol 1e-4."""
    arrays = _inputs(hq, hkv, d, dv, sq, skv)
    q, k, v, dout = map(torch.from_numpy, arrays)
    shards = _shards(q, k, v, dout, tp, causal)
    got = (torch.cat([s[2] for s in shards], dim=2), sum(s[3] for s in shards),
           sum(s[4] for s in shards))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    out = attention.FlashAttention.apply(*leaves, causal, d ** -0.5, KV_CHUNK)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(arrays[3]))
    jax_grads = _jax_attention(hq, hkv, d, dv, sq, skv, causal)[1:]
    for name, g, w, j in zip(("dq", "dk", "dv"), got, want, jax_grads):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4, atol=1e-4, err_msg=name)


def test_early_shards_attend_only_their_prefix():
    """A causal shard's dk and dv are zero past its prefix, and its keys
    grow by one shard's rows a coordinate."""
    q, k, v, dout = map(torch.from_numpy, _inputs(3, 1, 16, 16, 256, 256))
    shards = _shards(q, k, v, dout, 4, True)
    for r, s in enumerate(shards):
        n = (r + 1) * 64
        assert attention._prefix(64, 256, r, 4, True) == n
        assert torch.count_nonzero(s[3][:, :, n:]) == 0 and torch.count_nonzero(s[4][:, :, n:]) == 0
        assert torch.count_nonzero(s[3][:, :, :n]) > 0
    # the causal pairs of the shards add up to the unsplit call's
    assert sum(ops.causal_pairs(64, (r + 1) * 64, True) for r in range(4)) == \
        ops.causal_pairs(256, 256, True)


# -- the fake (data 2, model 4) mesh -----------------------------------------

MESH = (2, 4)


def _mesh():
    return sharding.abstract_mesh_compat(MESH, ("data", "model"))


def _placed(shape, mesh, *spec):
    return sharding.distribute(torch.empty(shape, dtype=torch.float32, device="meta"),
                               NamedSharding(mesh, P(*spec)))


def _qkv(mesh, b, s, hq, hkv, d, dv):
    """q, k, v ``[B, S, H, D]`` split on the batch over ``data``."""
    return (_placed((b, s, hq, d), mesh, "data"), _placed((b, s, hkv, d), mesh, "data"),
            _placed((b, s, hkv, dv), mesh, "data"))


@pytest.mark.parametrize("hkv,model_placement", [(5, "rows"), (1, "rows"), (4, "heads")])
def test_flash_operands_take_rows_where_model_does_not_divide_kv_heads(monkeypatch, hkv,
                                                                       model_placement):
    """On the mesh, q reaches the flash call split over ``model`` on its
    rows (the kernel layout's dim 2) for 5 and 1 kv heads, with k and v
    whole there, and on its heads (dim 1) for 4, where the operator's
    rule splits k and v alike: a device's flash FLOPs are those of its
    quarter of the heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh()
    seen = []
    real = attention.flash_forward

    def probe(q, k, v, *args):
        seen.append((list(q.placements), list(k.placements)))
        return real(q, k, v, *args)

    monkeypatch.setattr(attention, "flash_forward", probe)
    hq = 3 * hkv
    with use_ctx(ShardingCtx(mesh=mesh, mode="serve")), torch.no_grad():
        traced = trace_cost(attention.chunked_attention, *_qkv(mesh, 4, 256, hq, hkv, 16, 16))
    out = traced["out"]
    (q_pl, k_pl), = seen
    assert q_pl[0] == Shard(0) and k_pl[0] == Shard(0)            # batch over data
    if model_placement == "rows":
        assert q_pl[1] == Shard(2) and k_pl[1] == Replicate()
        assert out.placements[1] == Shard(1)                      # [B, S, H, Dv] rows
    else:
        assert q_pl[1] == Shard(1)
        assert traced["flops_per_device"] == ops.flash_attention_flops(2, hq // 4, 256, 256,
                                                                      16, 16, True)
    assert out.shape == (4, 256, hq, 16)


def test_row_split_drops_where_model_does_not_divide_the_rows(monkeypatch):
    """A sequence of 250 rows does not split over 4: the call runs with q
    whole over ``model``, as JAX's ``logical_to_spec`` drops the split."""
    from torch.distributed.tensor import Replicate

    mesh = _mesh()
    seen = []
    real = attention.flash_forward
    monkeypatch.setattr(attention, "flash_forward",
                        lambda q, *a: seen.append(list(q.placements)) or real(q, *a))
    with use_ctx(ShardingCtx(mesh=mesh, mode="serve")):
        attention.chunked_attention(*_qkv(mesh, 4, 250, 15, 5, 16, 16))
    assert seen[0][1] == Replicate()


@pytest.mark.parametrize("causal", [True, False])
def test_charged_flash_flops_are_the_last_shards(causal):
    """The per-device count of a row-split flash call (forward, then its
    gradient) charges the last shard's work: the forward's
    ``flash_attention_flops`` at ``m`` rows over the last prefix (the
    whole ``S`` keys), not rank 0's first ``m``."""
    mesh = _mesh()
    b, s, hq, hkv, d = 4, 256, 15, 5, 16
    m = s // MESH[1]
    last = ops.flash_attention_flops(b // MESH[0], hq, m, s, d, d, causal)
    first = ops.flash_attention_flops(b // MESH[0], hq, m, m if causal else s, d, d, causal)
    assert causal == (last > first)
    ctx = ShardingCtx(mesh=mesh, mode="train")

    def forward(q, k, v):
        with use_ctx(ctx):
            return attention.chunked_attention(q, k, v, causal=causal)

    with torch.no_grad():
        fwd = trace_cost(forward, *_qkv(mesh, b, s, hq, hkv, d, d))
    assert fwd["flops_per_device"] == last

    # the gradient: the last shard's backward over its prefix, as traced on
    # one device's plain tensors at coordinate tp - 1
    def step(q, k, v):
        out = forward(q, k, v)
        return torch.autograd.grad(out.sum(), (q, k, v))

    leaves = [t.requires_grad_() for t in _qkv(mesh, b, s, hq, hkv, d, d)]
    both = trace_cost(step, *leaves)
    ql, kl, vl, dl = (torch.empty(shape, device="meta") for shape in (
        (b // 2, hq, m, d), (b // 2, hkv, s, d), (b // 2, hkv, s, d), (b // 2, hq, m, d)))
    bwd = trace_cost(lambda: attention.flash_rows_backward(
        ql, kl, vl, dl, torch.empty((b // 2, hq, m), device="meta"), dl, MESH[1] - 1, MESH[1],
        causal=causal, scale=d ** -0.5))
    assert both["flops_per_device"] == last + bwd["flops_per_device"]


def test_ce_rows_split_over_model_where_it_does_not_divide_the_vocabulary():
    """``lm.chunked_ce`` with a vocabulary of 250 (not a multiple of 4):
    each chunk's rows split over ``model``, so a device's unembedding
    product is its batch rows' ``S / 4`` rows; at 256 (a multiple) the
    vocabulary splits instead.  The same FLOPs either way, and the
    loss's count stays whole."""
    mesh = _mesh()
    b, s, d = 4, 64, 32
    for vocab in (250, 256):
        cfg = ModelConfig(name="ce", family="dense", num_layers=1, d_model=d, n_heads=1,
                          n_kv_heads=1, head_dim=d, d_ff=d, vocab=vocab,
                          remat="none").validate()
        x = _placed((b, s, d), mesh, "data")
        w = _placed((d, vocab), mesh, None, None)
        labels = sharding.distribute(torch.zeros((b, s), dtype=torch.long, device="meta"),
                                     NamedSharding(mesh, P("data")))

        def ce(x_, w_, y_):
            with use_ctx(ShardingCtx(mesh=mesh, mode="train")):
                return lm.chunked_ce(cfg, x_, w_, y_)

        out = trace_cost(ce, x, w, labels)
        assert out["flops_per_device"] == 2 * (b // 2) * s * d * vocab // 4
        loss, tok = out["out"]
        assert loss.shape == () and tok.shape == ()


# -- four processes (gloo): real values on the split ------------------------

#: the worker: chunked_attention, and three 1-layer LMs' loss and every
#: gradient (5 kv heads and a vocabulary of 50, neither divided by
#: ``model``; 4 kv heads, d_ff 64 and a vocabulary of 64, all divided, with
#: SwiGLU and with a parallel block's GELU), on DTensors of real values
#: over (data 1, model 4) and (data 2, model 2)
#: meshes of four ``gloo`` ranks, against the same calls on plain tensors;
#: rank 0 writes each result's relative L2 error as JSON
GLOO_WORKER = """
import dataclasses, json, socket, sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, port, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor, DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.ops import register_sharding_rules
    from repro_torch.models import attention, lm
    from repro_torch.models.common import init_params, specs_to_shardings
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import NamedSharding, ShardingCtx, use_ctx, logical_to_spec

    register_sharding_rules()
    res = {}
    for shape in ((1, 4), (2, 2)):
        dm = DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=("data", "model"))
        mesh = sharding.make_mesh_compat(shape, ("data", "model"), devices=["cpu"] * 4)
        ctx = ShardingCtx(mesh=mesh, mode="train")

        def place(t, axes):
            sh = NamedSharding(mesh, logical_to_spec(axes, tuple(t.shape), mesh, "train"))
            return distribute_tensor(t, dm, sharding.to_placements(sh))

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def rel(a, b):
            a, b = full(a).detach(), b.detach()
            return float((a - b).norm() / b.norm().clamp(min=1e-30))

        # attention alone, causal and not
        g = torch.Generator().manual_seed(3)
        q, k, v, do = (torch.randn(s, generator=g) for s in
                       ((2, 64, 15, 16), (2, 64, 5, 16), (2, 64, 5, 16), (2, 64, 15, 16)))
        for causal in (True, False):
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            out = attention.chunked_attention(*plain, causal=causal)
            want = [out] + list(torch.autograd.grad(out, plain, do))
            dts = [place(t, ("batch",)).requires_grad_() for t in (q, k, v)]
            with use_ctx(ctx), implicit_replication():
                dout = place(do, ("batch",))
                got_out = attention.chunked_attention(*dts, causal=causal)
                got = [got_out] + list(torch.autograd.grad(got_out, dts, dout))
            res[f"{shape} attention causal={causal}"] = {
                "rows": str(got_out.placements),
                "rel": [rel(a, b) for a, b in zip(got, want)]}
        # 1-layer LMs' loss and every gradient: 5 kv heads and a vocabulary 4
        # does not divide ("lm"); kv heads, d_ff and a vocabulary ``model``
        # divides, SwiGLU ("split"), and a parallel block's GELU MLP with tied
        # embeddings under the "dots" remat ("gelu"), so every weight product
        # runs split; and a Mamba2 layer ("ssm": the SSD's cumsum on each
        # device's shards) with a vocabulary of 51, which neither mesh's
        # ``model`` divides, so the embedding keeps its ZeRO-3 columns split
        # over ``data`` and gathers the ids
        from repro_torch.configs import get_config
        from repro_torch.launch.train import reduce_config

        base = ModelConfig(name="cp", family="dense", num_layers=1, d_model=32, n_heads=15,
                           n_kv_heads=5, head_dim=8, d_ff=64, vocab=50, remat="none",
                           dtype="float32")
        lms = {"lm": base,
               "split": dataclasses.replace(base, n_heads=8, n_kv_heads=4, vocab=64),
               "gelu": dataclasses.replace(base, n_heads=8, n_kv_heads=4, vocab=64,
                                           ffn_act="gelu", tie_embeddings=True,
                                           parallel_block=True, remat="dots"),
               "ssm": dataclasses.replace(reduce_config(get_config("mamba2-370m"), 8),
                                          num_layers=1, vocab=51, dtype="float32",
                                          remat="none")}
        for tag, cfg in lms.items():
            cfg = cfg.validate()
            specs = lm.model_specs(cfg)
            params = init_params(specs, torch.Generator().manual_seed(0), torch.float32, "cpu")
            shards = specs_to_shardings(specs, mesh, "train")
            tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g)
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            names, leaves = zip(*sorted(lm_leaves(params)))
            plain = [t.clone().requires_grad_() for t in leaves]
            loss, _ = lm.loss_fn(cfg, rebuild(params, names, plain), batch)
            want = [loss] + list(torch.autograd.grad(loss, plain, allow_unused=True))
            sh_leaves = dict(lm_leaves(shards))
            dts = [distribute_tensor(t.detach(), dm,
                                     sharding.to_placements(sh_leaves[n])).requires_grad_()
                   for n, t in zip(names, leaves)]
            with use_ctx(ctx), implicit_replication():
                b = {k_: place(t, ("batch", None)) for k_, t in batch.items()}
                got_loss, _ = lm.loss_fn(cfg, rebuild(params, names, dts), b, ctx)
                got = [got_loss] + list(torch.autograd.grad(got_loss, dts, allow_unused=True))
            # GELU leaves ``w_gate`` unused: its gradient is None on both sides
            assert [a is None for a in got] == [w is None for w in want], tag
            res[f"{shape} {tag}"] = {"rel": {n: rel(a, w) for n, a, w in
                                             zip(("loss",) + names, got, want) if w is not None}}
        decode(res, shape, dm, mesh, lms, g)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def decode(res, shape, dm, mesh, lms, g):
    '''One decode step against caches split on their sequence over
    ``model`` (the serve rules): a GQA layer at 5 kv heads (its 15 query
    heads whole on ``model``) and at 4 (its 8 split), an MLA layer (reduced
    MiniCPM3-4B, 5 heads), each against the same layer on plain tensors,
    the written caches too; one row's live keys end inside the second of
    four shards.  A cache split on its heads instead (a cross-attention's).  Then greedy ids: ``argmax_last`` on logits split on the
    vocabulary with ties planted across shards and within one, and a
    1-layer LM's serve step (vocabulary 64, split; 50, whole) against its
    plain step, exact.'''
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step, state_specs_for
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import blocks, lm, mla
    from repro_torch.models.common import init_params, specs_to_shardings
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import NamedSharding, ShardingCtx, use_ctx, logical_to_spec

    ctx = ShardingCtx(mesh=mesh, mode="serve")

    def place(t, axes):
        sh = NamedSharding(mesh, logical_to_spec(axes, tuple(t.shape), mesh, "serve"))
        return distribute_tensor(t, dm, sharding.to_placements(sh))

    def rel(a, b):
        a = a.full_tensor() if isinstance(a, DTensor) else a
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    b_, t_ = 2, 64
    clen = torch.tensor([21, 63])
    mla_cfg = dataclasses.replace(reduce_config(get_config("minicpm3-4b"), 8),
                                  dtype="float32").validate()
    layers = {"gqa5": lms["lm"].validate(), "gqa4": lms["split"].validate(), "mla": mla_cfg}
    for tag, cfg in layers.items():
        specs = mla.mla_specs(cfg, 1) if tag == "mla" else blocks.attn_specs(cfg, 1)
        p = {k: t[0] for k, t in init_params(specs, torch.Generator().manual_seed(5),
                                             torch.float32, "cpu").items()}
        if tag != "mla":          # peaked scores: each shard's max matters
            p["wq"], p["wk"] = p["wq"] * 4, p["wk"] * 4
        split_p = {k: place(t, specs[k].axes[1:]) for k, t in p.items()}
        x = torch.randn((b_, 1, cfg.d_model), generator=g)
        if tag == "mla":
            cache = {"c_kv": torch.randn((b_, t_, cfg.kv_lora), generator=g),
                     "k_rope": torch.randn((b_, t_, cfg.qk_rope_dim), generator=g)}
            axes, fn = ("batch", "cache_seq", None), mla.mla_decode
        else:
            cache = {n: torch.randn((b_, t_, cfg.n_kv_heads, cfg.head_dim), generator=g)
                     for n in ("k", "v")}
            axes, fn = ("batch", "cache_seq", "cache_heads", None), blocks.gqa_decode
        split_cache = {n: place(t.clone(), axes) for n, t in cache.items()}
        with torch.no_grad():
            want, _ = fn(p, cfg, x, cache, clen[:, None], clen)
            with use_ctx(ctx), implicit_replication():
                got, _ = fn(split_p, cfg, place(x, ("batch", None, None)), split_cache,
                            place(clen[:, None], ("batch", None)), place(clen, ("batch",)))
        res[f"{shape} decode {tag}"] = {
            "cache": str(next(iter(split_cache.values())).placements),
            "rel": [rel(got, want)] + [rel(split_cache[n], cache[n]) for n in cache]}

    # a cache split on its heads, whole on its sequence (a cross-attention's):
    # each device attends its own heads' block, with and without lengths
    from repro_torch.models import attention

    q = torch.randn((b_, 1, 8, 16), generator=g) * 4
    k, v = (torch.randn((b_, t_, 4, 16), generator=g) for _ in range(2))
    split = [place(t, ("batch", None, "cache_heads", None)) for t in (q, k, v)]
    for lengths in (None, clen):
        with torch.no_grad():
            want = attention.decode_attention(q, k, v, cache_len=lengths)
            with use_ctx(ctx), implicit_replication():
                got = attention.decode_attention(
                    *split, cache_len=None if lengths is None else place(lengths, ("batch",)))
        res[f"{shape} decode heads lengths={lengths is not None}"] = {
            "cache": str(split[1].placements), "rel": [rel(got, want)]}

    logits = torch.randn((4, 64), generator=g)
    logits[0, [5, 40]] = 9.0                 # a tie across shards
    logits[1, [20, 22, 50]] = 9.0            # within one shard and across
    logits[3] = 1.0                          # all tied: the first
    want = torch.argmax(logits, dim=-1)
    got = sharding.argmax_last(distribute_tensor(logits, dm, [Shard(0), Shard(1)]))
    ids = {"argmax": (got.full_tensor().tolist(), want.tolist())}
    for tag in ("split", "lm"):
        cfg = lms[tag].validate()
        specs = lm.model_specs(cfg)
        params = init_params(specs, torch.Generator().manual_seed(0), torch.float32, "cpu")
        sspecs = state_specs_for(cfg, b_, t_)
        state = {n: {k: torch.randn(s.shape, generator=g) for k, s in group.items()}
                 if isinstance(group, dict) else torch.randn(group.shape, generator=g)
                 for n, group in sspecs.items()}
        batch = {"token": torch.randint(0, cfg.vocab, (b_, 1), generator=g), "cache_len": clen}
        names, leaves = zip(*sorted(lm_leaves(params)))
        psh = dict(lm_leaves(specs_to_shardings(specs, mesh, "serve")))
        ssh = dict(lm_leaves(specs_to_shardings(sspecs, mesh, "serve")))
        split_params = rebuild(params, names, [
            distribute_tensor(t, dm, sharding.to_placements(psh[n])) for n, t in zip(names, leaves)])
        snames, sleaves = zip(*sorted(lm_leaves(state)))
        split_state = rebuild(state, snames, [
            distribute_tensor(t.clone(), dm, sharding.to_placements(ssh[n]))
            for n, t in zip(snames, sleaves)])
        tok, _ = make_serve_step(cfg)(params, state, batch)
        with implicit_replication():
            split_tok, _ = make_serve_step(cfg, ctx)(
                split_params, split_state,
                {"token": place(batch["token"], ("batch", None)), "cache_len": place(clen, ("batch",))})
        ids[f"serve {tag}"] = (split_tok.full_tensor().tolist(), tok.tolist())
    res[f"{shape} greedy"] = {"ids": ids, "rel": [0.0 if a == b else 1.0 for a, b in ids.values()]}


def lm_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += lm_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def rebuild(tree, names, values):
    out = {}
    for n, v in zip(names, values):
        d = out
        parts = n.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(port, sys.argv[1]), nprocs=4, join=True)
"""
#: relative L2 of a split result against the plain one (f32 sums reordered)
GLOO_REL_L2 = 1e-5


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """The worker's results, run once in a subprocess of four ranks."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    tmp = tmp_path_factory.mktemp("gloo")
    script = tmp / "worker.py"
    script.write_text(GLOO_WORKER)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = tmp / "out.json"
    run = subprocess.run([sys.executable, str(script), str(out)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(out.read_text())


def test_split_attention_and_lm_on_four_gloo_ranks_equal_plain(gloo_results):
    """On real ranks, where each shard computes its own rows (its coordinate
    from the device mesh) and the gradients' partial sums are reduced, the
    attention's output and gradients, and each 1-layer LM's loss and every
    parameter's gradient (the weight products' backward on each device's
    shards, ``sharding.matmul``; a Mamba2 layer's SSD ``cumsum`` and an
    embedding with whole rows on each device's shards), equal the plain
    tensors' within
    ``GLOO_REL_L2``; the output is split on its rows over ``model``."""
    res = {k: v for k, v in gloo_results.items() if "decode" not in k and "greedy" not in k}
    assert len(res) == 12
    for name, row in res.items():
        rels = row["rel"].values() if isinstance(row["rel"], dict) else row["rel"]
        assert max(rels) <= GLOO_REL_L2, (name, row)
        if "attention" in name:
            assert row["rows"].endswith("Shard(dim=1))"), (name, row)


def test_sequence_split_decode_on_four_gloo_ranks_equals_plain(gloo_results):
    """On real ranks, a decode step against a cache split on its sequence
    over ``model`` (each shard's products over its block, the softmax's
    max and sum all-reduced as rows, the second product a partial sum):
    the GQA and MLA layers' outputs and written caches equal the plain
    tensors' within ``GLOO_REL_L2``, as does the decode against a cache
    split on its heads (each device its heads' block); the greedy ids are
    the plain ones exactly, ties across shards resolved to the first
    index."""
    decode = {k: v for k, v in gloo_results.items() if "decode" in k}
    assert len(decode) == 10
    for name, row in decode.items():
        assert max(row["rel"]) <= GLOO_REL_L2, (name, row)
        split_on = "Shard(dim=2))" if "heads" in name else "Shard(dim=1))"
        assert row["cache"].endswith(split_on), (name, row)
    greedy = {k: v for k, v in gloo_results.items() if "greedy" in k}
    assert len(greedy) == 2
    for name, row in greedy.items():
        for tag, (got, want) in row["ids"].items():
            assert got == want, (name, tag)
        assert row["ids"]["argmax"][1] == [5, 20, row["ids"]["argmax"][1][2], 0]
