"""The port's entries take the JAX package's parameters in its positions.

The LM and enc-dec entries (``lm.backbone``, ``forward``, ``loss_fn``,
``decode_step``; ``encdec.encode``, ``decode_train``, ``encdec_loss``,
``encdec_decode_step``) take a ``ShardingCtx`` where the JAX package's do,
positional or by keyword, and bind it for the call (``None``: the ambient
context); ``kernels.ref.power_sim_ref`` takes ``(u_th, p_idle, p_max, r, *,
peak_tflops, dt_seconds)``.  Each is called with JAX's arguments both ways
and without the context, with equal outputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import encdec, lm, moe  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    ShardingCtx,
    current_ctx,
    make_mesh_compat,
    use_ctx,
)


def _cfg(arch, layers=2):
    return dataclasses.replace(reduce_config(get_config(arch), 8), num_layers=layers,
                               dtype="float32")


def _params(cfg, seed=0):
    return init_params(steps.param_specs_for(cfg), torch.Generator().manual_seed(seed),
                       torch.float32, device="cpu")


def _tokens(cfg, b=2, s=32, seed=1):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab, (b, s), generator=gen, dtype=torch.int32)
    return {"tokens": t, "labels": torch.roll(t, -1, dims=1)}


def _model_mesh():
    """Four experts' shards on CPU entries: the MoE's expert-parallel branch."""
    return ShardingCtx(mesh=make_mesh_compat((1, 4), ("data", "model"),
                                             devices=["cpu"] * 4))


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert torch.equal(a, b)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.fixture
def shards(monkeypatch):
    """The shard count of every ``moe._moe_local`` call."""
    seen = []
    real = moe._moe_local

    def spy(*args, n_shards, **kw):
        seen.append(n_shards)
        return real(*args, n_shards=n_shards, **kw)

    monkeypatch.setattr(moe, "_moe_local", spy)
    return seen


def _three_ways(fn, args, ctx, name):
    """``fn(*args)``, ``fn(*args, ctx)`` and ``fn(*args, ctx=ctx)``."""
    return fn(*args), fn(*args, ctx), fn(*args, **{name: ctx})


@pytest.mark.parametrize("entry", ["backbone", "forward", "loss_fn"])
def test_lm_entries_take_and_bind_jax_ctx(entry, shards):
    cfg = _cfg("qwen2-moe-a2.7b")
    p, batch = _params(cfg), _tokens(cfg)
    ctx = _model_mesh()
    assert moe.expert_parallel(ctx.mesh, cfg)
    plain, pos, kw = _three_ways(getattr(lm, entry), (cfg, p, batch), ctx, "ctx")
    # one mesh-less call a MoE layer, then the positional and the keyword
    # calls each split every layer's experts over the four model shards (a
    # call a shard)
    layers = cfg.num_layers - cfg.first_dense_layers
    assert shards == [1] * layers + [4] * (2 * layers * 4)
    _equal(pos, kw)
    with use_ctx(ctx):
        _equal(getattr(lm, entry)(cfg, p, batch), pos)
    # the experts' shards sum a token's output in another order
    for a, b in zip(torch.utils._pytree.tree_leaves(pos),
                    torch.utils._pytree.tree_leaves(plain)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5,
                                   atol=1e-6)
    if entry == "loss_fn":
        # aux_weight stays a float after ctx, not the context
        total = lm.loss_fn(cfg, p, batch, None, 0.5)[0]
        ce, aux = plain[1]["ce"], plain[1]["moe_aux"]
        torch.testing.assert_close(total, ce + 0.5 * aux)
        _equal(lm.loss_fn(cfg, p, batch, aux_weight=0.5), lm.loss_fn(cfg, p, batch, None, 0.5))


def test_decode_step_takes_and_binds_jax_ctx(shards):
    cfg = _cfg("qwen2-moe-a2.7b")
    p = _params(cfg)
    state = init_params(lm.decode_state_specs(cfg, 2, 16), torch.Generator().manual_seed(2),
                        torch.float32, device="cpu")
    batch = {"token": torch.tensor([[3], [5]], dtype=torch.int32),
             "cache_len": torch.tensor([4, 7], dtype=torch.int32)}
    ctx = _model_mesh()
    outs = [lm.decode_step(cfg, p, _clone(state), batch),
            lm.decode_step(cfg, p, _clone(state), batch, ctx),
            lm.decode_step(cfg, p, _clone(state), batch, ctx=ctx)]
    layers = cfg.num_layers - cfg.first_dense_layers
    assert shards == [1] * layers + [4] * (2 * layers * 4)
    _equal(outs[1], outs[2])
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-6)


def test_encdec_entries_take_and_bind_jax_ctx(monkeypatch):
    cfg = _cfg("seamless-m4t-medium")
    cfg = dataclasses.replace(cfg, enc_layers=2, dec_layers=2)
    p = _params(cfg)
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn((2, 16, cfg.d_model), generator=gen) * 0.1
    batch = {**_tokens(cfg, s=16), "frames": frames}
    ctx = ShardingCtx(mode="serve")
    bound = []
    real = encdec._self_attn

    def spy(*args, **kw):
        bound.append(current_ctx())
        return real(*args, **kw)

    monkeypatch.setattr(encdec, "_self_attn", spy)
    enc = _three_ways(encdec.encode, (cfg, p, frames), ctx, "ctx")
    dec = _three_ways(encdec.decode_train, (cfg, p, batch["tokens"], enc[0]), ctx, "ctx")
    loss = _three_ways(encdec.encdec_loss, (cfg, p, batch), ctx, "ctx")
    for outs in (enc, dec, loss):
        _equal(outs[0], outs[1])
        _equal(outs[0], outs[2])
    # each call without a ctx reads the ambient one, each call with it binds it
    n = cfg.enc_layers
    assert [c is ctx for c in bound[:3 * n]] == [False] * n + [True] * (2 * n)
    state = init_params(encdec.encdec_state_specs(cfg, 2, 16),
                        torch.Generator().manual_seed(6), torch.float32, device="cpu")
    tb = {"token": torch.tensor([[3], [5]], dtype=torch.int32),
          "cache_len": torch.tensor([2, 9], dtype=torch.int32)}
    outs = [encdec.encdec_decode_step(cfg, p, _clone(state), tb),
            encdec.encdec_decode_step(cfg, p, _clone(state), tb, ctx),
            encdec.encdec_decode_step(cfg, p, _clone(state), tb, ctx=ctx)]
    _equal(outs[0], outs[1])
    _equal(outs[0], outs[2])


def test_power_sim_ref_takes_jax_arguments():
    rng = np.random.default_rng(7)
    u = rng.uniform(-0.1, 1.1, (97, 33)).astype(np.float32)
    args, kw = (71.0, 342.0, 2.6), dict(peak_tflops=137.0, dt_seconds=300.0)
    want = jax_ref.power_sim_ref(jnp.asarray(u), *args, **kw)
    pos = ref.power_sim_ref(torch.from_numpy(u), *args, **kw)
    by_kw = ref.power_sim_ref(torch.from_numpy(u), p_idle=71.0, p_max=342.0, r=2.6, **kw)
    wrapped = ops.power_sim(torch.from_numpy(u), p_idle=71.0, p_max=342.0, r=2.6, **kw)
    for a, b, c, w in zip(pos, by_kw, wrapped, want):
        assert torch.equal(a, b) and torch.equal(a, c)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5)
    # a 0-d tensor for a parameter, as JAX's ``float | Array``
    again = ref.power_sim_ref(torch.from_numpy(u), torch.tensor(71.0), 342.0,
                              torch.tensor(2.6), **kw)
    _equal(list(again), list(pos))
