"""The port's expert-parallel MoE branch against the JAX package's
``shard_map`` branch.

A subprocess with 8 forced CPU devices runs the JAX ``moe_ffn`` under
``shard_map`` on ``(1, 4)``, ``(2, 4)`` and ``(2, 2)`` ``("data",
"model")`` meshes and saves its inputs, outputs and each (batch block,
model shard)'s routing decisions (the lines of ``_moe_local`` from the
logits to ``slot_idx``, with the shard's first expert) to an npz.  The
port runs the same inputs over a ``Mesh`` of ``cpu`` entries: each block
routes with the capacity of its own token count, so on a mesh with two
batch blocks the result is the sharded one, not the one-shard result.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.parallel.sharding import ShardingCtx, make_mesh_compat, use_ctx  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the JAX run's meshes, (data, model)
MESHES = ((1, 4), (2, 4), (2, 2))
CFG = dict(name="t", family="moe", num_layers=1, d_model=16, vocab=8, moe=True,
           n_experts=6, top_k=2, moe_d_ff=8, n_shared_experts=1, shared_d_ff=12,
           remat="none")

JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ModelConfig
    from repro.models import moe
    from repro.parallel.sharding import ShardingCtx, make_mesh_compat

    cfg = ModelConfig(**CFG).validate()
    rng = np.random.default_rng(11)
    e, d, f = moe.padded_experts(cfg), cfg.d_model, cfg.moe_d_ff
    p = dict(router=rng.normal(0, 1, (d, cfg.n_experts)),
             w_gate=rng.normal(0, d ** -0.5, (e, d, f)),
             w_up=rng.normal(0, d ** -0.5, (e, d, f)),
             w_down=rng.normal(0, f ** -0.5, (e, f, d)),
             ws_gate=rng.normal(0, d ** -0.5, (d, 12)),
             ws_up=rng.normal(0, d ** -0.5, (d, 12)),
             ws_down=rng.normal(0, 12 ** -0.5, (12, d)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (4, 8, d)).astype(np.float32)
    out = {"x": x, **{"p_" + k: v for k, v in p.items()}}
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def routing(xb, e0, el):
        # repro/models/moe.py _moe_local, the logits to slot_idx
        logits = moe.dense(xb, jp["router"]).astype(jnp.float32)
        logits = jnp.pad(logits, ((0, 0), (0, e - cfg.n_experts)), constant_values=-1e30)
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        cap = moe._capacity(xb.shape[0], cfg)
        counts = jnp.zeros((el,), jnp.int32)
        keeps, slots = [], []
        for slot in range(cfg.top_k):
            lid = ids[:, slot] - e0
            own = (lid >= 0) & (lid < el)
            lid = jnp.clip(lid, 0, el - 1)
            oh = jax.nn.one_hot(lid, el, dtype=jnp.int32) * own[:, None]
            pos = jnp.sum((counts[None, :] + jnp.cumsum(oh, axis=0) - oh) * oh, axis=1)
            counts = counts + oh.sum(axis=0)
            keep = own & (pos < cap)
            keeps.append(keep)
            slots.append(jnp.where(keep, lid * cap + pos, el * cap))
        return np.asarray(ids), np.stack(keeps, 1), np.stack(slots, 1)

    for data, model in MESHES:
        mesh = make_mesh_compat((data, model), ("data", "model"),
                                devices=jax.devices()[:data * model])
        y, aux = jax.jit(lambda p_, x_: moe.moe_ffn(ShardingCtx(mesh=mesh), cfg, p_, x_))(
            jp, jnp.asarray(x))
        tag = f"{data}x{model}"
        out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
        bl, el = x.shape[0] // data, e // model
        for j in range(data):
            xb = jnp.asarray(x[j * bl:(j + 1) * bl].reshape(-1, d))
            for k in range(model):
                ids, keep, slot = routing(xb, k * el, el)
                out[f"ids_{tag}_{j}_{k}"] = ids
                out[f"keep_{tag}_{j}_{k}"] = keep
                out[f"slot_{tag}_{j}_{k}"] = slot
    np.savez(sys.argv[1], **out)
    print("OK")
""").replace("CFG", repr(CFG)).replace("MESHES", repr(MESHES))


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "ep.npz"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", JAX_EP, str(path)], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert "OK" in run.stdout, run.stdout + run.stderr
    return dict(np.load(path))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(ref):
    cfg = ModelConfig(**CFG).validate()
    p = {k[2:]: torch.from_numpy(v) for k, v in ref.items() if k.startswith("p_")}
    return cfg, p, torch.from_numpy(ref["x"])


def _mesh(data, model):
    return make_mesh_compat((data, model), ("data", "model"), devices=["cpu"] * (data * model))


@pytest.mark.parametrize("data,model", MESHES)
def test_expert_parallel_matches_jax_shard_map(jax_ep, data, model):
    cfg, p, x = _port(jax_ep)
    tag = f"{data}x{model}"
    y, aux = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=_mesh(data, model)))
    np.testing.assert_allclose(y.numpy(), jax_ep["y_" + tag], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.numpy(), jax_ep["aux_" + tag], rtol=1e-6)
    # each (block, shard)'s decisions, as the branch makes them
    e_pad = moe.padded_experts(cfg)
    bl, el = x.shape[0] // data, e_pad // model
    dropped = 0
    for j in range(data):
        xb = x[j * bl:(j + 1) * bl].reshape(-1, cfg.d_model)
        _, _, ids = moe.route(xb, p["router"], cfg, e_pad)
        for k in range(model):
            keep, slot = moe.dispatch(ids, el, k * el, moe._capacity(xb.shape[0], cfg))
            np.testing.assert_array_equal(ids.numpy(), jax_ep[f"ids_{tag}_{j}_{k}"])
            np.testing.assert_array_equal(keep.numpy(), jax_ep[f"keep_{tag}_{j}_{k}"])
            np.testing.assert_array_equal(slot.numpy(), jax_ep[f"slot_{tag}_{j}_{k}"])
        owned = sum(jax_ep[f"keep_{tag}_{j}_{k}"].sum() for k in range(model))
        dropped += ids.numel() - owned
    if data == 1:
        assert dropped > 0                  # capacity drops are exercised


def test_two_batch_blocks_differ_from_one_shard(jax_ep):
    """The trap: a mesh with two batch blocks routes each with its own
    capacity, and the port follows JAX there, not the one-shard call."""
    cfg, p, x = _port(jax_ep)
    y1, aux1 = moe.moe_ffn(cfg, p, x)
    assert not np.allclose(y1.numpy(), jax_ep["y_2x4"], rtol=1e-3)
    assert abs(float(aux1) - float(jax_ep["aux_2x4"])) > 1e-3
    # one batch block over the model axis is the one-shard call
    y, aux = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=_mesh(1, 4)))
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(aux.numpy(), aux1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(y1.numpy(), jax_ep["y_1x4"], rtol=1e-5, atol=1e-6)


def test_branch_runs_each_shard_on_its_entry(jax_ep, monkeypatch):
    """One ``_moe_local`` call a model shard, its blocks together where they
    share a device, its experts' slice and first expert id; the ambient
    context picks the branch when none is passed."""
    cfg, p, x = _port(jax_ep)
    calls = []
    real = moe._moe_local

    def spy(xs, router, wg, *rest, e0, n_shards, **kw):
        calls.append((tuple(xs.shape), tuple(wg.shape), e0, n_shards))
        return real(xs, router, wg, *rest, e0=e0, n_shards=n_shards, **kw)

    monkeypatch.setattr(moe, "_moe_local", spy)
    with use_ctx(ShardingCtx(mesh=_mesh(2, 4))):
        moe.moe_ffn(cfg, p, x)
    assert calls == [((2, 16, 16), (4, 16, 8), 4 * k, 4) for k in range(4)]


def test_refusals_and_the_mesh_less_branch(jax_ep):
    cfg, p, x = _port(jax_ep)
    with pytest.raises(ValueError, match="does not split"):
        moe.moe_ffn(cfg, p, x[:3], ShardingCtx(mesh=_mesh(2, 4)))
    # 16 padded experts over a model axis of 3: the mesh-less branch
    assert not moe.expert_parallel(_mesh(2, 3), cfg)
    y, aux = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=_mesh(2, 3)))
    y1, aux1 = moe.moe_ffn(cfg, p, x)
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
    assert not moe.expert_parallel(_mesh(4, 1), cfg)


def test_train_step_on_a_model_mesh_equals_unsharded():
    """Loss and every gradient of a reduced Qwen1.5-MoE train step at 2
    layers, experts over a (1, 4) mesh, against the unsharded step: rtol
    1e-5, and atol 1e-5 of the leaf's largest gradient (a shard's input
    gradients reach a token's sum in another order, so an element near 0
    carries the leaf's rounding, not its own)."""
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-moe-a2.7b"), 8),
                              num_layers=2, dtype="float32")
    assert moe.expert_parallel(_mesh(1, 4), cfg)
    params = init_params(steps.param_specs_for(cfg), torch.Generator().manual_seed(3),
                         torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    loss_fn = steps.loss_for(cfg)

    def loss_and_grads(ctx):
        from repro_torch._tree import flatten
        flat, unflatten = flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in flat]
        with use_ctx(ctx):
            loss, metrics = loss_fn(cfg, unflatten(leaves), batch)
        return loss, metrics, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                  materialize_grads=True)

    loss0, m0, g0 = loss_and_grads(ShardingCtx())
    loss1, m1, g1 = loss_and_grads(ShardingCtx(mesh=_mesh(1, 4)))
    np.testing.assert_allclose(float(loss1.detach()), float(loss0.detach()), rtol=1e-5)
    np.testing.assert_allclose(float(m1["moe_aux"].detach()), float(m0["moe_aux"].detach()),
                               rtol=1e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    # the step factory binds its context for the whole step
    opt_cfg = AdamWConfig()
    opt = init_opt_state(params, opt_cfg)
    p0, _, s0 = steps.make_train_step(cfg, opt_cfg)(params, opt, batch)
    p1, _, s1 = steps.make_train_step(cfg, opt_cfg, ShardingCtx(mesh=_mesh(1, 4)))(
        params, opt, batch)
    np.testing.assert_allclose(float(s1["loss"]), float(s0["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(s1["grad_norm"]), float(s0["grad_norm"]), rtol=1e-5)
