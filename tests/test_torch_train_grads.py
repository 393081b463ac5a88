"""The port's loss, every parameter's gradient and five train steps
against the JAX package, per LM family (dense tied and untied, SSM,
hybrid), in float32 on the CPU.

Random-weight attention is near argmax (the init's fan-in of ``wq``/``wk``
is a head count), which makes its gradients amplify rounding; as in
``chip_smoke.py``'s card-vs-CPU check, ``wq`` and ``wk`` are rescaled on
both sides to the fan-in of the d_model they contract, so scores have std
about 1.  The SSM leaves the init sets to 0 or 1 get seeded values
(``A_log`` around -2, so that no chunk's decay overflows float32: there
the JAX package's SSD gradient is NaN and the port's is not, see
``test_torch_train.py::test_ssd_grads_stay_finite_where_the_decay_overflows``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.tokens import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import flatten, leaves  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import (  # noqa: E402,F401
    GRAD, _arch, _f32, _jax_opt_cfg, _t, few_threads, np_params)


def _seeded_tree(jcfg, cfg, seed):
    """Parameters of the JAX layout as numpy (``np_params``), attention
    rescaled and the SSM
    leaves the init leaves at 0 or 1 seeded (see the module docstring)."""
    tree = np_params(jcfg, seed)
    rng = np.random.default_rng(seed + 1000)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "A_log":
                node[k] = _f32(rng.normal(-2, 0.3, v.shape))
            elif k == "dt_bias":
                node[k] = _f32(rng.normal(0, 0.5, v.shape))
            elif k == "D":
                node[k] = _f32(rng.normal(1, 0.3, v.shape))
            elif k.startswith("conv_") and k.endswith("_b") or k == "shared_lora_b":
                node[k] = _f32(rng.normal(0, 0.2, v.shape))

    walk(tree)
    attn = {"dense": "layers", "hybrid": "shared_attn"}.get(cfg.family)
    if attn:
        tree[attn]["wq"] *= (cfg.n_heads / cfg.d_model) ** 0.5
        tree[attn]["wk"] *= (cfg.n_kv_heads / cfg.d_model) ** 0.5
    return tree


def _batch(seed, vocab, b=2, s=128):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32), "labels": labels}


#: (arch, reduce factor, overrides): the dense family tied (SmolLM) and
#: untied, the SSM (Mamba2, 2 chunks of 64 per sequence) and the hybrid
#: at --reduce 4 (Zamba2: a group of 6 under the shared block, a tail of 3)
FAMILIES = [("smollm-360m", 8, dict(num_layers=2)),
            ("smollm-360m", 8, dict(num_layers=2, tie_embeddings=False)),
            ("mamba2-370m", 8, dict(num_layers=2)),
            ("zamba2-1.2b", 4, {})]
FAMILY_IDS = ["dense-tied", "dense-untied", "ssm", "hybrid"]


def _port_loss_and_grads(cfg, tree, batch):
    p = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    flat, unflatten = flatten(p)
    xs = [x.requires_grad_() for x in flat]
    loss, metrics = lm.loss_fn(cfg, unflatten(xs), {k: _t(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("arch,factor,over", FAMILIES, ids=FAMILY_IDS)
def test_loss_and_grads_match_jax(arch, factor, over):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX ``loss_fn``; the port with
    ``remat="dots"`` (its checkpointed regions recompute in the backward)
    gives the loss of ``remat="none"`` exactly and its gradients to rtol
    1e-6 (the recomputed regions add their input gradients in another
    order)."""
    jcfg, cfg = _arch(arch, factor, remat="none", **over)
    tree = _seeded_tree(jcfg, cfg, seed=1)
    batch = _batch(2, cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, jb), has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    loss, metrics, grads = _port_loss_and_grads(cfg, tree, batch)
    assert set(metrics) == set(wm) == {"ce", "moe_aux", "tokens"}
    assert int(metrics["tokens"]) == int(wm["tokens"]) == 2 * 128 - 5
    assert float(metrics["moe_aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(wm["ce"]), rtol=1e-6)
    names = [k for k, _ in common.spec_leaves(lm.model_specs(cfg))]
    for name, g, w in zip(names, grads, jax.tree.leaves(want_g), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD, err_msg=name)
    dots = dataclasses.replace(cfg, remat="dots")
    loss2, _, grads2 = _port_loss_and_grads(dots, tree, batch)
    assert torch.equal(loss, loss2)
    for name, a, b in zip(names, grads, grads2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("arch,factor,over", [FAMILIES[0], FAMILIES[2]],
                         ids=["dense", "ssm"])
def test_train_steps_match_jax_on_jax_batches(arch, factor, over):
    """Five ``make_train_step`` steps against the JAX package's jitted step
    from the same parameters on the JAX pipeline's batches: the loss
    stream at rtol 1e-4 (it reads ~1e-6).  The parameters after Adam are
    held looser: Adam's first update is ``~lr sign(g)`` for every element,
    so an element whose gradient sits at rounding level in both packages
    may move by +lr in one and -lr in the other; they are held to
    ``2 lr`` per step absolute, and most (99.9 %) elements to 1e-5."""
    jcfg, cfg = _arch(arch, factor, remat="dots", **over)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    tree = _seeded_tree(jcfg, cfg, seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jax_adamw.init_opt_state(jp, _jax_opt_cfg(opt_cfg))
    jstep = jax.jit(jax_steps.make_train_step(jcfg, _jax_opt_cfg(opt_cfg)))
    p = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    st = adamw.init_opt_state(p, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg)
    pipe = JaxTokenPipeline(JaxDataConfig(cfg.vocab, 64, 2, seed=4))
    got, want = [], []
    for i in range(5):
        jb = pipe.global_batch(i)
        jp, jst, jm = jstep(jp, jst, jb)
        p, st, m = step(p, st, {k: _t(v) for k, v in jb.items()})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-3)
    diffs = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                            for a, b in zip(leaves(p), jax.tree.leaves(jp))])
    assert diffs.max() <= 2 * opt_cfg.lr * 5
    assert (diffs > 1e-5).mean() < 1e-3
