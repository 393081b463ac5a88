"""Training of the MoE, MLA, StableLM, Command R+, VLM and enc-dec
families against the JAX package, in float32 on the CPU.

Each arch goes through ``reduce_config(..., 8)`` cut to 2 layers
(DeepSeek-V2-Lite: its dense layer 0 and one MoE layer; Seamless: 2
encoder and 2 decoder layers), with the stub frontend's inputs as
``launch/train.main`` builds them (``train.frontend_inputs``): the port's
``loss_for`` and every parameter's gradient against ``jax.value_and_grad``
of the JAX ``loss_for``; three train steps on JAX's batches; gradient
accumulation; the launcher through a crash; the flash backward at
distinct QK/V head dims and ``layer_norm``'s gradient.  Query and key
projections are rescaled on both sides (``test_torch_lm.rescale_qk``:
random-weight attention is near argmax).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import flatten, leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.train import frontend_inputs, reduce_config  # noqa: E402
from repro_torch.models import attention, common, encdec, lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_lm import np_spec_params, rescale_qk  # noqa: E402
from test_torch_train import GRAD, _jax_opt_cfg, _t, few_threads  # noqa: E402,F401

#: the seven families: arch -> config overrides beyond f32 and 2 layers.
#: The VLM keeps 16 of the reduced config's 64 patches, so that text rows
#: (and the token embedding's gradient) remain in a 64-token sequence
ARCHS = {"qwen2-moe-a2.7b": {}, "deepseek-v2-lite-16b": {}, "minicpm3-4b": {},
         "stablelm-3b": {}, "command-r-plus-104b": {},
         "qwen2-vl-7b": dict(num_patches=16), "seamless-m4t-medium": {}}
B, S = 2, 64


def _configs(arch, **over):
    """``(jax config, port config)``: ``arch`` through ``reduce_config(...,
    8)``, float32, 2 layers (an enc-dec's encoder and decoder each), no
    remat unless ``over`` says otherwise."""
    full = get_config(arch)
    depth = (dict(enc_layers=2, dec_layers=2) if full.family == "encdec"
             else dict(num_layers=2))
    kw = dict(dtype="float32", remat="none", **depth, **ARCHS[arch])
    kw.update(over)
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch), 8), **kw)
    cfg = dataclasses.replace(reduce_config(full, 8), **kw)
    return jcfg.validate(), cfg.validate()


def _tree(jcfg, seed):
    """The JAX layout's parameters as numpy, query/key projections rescaled."""
    return rescale_qk(np_spec_params(jax_steps.param_specs_for(jcfg), seed))


def _port_params(cfg, tree):
    to_port = (convert.encdec_params_from_numpy if cfg.family == "encdec"
               else convert.lm_params_from_numpy)
    return to_port(tree, cfg, device="cpu")


def _frontend(cfg, b, s, seed, varied=False):
    """The frontend's inputs as numpy, as ``train.main`` builds them; with
    ``varied`` the enc-dec's frames are drawn at random (``train.main``'s
    are all alike, so its encoder self-attention and the cross-attention
    are uniform and their queries' and keys' gradients vanish) and the
    VLM's patches sit on a 4 x 4 grid of M-RoPE positions (t 0, h and w
    the grid's), the text after from the grid's side on in all three
    streams."""
    out = {k: v.numpy() for k, v in frontend_inputs(cfg, b, s, "cpu").items()}
    if varied and cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        out["frames"] = rng.normal(0, 1, out["frames"].shape).astype(np.float32)
    if varied and cfg.family == "vlm":
        n, side = cfg.num_patches, 4
        g, text = np.arange(n), side + np.arange(s - n)
        pos = np.stack([np.r_[np.zeros(n, int), text], np.r_[g // side, text],
                        np.r_[g % side, text]])
        out["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32))
    return out


def _batch(cfg, seed, b=B, s=S, varied=False):
    """Numpy ``tokens``/``labels`` (5 labels ignored) and ``_frontend``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": labels, **_frontend(cfg, b, s, seed + 1, varied)}


def _port_loss_and_grads(cfg, tree, batch):
    flat, unflatten = flatten(_port_params(cfg, tree))
    xs = [x.requires_grad_() for x in flat]
    loss, metrics = steps.loss_for(cfg)(cfg, unflatten(xs), {k: _t(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, xs)


VARIED = ["qwen2-vl-7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch,varied", [(a, False) for a in ARCHS] + [(a, True) for a in VARIED],
                         ids=list(ARCHS) + [f"{a}-varied" for a in VARIED])
def test_loss_and_grads_match_jax(arch, varied):
    """``loss_for(cfg)`` and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX ``loss_for``: the loss, ``ce``,
    ``moe_aux`` and ``tokens`` at rtol 1e-6, the gradients at ``GRAD``;
    the MoE aux non-zero in the MoE families.  With ``remat="dots"`` the
    port gives ``remat="none"``'s loss exactly and its gradients to rtol
    1e-6 (the recomputed regions add their input gradients in another
    order).  The VLM and the enc-dec run again with ``_frontend``'s varied
    inputs."""
    jcfg, cfg = _configs(arch)
    tree = _tree(jcfg, seed=1)
    batch = _batch(cfg, 2, varied=varied)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.loss_for(jcfg)(jcfg, p, jb), has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    loss, metrics, grads = _port_loss_and_grads(cfg, tree, batch)
    assert set(metrics) == set(wm) == {"ce", "moe_aux", "tokens"}
    assert int(metrics["tokens"]) == int(wm["tokens"]) == B * S - 5
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]), rtol=1e-6)
    assert (float(metrics["moe_aux"].detach()) > 0) == cfg.moe
    names = [k for k, _ in common.spec_leaves(steps.param_specs_for(cfg))]
    for name, g, w in zip(names, grads, jax.tree.leaves(want_g), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD, err_msg=name)
    dots = dataclasses.replace(cfg, remat="dots")
    loss2, _, grads2 = _port_loss_and_grads(dots, tree, batch)
    assert torch.equal(loss, loss2)
    for name, a, b in zip(names, grads, grads2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-9, err_msg=name)


def _close_params(p, jp, lr, n_steps):
    """Parameters after Adam, as ``test_torch_train_grads`` holds them: an
    element whose gradient sits at rounding level may move +lr in one
    package and -lr in the other, so within ``2 lr`` a step, and 99.9 % of
    them within 1e-5."""
    diffs = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                            for a, b in zip(leaves(p), jax.tree.leaves(jp), strict=True)])
    assert diffs.max() <= 2 * lr * n_steps
    assert (diffs > 1e-5).mean() < 1e-3


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b", "qwen2-moe-a2.7b"])
def test_train_steps_match_jax_on_jax_batches(arch):
    """Three ``make_train_step`` steps against the JAX package's jitted step
    from the same parameters on the JAX pipeline's batches (plus the
    frontend's varied inputs, ``_frontend``: with ``train.main``'s alike
    frames a third of the enc-dec's attention leaves get rounding-level
    gradients, which Adam moves by +-lr at random): the loss stream at
    rtol 1e-4, grad norm and lr at 1e-3, the parameters as
    ``_close_params``."""
    jcfg, cfg = _configs(arch, remat="dots")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    tree = _tree(jcfg, seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jax_adamw.init_opt_state(jp, _jax_opt_cfg(opt_cfg))
    jstep = jax.jit(jax_steps.make_train_step(jcfg, _jax_opt_cfg(opt_cfg)))
    p = _port_params(cfg, tree)
    st = adamw.init_opt_state(p, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg)
    pipe = JaxTokenPipeline(JaxDataConfig(cfg.vocab, S, B, seed=4))
    extra = _frontend(cfg, B, S, 5, varied=True)
    got, want = [], []
    for i in range(3):
        jb = {**pipe.global_batch(i), **{k: jnp.asarray(v) for k, v in extra.items()}}
        jp, jst, jm = jstep(jp, jst, jb)
        p, st, m = step(p, st, {k: _t(v) for k, v in jb.items()})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-3)
    _close_params(p, jp, opt_cfg.lr, 3)


def test_jax_train_state_carries_across_for_encdec():
    """A JAX enc-dec job state after one step (parameters through
    ``encdec_params_from_numpy``, the optimizer state through
    ``opt_state_from_numpy``) continues in the port: its next step's loss,
    grad norm and lr equal the JAX package's next step's (rtol 1e-5), and
    the step counter carries."""
    jcfg, cfg = _configs("seamless-m4t-medium")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    jp = jax.tree.map(jnp.asarray, _tree(jcfg, seed=13))
    jst = jax_adamw.init_opt_state(jp, _jax_opt_cfg(opt_cfg))
    jstep = jax.jit(jax_steps.make_train_step(jcfg, _jax_opt_cfg(opt_cfg)))
    batches = [_batch(cfg, 14 + i, s=32, varied=True) for i in range(2)]
    jp, jst, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batches[0].items()})
    p = convert.encdec_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    st = convert.opt_state_from_numpy(jax.tree.map(np.asarray, tuple(jst)), p, device="cpu")
    assert int(st.step) == 1
    _, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batches[1].items()})
    _, st, m = steps.make_train_step(cfg, opt_cfg)(p, st, {k: _t(v) for k, v in batches[1].items()})
    assert int(st.step) == int(jst.step) == 2
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)


def test_moe_grad_accum_matches_jax():
    """MoE with ``grad_accum=2``: capacity is reckoned per microbatch, so
    the drops differ from the full batch's; held against the JAX
    package's ``grad_accum=2`` (its ``lax.scan``): loss at rtol 1e-5,
    grad norm at 1e-4, the accumulating path's metrics, the parameters
    as ``_close_params``."""
    jcfg, cfg = _configs("deepseek-v2-lite-16b")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    tree = _tree(jcfg, seed=5)
    batch = _batch(cfg, 6, b=4, s=32)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jax_adamw.init_opt_state(jp, _jax_opt_cfg(opt_cfg))
    jp, _, jm = jax.jit(jax_steps.make_train_step(jcfg, _jax_opt_cfg(opt_cfg), grad_accum=2))(
        jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
    p = _port_params(cfg, tree)
    p, _, m = steps.make_train_step(cfg, opt_cfg, grad_accum=2)(
        p, adamw.init_opt_state(p, opt_cfg), {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["ce"]) == float(m["loss"]) and int(m["tokens"]) == int(jm["tokens"]) == 0
    _close_params(p, jp, opt_cfg.lr, 1)


def test_vlm_grad_accum_matches_its_full_batch():
    """The VLM with ``grad_accum=2`` against the port's own ``grad_accum=1``:
    both packages drop ``positions`` from the microbatches, and the JAX
    VLM backbone then indexes a ``[B, S]`` default as M-RoPE's ``[3, B,
    S]`` (a reference-side limit), where the port's default is
    ``arange(S)`` in all three streams, as ``train.main``'s positions
    are.  Equal token counts per microbatch, so the losses agree to
    rounding; the parameters within 1e-5 (no gradient sits at rounding
    level here)."""
    jcfg, cfg = _configs("qwen2-vl-7b")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    batch = {k: _t(v) for k, v in _batch(cfg, 7, b=4, s=32).items()}
    batch["labels"] = batch["tokens"].roll(-1, dims=1)          # no ignored label
    p = _port_params(cfg, _tree(jcfg, seed=8))
    st = adamw.init_opt_state(p, opt_cfg)
    p1, _, m1 = steps.make_train_step(cfg, opt_cfg)(p, st, batch)
    p2, _, m2 = steps.make_train_step(cfg, opt_cfg, grad_accum=2)(p, st, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    d = max(float((a - b).abs().max()) for a, b in zip(leaves(p1), leaves(p2)))
    assert d < 1e-5


def test_frontend_inputs_are_the_jax_launchers():
    """``frontend_inputs`` builds what the JAX ``train.main`` adds to a batch:
    frames ``[B, 64, d]`` and patch embeddings at 0.02 in ``cfg.dtype``,
    ``vision_pos`` = ``arange(P)``, positions ``arange(S)`` in three
    streams; nothing for a decoder-only text family.  More patches than
    tokens raise."""
    for arch in ("seamless-m4t-medium", "qwen2-vl-7b"):
        cfg = dataclasses.replace(reduce_config(get_config(arch), 8), dtype="bfloat16")
        got = frontend_inputs(cfg, 3, 80, "cpu")
        bf16 = jnp.dtype("bfloat16")
        if arch == "seamless-m4t-medium":
            want = {"frames": jnp.ones((3, 64, cfg.d_model), bf16) * 0.02}
        else:
            p = cfg.num_patches
            want = {"vision_embeds": jnp.ones((3, p, cfg.d_model), bf16) * 0.02,
                    "vision_pos": jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32)[None], (3, p)),
                    "positions": jnp.broadcast_to(jnp.arange(80, dtype=jnp.int32)[None, None],
                                                  (3, 3, 80))}
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == getattr(torch, str(w.dtype)), k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(w.astype(jnp.float32)), err_msg=k)
    assert frontend_inputs(reduce_config(get_config("smollm-360m"), 8), 2, 16, "cpu") == {}
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-vl-7b"), 8), num_patches=16)
    params = {"embed": torch.zeros((cfg.vocab, cfg.d_model), dtype=torch.bfloat16)}  # tracecheck: disable=TC005 — bf16 LM parameters
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             **frontend_inputs(cfg, 1, 8, "cpu")}
    with pytest.raises(ValueError, match="16 patch embeddings"):
        lm.embed_tokens(cfg, params, batch)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b"])
def test_train_main_resumes_bitwise_after_a_crash(arch, tmp_path):
    """``launch/train.main`` on the enc-dec and the VLM at ``--reduce 8``
    with a crash at step 4: one restart from the step-3 checkpoint, finite
    losses, and against an uninterrupted run the losses (step 3 run twice)
    and the final parameters and moments equal bit for bit."""
    args = ["--arch", arch, "--device", "cpu", "--reduce", "8", "--steps", "5",
            "--seq", "64", "--batch", "2", "--ckpt-every", "3", "--log-every", "4"]
    res = train.main(args + ["--fail-at", "4", "--ckpt-dir", str(tmp_path / "fail")])
    rep = res.report
    assert rep.steps_done == 5 and rep.restarts == 1 and rep.restored_from == [3]
    assert np.isfinite(rep.losses).all()
    clean = train.main(args + ["--ckpt-dir", str(tmp_path / "clean")])
    assert clean.report.restarts == 0
    assert rep.losses == clean.report.losses[:4] + clean.report.losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(res.state), leaves(clean.state),
                                                  strict=True))


@pytest.mark.parametrize("sq,skv,d,dv,causal", [
    (40, 64, 96, 64, True), (40, 64, 192, 128, False), (40, 40, 24, 16, True),
    (64, 24, 16, 16, False)], ids=["minicpm3", "deepseek-ragged", "small", "cross"])
def test_flash_backward_at_distinct_head_dims_matches_jax(sq, skv, d, dv, causal):
    """``flash_backward`` on the plain forward's output and lse, and the
    ``FlashAttention`` Function behind ``chunked_attention``, against
    ``jax.vjp`` of the JAX ``chunked_attention`` (its ``_flash`` custom
    VJP, whose backward is ``_flash_vjp_bwd``), KV chunks of 8 in both, GQA:
    ``dq``/``dk`` of QK width ``d``, ``dv`` of V width ``dv``, at
    ``GRAD``.  The last case is the enc-dec cross-attention: non-causal
    with ``Skv < Sq``."""
    rng = np.random.default_rng(sq + skv + d + dv)
    q, k = (rng.normal(0, 1, (2, n, h, d)).astype(np.float32) for n, h in ((sq, 4), (skv, 2)))
    v = rng.normal(0, 1, (2, skv, 2, dv)).astype(np.float32)
    dout = rng.normal(0, 1, (2, sq, 4, dv)).astype(np.float32)
    scale = 0.7 * d ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_attention.chunked_attention(
        *a, causal=causal, kv_chunk=8, scale=scale), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout))]
    qt, kt, vt, dt = (_t(x).transpose(1, 2) for x in (q, k, v, dout))
    out, lse = ops.flash_attention(qt, kt, vt, causal=causal, scale=scale, return_lse=True)
    got = attention.flash_backward(qt, kt, vt, out, lse, dt, causal=causal, scale=scale,
                                   kv_chunk=8)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    attention.chunked_attention(*xs, causal=causal, kv_chunk=8, scale=scale).backward(_t(dout))
    for name, g, x, w in zip(("dq", "dk", "dv"), got, xs, want):
        assert g.shape[-1] == (dv if name == "dv" else d)
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, **GRAD, err_msg=name)
        np.testing.assert_allclose(x.grad.numpy(), w, **GRAD, err_msg=f"{name} via autograd")


def test_layer_norm_grads_match_jax():
    """``common.layer_norm``'s gradients (x, gamma, beta) against
    ``jax.grad`` of the JAX package's, in float32."""
    rng = np.random.default_rng(9)
    x, gamma, beta, ct = (rng.normal(m, s, shp).astype(np.float32) for m, s, shp in (
        (0.5, 2.0, (3, 7, 40)), (1.0, 0.2, (40,)), (0.0, 0.2, (40,)), (0.0, 1.0, (3, 7, 40))))
    _, vjp = jax.vjp(lambda *a: jax_common.layer_norm(*a, 1e-5), *map(jnp.asarray, (x, gamma, beta)))
    want = vjp(jnp.asarray(ct))
    xs = [_t(a).requires_grad_() for a in (x, gamma, beta)]
    common.layer_norm(*xs, 1e-5).backward(_t(ct))
    for name, a, w in zip(("x", "gamma", "beta"), xs, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), **GRAD, err_msg=name)


def test_encdec_loss_is_the_decoders_chunked_ce():
    """``encdec_loss`` is ``chunked_ce`` of the decoder's hidden states over
    the unembedding, with ``moe_aux`` a float32 zero, and ``loss_for``
    gives it to the enc-dec family."""
    jcfg, cfg = _configs("seamless-m4t-medium")
    p = _port_params(cfg, _tree(jcfg, 11))
    batch = {k: _t(v) for k, v in _batch(cfg, 12, s=32).items()}
    loss, m = encdec.encdec_loss(cfg, p, batch)
    x = encdec.decode_train(cfg, p, batch["tokens"], encdec.encode(cfg, p, batch["frames"]))
    want, tok = lm.chunked_ce(cfg, x, p["unembed"], batch["labels"])
    assert torch.equal(loss, want) and torch.equal(m["ce"], want) and int(tok) == B * 32 - 5
    assert m["moe_aux"].dtype == torch.float32 and float(m["moe_aux"]) == 0.0
    assert steps.loss_for(cfg) is encdec.encdec_loss
