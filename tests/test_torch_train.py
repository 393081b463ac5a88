"""The port's training path against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX functions and
their counterparts in the port, in float32 on the CPU: the cross entropy
and its chunked form, the flash-attention autograd Function (the JAX
package's ``_flash`` custom VJP), its lse, the SSD gradient, AdamW,
gradient accumulation, the token pipeline, the launcher with an injected
crash and the live-twin example.  ``loss_fn`` with every parameter's
gradient per family and five train steps on JAX's batches are in
``test_torch_train_grads.py``.  On the CPU the port's kernels run their
plain versions.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mamba2 as jax_m2  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import DataConfig, TokenPipeline, _zipf_probs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import attention, common, lm, mamba2  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for the port's ops in this module: the suite runs in
    several processes at once, and these small ops gain nothing from a
    thread per core there (the count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

#: the f32 bar of the gradients (attention, SSD, every parameter)
GRAD = dict(rtol=1e-4, atol=1e-5)
#: the SSD gradient's bar: the forward's own against JAX is rtol/atol 3e-4
#: (test_torch_ssm); its gradients read 1.1e-4 at most in absolute terms
SSD_GRAD = dict(rtol=1e-4, atol=2e-4)


#: a bf16 parameter leaf of the optimizer check (LM weights, not twin math)
BF16 = torch.bfloat16  # tracecheck: disable=TC005 — bf16 LM parameters
JAX_BF16 = jnp.bfloat16  # tracecheck: disable=TC005 — bf16 LM parameters


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(a, np.float32)


# -- the cross entropy ----------------------------------------------------------


def np_params(jcfg, seed, dtype=None):
    """Parameters of the JAX package's layout for ``jcfg``, drawn with numpy
    by the law of its ``init_params`` (fan-in scaled normals, embeddings,
    zeros, ones): float32 numpy leaves, or with ``dtype`` JAX arrays in each
    spec's own dtype or ``dtype``.  ``jax.random`` would compile once per
    leaf shape, seconds a model."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            a = np.full(spec.shape, float(spec.init == "ones"), np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale if spec.init == "embed" else spec.scale / max(fan_in, 1) ** 0.5
            a = _f32(rng.normal(0, std, spec.shape))
        return a if dtype is None else jnp.asarray(a, spec.dtype or dtype)

    return jax.tree.map(one, jax_lm.model_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, jax_common.ParamSpec))


def _logits_labels(seed, shape, vocab):
    rng = np.random.default_rng(seed)
    logits = _f32(rng.normal(0, 3, shape + (vocab,)))
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[rng.random(shape) < 0.2] = -100
    return logits, labels


def test_cross_entropy_matches_jax():
    logits, labels = _logits_labels(1, (3, 17), 50)
    want_l, want_n = jax_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got_l, got_n = common.cross_entropy(_t(logits), _t(labels))
    assert int(got_n) == int(want_n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)


def test_ce_sums_match_jax():
    logits, labels = _logits_labels(2, (2, 33), 70)
    want_s, want_n = jax_lm._ce_sums(jnp.asarray(logits), jnp.asarray(labels))
    got_s, got_n = lm._ce_sums(_t(logits), _t(labels))
    assert got_n.dtype == torch.int32 and int(got_n) == int(want_n)
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-6)


@pytest.mark.parametrize("loss_chunk", [16, 1024], ids=["4-chunks", "1-chunk"])
def test_chunked_ce_matches_jax(monkeypatch, loss_chunk):
    """``[2, 64]`` tokens in CE chunks of 16 (both packages patched) and in
    one chunk, ignored labels included."""
    monkeypatch.setattr(jax_lm, "LOSS_CHUNK", loss_chunk)
    monkeypatch.setattr(lm, "LOSS_CHUNK", loss_chunk)
    rng = np.random.default_rng(3)
    x = _f32(rng.normal(0, 1, (2, 64, 24)))
    w = _f32(rng.normal(0, 0.5, (24, 90)))
    labels = rng.integers(0, 90, (2, 64)).astype(np.int32)
    labels[:, :7] = -100
    jcfg, cfg = _arch("smollm-360m", 8)
    want_l, want_n = jax_lm.chunked_ce(jcfg, *map(jnp.asarray, (x, w, labels)))
    got_l, got_n = lm.chunked_ce(cfg, *map(_t, (x, w, labels)))
    assert int(got_n) == int(want_n) == 2 * 57
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)


def test_chunked_ce_rejects_ragged_lengths(monkeypatch):
    monkeypatch.setattr(lm, "LOSS_CHUNK", 16)
    _, cfg = _arch("smollm-360m", 8)
    with pytest.raises(ValueError, match="CE chunks"):
        lm.chunked_ce(cfg, torch.zeros(1, 50, 8), torch.zeros(8, 5),
                      torch.zeros(1, 50, dtype=torch.int32))


# -- the flash-attention Function --------------------------------------------------


def _qkv(seed, b, s, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (_f32(rng.normal(0, 1, (b, s, hq, d))), _f32(rng.normal(0, 1, (b, t, hkv, d))),
            _f32(rng.normal(0, 1, (b, t, hkv, d))), _f32(rng.normal(0, 1, (b, s, hq, d))))


#: (b, sq, skv, hq, hkv, d, causal): GQA with Skv > Sq, causal and not,
#: MHA, and one query group of a single KV head
ATTN_CASES = [(2, 40, 64, 6, 2, 16, True), (2, 40, 64, 6, 2, 16, False),
              (1, 64, 64, 4, 4, 8, True), (2, 32, 48, 3, 1, 16, True)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", ATTN_CASES)
def test_flash_function_matches_jax_vjp(b, sq, skv, hq, hkv, d, causal):
    """``chunked_attention`` with gradients on (the FlashAttention Function)
    against ``jax.vjp`` of the JAX ``chunked_attention`` (its ``_flash``
    custom VJP), KV chunks of 16: output and dq/dk/dv."""
    q, k, v, dout = _qkv(b + sq + skv + hq, b, sq, skv, hq, hkv, d)
    fn = functools.partial(jax_attention.chunked_attention, causal=causal, kv_chunk=16)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    got = attention.chunked_attention(tq, tk, tv, causal=causal, kv_chunk=16)
    got.backward(_t(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **GRAD)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("kv_chunk", [16, 20, 1024], ids=["chunks", "ragged", "one"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_plain_autograd(kv_chunk, causal):
    """FlashAttention's backward against torch autograd through the plain
    version ``ref.flash_attention_ref`` on the kernel's layout, with KV
    chunks that split Skv evenly, raggedly and not at all."""
    q, k, v, dout = (np.moveaxis(x, 1, 2) for x in _qkv(9, 2, 24, 60, 4, 2, 16))
    a = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention.FlashAttention.apply(*a, causal, 16 ** -0.5, kv_chunk)
    out.backward(_t(dout))
    b = [_t(x).requires_grad_() for x in (q, k, v)]
    want = ref.flash_attention_ref(*b, causal=causal)
    want.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), **GRAD)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **GRAD)


def test_flash_function_runs_the_kernel_forward_once():
    """Forward and backward: one ``ops.flash_attention`` call, which on the
    CPU runs the plain version and counts no launch; with gradients off
    the call is the plain forward, unchanged."""
    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*args, **kw)

    q, k, v, dout = _qkv(4, 1, 16, 16, 2, 1, 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_attention", spy)
        ops.reset_launches()
        tq = _t(q).requires_grad_()
        attention.chunked_attention(tq, _t(k), _t(v)).backward(_t(dout))
        assert calls == [True]
        with torch.no_grad():
            attention.chunked_attention(_t(q), _t(k), _t(v))
        assert calls == [True, False]
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("causal,skv", [(True, 64), (False, 64), (True, 40)])
def test_flash_lse_matches_jax_fwd_scan(causal, skv):
    """The plain version's lse against the JAX package's ``_flash_fwd_scan``
    (scaled-logit units, ``m + log(max(l, 1e-30))``), and its output
    unchanged by ``return_lse``."""
    b, sq, hq, hkv, d = 2, 40, 6, 2, 16
    q, k, v, _ = _qkv(11 + skv, b, sq, skv, hq, hkv, d)
    g, chunk = hq // hkv, skv // 4 if skv % 4 == 0 else skv
    qg = (jnp.asarray(q) * d ** -0.5).reshape(b, sq, hkv, g, d)
    n = skv // chunk
    kc = jnp.asarray(k).reshape(b, n, chunk, hkv, d).transpose(1, 0, 2, 3, 4)
    vc = jnp.asarray(v).reshape(b, n, chunk, hkv, d).transpose(1, 0, 2, 3, 4)
    _, want = jax_attention._flash_fwd_scan(
        qg, kc, vc, causal, chunk, skv, sq, ("batch", "kv_heads", None, None, None))
    qt, kt, vt = (_t(np.moveaxis(x, 1, 2)) for x in (q, k, v))
    out, lse = ops.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(b, hq, sq),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ops.flash_attention(qt, kt, vt, causal=causal))


def test_flash_lse_of_a_row_that_sees_no_key():
    """Causal with Skv < Sq: the first rows see no key; their lse is the
    clamped ``-1e30``, as the kernel writes it."""
    q, k, v, _ = _qkv(5, 1, 8, 4, 2, 2, 8)
    _, lse = ref.flash_attention_ref(*(_t(np.moveaxis(x, 1, 2)) for x in (q, k, v)),
                                     causal=True, return_lse=True)
    assert bool((lse[:, :, :4] == -1e30).all())
    assert bool(torch.isfinite(lse[:, :, 4:]).all()) and bool((lse[:, :, 4:] > -1e29).all())


# -- the SSD gradient -----------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=0)
def _jax_ssd_vjp(chunk, args, ct):
    """``(y, grads of the six operands)`` of the JAX ``ssd_chunked``."""
    y, vjp = jax.vjp(lambda *a: jax_m2.ssd_chunked(*a, chunk), *args)
    return y, vjp(ct)


@pytest.mark.parametrize("chunk,s", [(16, 64), (32, 32)], ids=["4-chunks", "1-chunk"])
def test_ssd_grads_match_jax(chunk, s):
    """Gradients of ``ssd_chunked`` (the SSDChunk Function and the torch
    recurrence) for all six operands against ``jax.vjp`` of the JAX
    ``ssd_chunked``."""
    rng = np.random.default_rng(chunk + s)
    bsz, h, p, g, n = 2, 4, 8, 2, 16
    args = (_f32(rng.normal(0, 1, (bsz, s, h, p))), _f32(rng.uniform(0.1, 0.9, (bsz, s, h))),
            _f32(rng.normal(0, 0.3, (h,))), _f32(rng.normal(0, 1, (bsz, s, g, n))),
            _f32(rng.normal(0, 1, (bsz, s, g, n))), _f32(rng.normal(0, 1, (h,))))
    ct = _f32(rng.normal(0, 1, (bsz, s, h, p)))
    want, want_grads = _jax_ssd_vjp(chunk, tuple(map(jnp.asarray, args)), jnp.asarray(ct))
    xs = [_t(a).requires_grad_() for a in args]
    got = mamba2.ssd_chunked(*xs, chunk)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)
    for i, (x, w) in enumerate(zip(xs, want_grads)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **SSD_GRAD,
                                   err_msg=f"operand {i}")


def test_ssd_function_matches_plain_autograd():
    """SSDChunk's gradient is the plain version's own autograd, exactly."""
    rng = np.random.default_rng(7)
    args = (_f32(rng.normal(0, 1, (3, 16, 4, 8))), _f32(rng.uniform(0.1, 0.9, (3, 16, 4))),
            _f32(rng.normal(0, 0.3, (4,))), _f32(rng.normal(0, 1, (3, 16, 2, 8))),
            _f32(rng.normal(0, 1, (3, 16, 2, 8))), _f32(rng.normal(0, 1, (4,))))
    cy, cs = _f32(rng.normal(0, 1, (3, 16, 4, 8))), _f32(rng.normal(0, 1, (3, 4, 8, 8)))
    a = [_t(x).requires_grad_() for x in args]
    y, st = mamba2.SSDChunk.apply(*a)
    torch.autograd.backward((y, st), (_t(cy), _t(cs)))
    b = [_t(x).requires_grad_() for x in args]
    y2, st2 = ref.ssd_chunk_ref(*b)
    torch.autograd.backward((y2, st2), (_t(cy), _t(cs)))
    assert torch.equal(y, y2) and torch.equal(st, st2)
    for x, z in zip(a, b):
        assert torch.equal(x.grad, z.grad)


def _ssd_f64(x, dt, a_log, b, c, d_skip):
    """The SSD intra-chunk term and states in float64 (the plain version's
    algebra, decay masked before the exponential)."""
    q, h = x.shape[1], x.shape[2]
    rep = h // b.shape[2]
    bb, cc = b.repeat_interleave(rep, dim=2), c.repeat_interleave(rep, dim=2)
    csum = torch.cumsum(dt * -torch.exp(a_log)[None, None], dim=1)
    seg = csum[:, :, None, :] - csum[:, None, :, :]
    mask = torch.ones((q, q), dtype=torch.bool).tril()[None, :, :, None]
    att = (torch.einsum("bqhn,bkhn->bqkh", cc, bb)
           * torch.exp(seg.masked_fill(~mask, float("-inf"))) * dt[:, None])
    y = torch.einsum("bqkh,bkhp->bqhp", att, x) + x * d_skip[None, None, :, None]
    dend = torch.exp(csum[:, -1:] - csum) * dt
    return y, torch.einsum("bqhp,bqh,bqhn->bhpn", x, dend, bb)


def test_ssd_grads_stay_finite_where_the_decay_overflows():
    """A deliberate divergence: with a fast decay over a 64-row chunk,
    ``exp(csum_i - csum_j)`` above the diagonal overflows float32.  The JAX
    package masks after the exponential, so its gradient is ``0 * inf =
    NaN``; the port masks before it.  Its gradients are finite and equal a
    float64 evaluation of the same function to rtol 5e-4: the float32 sums
    over 64 rows of decays this steep read 1.5e-4 in ``A_log``'s
    gradient."""
    rng = np.random.default_rng(8)
    args = (_f32(rng.normal(0, 1, (2, 64, 2, 8))), _f32(rng.uniform(1.5, 2.5, (2, 64, 2))),
            _f32([1.0, 0.5]), _f32(rng.normal(0, 1, (2, 64, 1, 8))),
            _f32(rng.normal(0, 1, (2, 64, 1, 8))), _f32([1.0, -0.5]))
    cy, cs = _f32(rng.normal(0, 1, (2, 64, 2, 8))), _f32(rng.normal(0, 1, (2, 2, 8, 8)))
    _, want_grads = _jax_ssd_vjp(64, tuple(map(jnp.asarray, args)), jnp.asarray(cy))
    want_dt = np.asarray(want_grads[1])                    # through the decay
    assert np.isnan(want_dt).any()
    a = [_t(x).requires_grad_() for x in args]
    torch.autograd.backward(mamba2.SSDChunk.apply(*a), (_t(cy), _t(cs)))
    b = [_t(x).double().requires_grad_() for x in args]
    torch.autograd.backward(_ssd_f64(*b), (_t(cy).double(), _t(cs).double()))
    for i, (x, z) in enumerate(zip(a, b)):
        assert bool(torch.isfinite(x.grad).all())
        np.testing.assert_allclose(x.grad.numpy(), z.grad.numpy(), rtol=5e-4,
                                   atol=2e-4, err_msg=f"operand {i}")


# -- the loss and its gradients per family ------------------------------------------


def _arch(arch, factor, **over):
    """``(jax config, port config)`` of ``arch`` reduced by ``factor``, f32."""
    kw = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch), factor), **kw)
    cfg = dataclasses.replace(reduce_config(get_config(arch), factor), **kw)
    return jcfg.validate(), cfg.validate()


def test_loss_for_refuses_encdec():
    """``loss_for`` refuses no family: the enc-dec one gets
    ``encdec.encdec_loss``, as the JAX package's ``loss_for`` gives it
    (held against JAX in ``test_torch_train_families.py``), the others
    ``lm.loss_fn``."""
    from repro_torch.models import encdec

    enc = dataclasses.replace(get_config("smollm-360m"), family="encdec")
    assert steps.loss_for(enc) is encdec.encdec_loss
    assert steps.loss_for(get_config("smollm-360m")) is lm.loss_fn


# -- AdamW ------------------------------------------------------------------------


def _jax_opt_cfg(cfg: adamw.AdamWConfig):
    return jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))


def test_adamw_schedule_matches_jax():
    """The schedule's shape (tests/test_train_features.py) and its values
    against the JAX package's at every step, past the end."""
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.schedule(torch.tensor(s, dtype=torch.int32), cfg))
           for s in range(0, 121)]
    want = [float(jax_adamw.schedule(jnp.asarray(s, jnp.int32), _jax_opt_cfg(cfg)))
            for s in range(0, 121)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)
    assert lrs[0] == 0.0 and abs(lrs[10] - 1.0) < 1e-6 and lrs[100] <= 0.11
    assert all(a >= b - 1e-6 for a, b in zip(lrs[10:], lrs[11:]))


def test_adamw_clips_gradients():
    cfg = adamw.AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    p = {"w": torch.ones(4)}
    st = adamw.init_opt_state(p, cfg)
    _, _, m = adamw.apply_updates(p, {"w": torch.full((4,), 100.0)}, st, cfg)
    assert float(m["grad_norm"]) == 200.0     # reported pre-clip


def test_apply_updates_matches_jax():
    """Twelve AdamW steps on injected identical gradients through warmup (3
    steps), clipping (norms up to ~40 against clip_norm 5) and cosine decay
    past ``total_steps``: f32 params, grad_norm and lr at rtol 1e-6 every
    step, both moments at rtol 1e-6 plus 1e-6 of the leaf's largest
    moment (``b m + (1 - b) g`` cancels, and the clip scale from the two
    packages' gradient norms differs in its last bits).  A bf16 leaf is
    rounded from f32 values that agree to rtol 1e-6, so it is held to one
    bf16 ulp (2^-8 relative)."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=5.0)
    jcfg = _jax_opt_cfg(cfg)
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 2, 4)}}
    init = jax.tree.map(lambda s: _f32(rng.normal(0, 1, s)), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    bf = _f32(rng.normal(0, 1, (6, 4)))
    jp = {**jax.tree.map(jnp.asarray, init), "e": jnp.asarray(bf, JAX_BF16)}
    p = {**jax.tree.map(_t, init), "e": _t(bf).to(BF16)}
    jst, st = jax_adamw.init_opt_state(jp, jcfg), adamw.init_opt_state(p, cfg)
    jax_apply = jax.jit(jax_adamw.apply_updates, static_argnums=3)
    for step in range(12):
        scale = 10.0 if step % 3 == 0 else 0.5
        g = jax.tree.map(lambda x: _f32(rng.normal(0, scale, x.shape)), jp)
        jp, jst, jm = jax_apply(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        p, st, m = adamw.apply_updates(p, jax.tree.map(_t, g), st, cfg)
        assert int(st.step) == int(jst.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        for got, want in zip(leaves(p), jax.tree.leaves(jp)):
            w = np.asarray(want.astype(jnp.float32))
            tol = 2 ** -8 if got.dtype == BF16 else 1e-6
            np.testing.assert_allclose(got.float().numpy(), w, rtol=tol, atol=0)
        for tree, jtree in ((st.mu, jst.mu), (st.nu, jst.nu)):
            for got, want in zip(leaves(tree), jax.tree.leaves(jtree)):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())


# -- train steps --------------------------------------------------------------------


def _tiny():
    kw = dict(name="t", family="dense", num_layers=2, d_model=32, vocab=64,
              n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, remat="none",
              dtype="float32")
    return get_config("smollm-360m").__class__(**kw).validate()


def test_grad_accum_matches_full_batch():
    """As ``test_grad_accum_matches_full_batch`` in the JAX package: the
    same global batch in two microbatches gives the same loss and params,
    with the accumulating path's metrics."""
    cfg = _tiny()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    from repro_torch.models.common import init_params
    params = init_params(lm.model_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    rng = np.random.default_rng(1)
    batch = {k: _t(rng.integers(0, 64, (4, 16)).astype(np.int32)) for k in ("tokens", "labels")}
    p1, o1, m1 = steps.make_train_step(cfg, opt_cfg)(params, opt, batch)
    p2, o2, m2 = steps.make_train_step(cfg, opt_cfg, grad_accum=2)(params, opt, batch)
    assert set(m1) == set(m2) == {"loss", "ce", "moe_aux", "tokens", "grad_norm", "lr"}
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert float(m2["ce"]) == float(m2["loss"]) and int(m2["tokens"]) == 0
    assert int(m1["tokens"]) == 64
    d = max(float((a - b).abs().max()) for a, b in zip(leaves(p1), leaves(p2)))
    assert d < 5e-3
    with pytest.raises(ValueError, match="grad_accum"):
        steps.make_train_step(cfg, opt_cfg, grad_accum=3)(params, opt, batch)


def test_train_step_is_pure():
    cfg = _tiny()
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    from repro_torch.models.common import init_params
    params = init_params(lm.model_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    before = [x.clone() for x in leaves(params)]
    opt = adamw.init_opt_state(params, opt_cfg)
    rng = np.random.default_rng(1)
    batch = {k: _t(rng.integers(0, 64, (2, 8)).astype(np.int32)) for k in ("tokens", "labels")}
    step = steps.make_train_step(cfg, opt_cfg)
    a = step(params, opt, batch)
    b = step(params, opt, batch)
    assert all(torch.equal(x, y) for x, y in zip(before, leaves(params)))
    assert int(opt.step) == 0
    assert all(torch.equal(x, y) for x, y in zip(leaves(a[0]), leaves(b[0])))
    assert not any(x.requires_grad for x in leaves(a[0]))


# -- the token pipeline ------------------------------------------------------------------


def _law(vocab, a=1.2, p=0.25):
    """The token marginal and the bigram rate ``P(tok[t] = tok[t-1] + 1)`` of
    the pipeline's rule: Zipf draws ``o``, then ``tok[t] = o[t-1] + 1`` with
    probability p (the previous *draw*, not the previous token) and
    ``o[t]`` otherwise."""
    z = _zipf_probs(vocab, a).astype(np.float64)
    m = (1 - p) * z + p * np.roll(z, 1)
    q1 = float((z * np.roll(z, -1)).sum())       # o[t] = o[t-1] + 1
    q2 = float((z * np.roll(z, -2)).sum())       # o[t] = o[t-2] + 2
    rate = p * (1 - p) + (p * p + (1 - p) ** 2) * q1 + (1 - p) * p * q2
    return m, rate


def test_token_pipeline_shapes_dtypes_and_purity():
    pipe = TokenPipeline(DataConfig(vocab=300, seq_len=33, global_batch=6, seed=5),
                         device="cpu")
    b = pipe.global_batch(3)
    assert set(b) == {"tokens", "labels"}
    for x in b.values():
        assert x.shape == (6, 33) and x.dtype == torch.int32 and x.device.type == "cpu"
        assert int(x.min()) >= 0 and int(x.max()) < 300
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    again = TokenPipeline(DataConfig(vocab=300, seq_len=33, global_batch=6, seed=5),
                          device="cpu").global_batch(3)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["tokens"], pipe.global_batch(4)["tokens"])
    shards = [pipe.batch(3, shard=i, num_shards=3) for i in range(3)]
    assert all(s["tokens"].shape == (2, 33) for s in shards)
    assert not torch.equal(shards[0]["tokens"], shards[1]["tokens"])
    with pytest.raises(ValueError, match="shards"):
        pipe.batch(0, num_shards=4)


def test_token_pipeline_statistics_match_the_jax_pipeline():
    """The Zipf marginal and the bigram repeat rate of the port's batches
    and of the JAX package's (different draws, the same law), each against
    the mixture's stationary law."""
    vocab, seq, batch = 256, 255, 64
    m, want_rep = _law(vocab)
    port = TokenPipeline(DataConfig(vocab, seq, batch, seed=1), device="cpu")
    jpipe = JaxTokenPipeline(JaxDataConfig(vocab, seq, batch, seed=1))
    for name, draw in (("port", lambda s: port.global_batch(s)["tokens"].numpy()),
                       ("jax", lambda s: np.asarray(jpipe.global_batch(s)["tokens"]))):
        toks = np.concatenate([draw(s) for s in range(4)])
        freq = np.bincount(toks.ravel(), minlength=vocab) / toks.size
        tv = 0.5 * np.abs(freq - m).sum()
        rep = float((toks[:, 1:] == (toks[:, :-1] + 1) % vocab).mean())
        assert tv < 0.02, (name, tv)
        assert abs(rep - want_rep) < 0.01, (name, rep, want_rep)
        assert abs(freq[0] - m[0]) < 0.01, (name, freq[0], m[0])


# -- the launcher and the live-twin example ---------------------------------------------------


def test_train_main_end_to_end_on_cpu(tmp_path, capsys):
    """``launch/train.main`` at --reduce 8 for 12 steps with a crash
    injected at step 7: one restart from the step-5 checkpoint, the steps
    after it rerun with the same losses."""
    ck = tmp_path / "ck"
    args = ["--device", "cpu", "--reduce", "8", "--steps", "12", "--seq", "32",
            "--batch", "2", "--ckpt-every", "5", "--log-every", "4"]
    res = train.main(args + ["--fail-at", "7", "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    rep = res.report
    assert rep.steps_done == 12 and rep.restarts == 1 and rep.restored_from == [5]
    assert rep.checkpoints == 2                     # step 5, then step 10 after the restart
    assert len(rep.losses) == 7 + 7 and np.isfinite(rep.losses).all()
    assert rep.losses[5:7] == rep.losses[7:9]       # steps 5, 6 rerun from the checkpoint
    assert "done: 12 steps, 1 restarts" in out and out.count("step ") >= 3
    clean = train.main(args + ["--ckpt-dir", str(tmp_path / "clean")])
    assert clean.report.restarts == 0
    assert clean.report.losses == rep.losses[:5] + rep.losses[7:]
    assert set(res.state) == {"params", "opt"} and int(res.state["opt"].step) == 12


def test_train_main_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


def _live_twin():
    spec = importlib.util.spec_from_file_location(
        "live_twin_training_torch", ROOT / "examples" / "live_twin_training_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod              # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_live_twin_example_on_cpu(tmp_path, capsys):
    """The example at 50 steps with a crash at step 30 (before its first
    checkpoint, so the run restarts from scratch): its closing checks hold,
    and the twin observed two windows of 25 steps."""
    res = _live_twin().main(["--device", "cpu", "--steps", "50", "--fail-at", "30",
                             "--reduce", "16", "--seq", "32", "--batch", "2",
                             "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert res.report.restarts == 1 and res.report.steps_done == 50
    assert len(res.window_mapes) == 3 and np.isfinite(res.window_mapes).all()
    assert "=== summary ===" in out and "[twin] window  1" in out


def test_live_twin_example_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="cuda"):
        _live_twin().main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
