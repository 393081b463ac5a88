"""The rounding of the port's tensor-core kernels, against the JAX package.

The card's bf16 flash-attention kernel and its ``ssd_chunk`` kernel
compute in a precision of their own: flash rounds ``P`` to bf16 before
``P V`` and multiplies ``S`` (not ``q``) by the scale; ``ssd_chunk``
forms each of its three products as a 3xTF32 split (every operand split
into TF32 hi and lo parts by round-to-nearest on the 13 low mantissa bits,
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` summed in f32).  The kernels run only
on a card, so plain-torch models of that rounding live here, on no path,
and are held against the Pallas kernels in interpret mode at the bars
``chip_smoke.py`` holds the card kernels to, and the flash model also
against the port's plain version through ``chip_smoke.py``'s own bf16
check.  That shows on the CPU that the chosen precision fits the bars;
``chip_smoke.py`` then holds each card kernel against its plain version.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_pallas  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16 = torch.bfloat16  # tracecheck: disable=TC005 — attention operand dtype of the LM, not twin math
NEG_INF = -1e30


# -- flash attention, bf16 route ------------------------------------------------


def flash_bf16_model(q, k, v, *, causal):
    """The bf16 kernel's rounding: products of bf16 operands in f32, the
    scale on ``S`` in f32, softmax in f32, ``P`` rounded to bf16 before
    ``P V``, output rounded to bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * (d ** -0.5)
    rows = torch.arange(sq)[:, None] + (skv - sq)
    live = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        live = rows >= torch.arange(skv)[None, :]
    s = torch.where(live, s, torch.tensor(NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return ((p.to(BF16).float() @ vf) / l).to(BF16)


#: (b, hq, hkv, sq, skv, d, causal, rtol, atol): the JAX attention sweep's
#: shapes in bf16 at its bf16 bar, the bf16 cases chip_smoke.py adds (D 16,
#: 32, 128, ragged 100 / 257, decode, Skv > Sq, non-causal), and a longer
#: causal GQA row at the prefill shapes' bar rtol / atol 2e-2
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True, 2e-2, 2e-1),
    (2, 8, 2, 100, 100, 32, True, 2e-2, 2e-1),
    (2, 4, 1, 64, 64, 64, False, 2e-2, 2e-1),
    (1, 6, 2, 1, 96, 64, True, 2e-2, 2e-1),
    (2, 4, 2, 128, 128, 64, True, 2e-2, 2e-1),
    (1, 4, 4, 257, 257, 16, True, 2e-2, 2e-1),
    (2, 4, 2, 100, 100, 16, True, 2e-2, 2e-1),
    (2, 4, 2, 100, 100, 128, True, 2e-2, 2e-1),
    (1, 4, 2, 257, 257, 64, True, 2e-2, 2e-1),
    (1, 4, 2, 64, 200, 64, True, 2e-2, 2e-1),
    (2, 4, 1, 100, 130, 128, False, 2e-2, 2e-1),
    (1, 3, 1, 512, 512, 64, True, 2e-2, 2e-2),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,rtol,atol", FLASH_CASES)
def test_flash_bf16_rounding_fits_the_bars(b, hq, hkv, sq, skv, d, causal,
                                           rtol, atol):
    rng = np.random.default_rng(b * 1000 + hq * 100 + sq + skv + d)
    arrays = [rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
              for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]
    want = flash_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays),  # tracecheck: disable=TC005 — attention operand dtype
        causal=causal, interpret=True, q_blk=64, k_blk=64)
    got = flash_bf16_model(*(torch.from_numpy(a).to(BF16) for a in arrays),
                           causal=causal)
    assert got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()
BF16_CARD_CASES = [i for i, c in enumerate(CHIP_SMOKE.FLASH_CASES) if c[8]]


@pytest.mark.parametrize("i", BF16_CARD_CASES)
def test_flash_bf16_rounding_fits_the_card_bar(i):
    """The rounding model, on ``chip_smoke.py``'s own inputs of each bf16
    case, within that case's bar against the port's plain version in f32
    (``chip_smoke.flash_bar_use``).  At the prefill shapes, one batch row
    and the query heads of one KV head."""
    *_, causal, _, rtol, atol = CHIP_SMOKE.FLASH_CASES[i]
    q, k, v = CHIP_SMOKE.flash_inputs(torch, np, i, "cpu")
    if q.shape[2] == CHIP_SMOKE.PREFILL_S:
        q, k, v = q[:1, :q.shape[1] // k.shape[1]], k[:1, :1], v[:1, :1]
    got = flash_bf16_model(q, k, v, causal=causal)
    _, used = CHIP_SMOKE.flash_bar_use(torch, ref, got, q, k, v, causal, rtol, atol)
    assert used <= 1.0


# -- ssd_chunk, 3xTF32 products -------------------------------------------------


def tf32(a):
    """``a`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest
    on the 13 low mantissa bits, ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as the kernel forms it: ``a = a_hi + a_lo`` (both TF32),
    likewise ``b``, and ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in f32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_1xtf32(a, b):
    """``a @ b`` in one TF32 pass, as a plain TF32 tensor-core product."""
    return tf32(a) @ tf32(b)


def ssd_chunk_model(x, dt, a_log, b, c, d_skip, mm=mm_3xtf32):
    """The kernel's function with each of its three products (``C B^T``,
    ``att @ x``, ``(x w)^T B``) formed by ``mm``; the elementwise terms as
    the plain version computes them."""
    q, h = x.shape[1], x.shape[2]
    rep = h // b.shape[2]
    xh = x.permute(0, 2, 1, 3)                                  # [BC,H,Q,P]
    bh = b.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)    # [BC,H,Q,N]
    ch = c.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dth = dt.permute(0, 2, 1)                                   # [BC,H,Q]
    csum = torch.cumsum(dth * -torch.exp(a_log)[None, :, None], dim=-1)
    mask = torch.ones((q, q), dtype=torch.bool).tril()
    decay = torch.where(mask, torch.exp(csum[..., :, None] - csum[..., None, :]), 0.0)
    att = mm(ch, bh.transpose(-1, -2)) * decay * dth[..., None, :]
    y = mm(att, xh) + xh * d_skip[None, :, None, None]
    w = torch.exp(csum[..., -1:] - csum) * dth
    st = mm((xh * w[..., None]).transpose(-1, -2), bh)
    return y.permute(0, 2, 1, 3), st


def _ssd_inputs(seed, bc, q, h, p, g, n, long_memory):
    """The JAX sweep's draws; with ``long_memory`` chip_smoke.py's slow decay
    (dt ~ U(0.001, 0.02), A_log ~ N(-1, 0.3)), where every row counts."""
    rng = np.random.default_rng(seed)
    dt_lo, dt_hi, a_mean = (0.001, 0.02, -1.0) if long_memory else (0.1, 0.9, 0.0)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(rng.normal(0, 1, (bc, q, h, p))), f(rng.uniform(dt_lo, dt_hi, (bc, q, h))),
            f(rng.normal(a_mean, 0.3, (h,))), f(rng.normal(0, 1, (bc, q, g, n))),
            f(rng.normal(0, 1, (bc, q, g, n))), f(rng.normal(0, 1, (h,))))


#: the JAX SSD sweep (tests/test_kernels.py), then a ragged 200-row chunk
#: at N=128 with the long memory, where |y| reaches tens
SSD_CASES = [((2, 16, 2, 8, 1, 16), False), ((3, 32, 4, 16, 2, 24), False),
             ((1, 64, 8, 32, 4, 64), False), ((2, 200, 4, 64, 1, 128), True)]
SSD_TOL = 1e-4


@pytest.mark.parametrize("shape,long_memory", SSD_CASES)
def test_ssd_3xtf32_rounding_fits_the_bar(shape, long_memory):
    args = _ssd_inputs(sum(shape), *shape, long_memory=long_memory)
    want = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    got = ssd_chunk_model(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SSD_TOL,
                                   atol=SSD_TOL)


def test_one_tf32_pass_breaks_the_bar():
    """Why the split: the same products in a single TF32 pass miss the bar
    on the long-memory chunk, so the bar can tell the two apart."""
    shape, long_memory = SSD_CASES[-1]
    args = _ssd_inputs(sum(shape), *shape, long_memory=long_memory)
    want = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    got = ssd_chunk_model(*map(torch.from_numpy, args), mm=mm_1xtf32)
    y, w = got[0].numpy(), np.asarray(want[0])
    assert not np.allclose(y, w, rtol=SSD_TOL, atol=SSD_TOL)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                 # the TF32 ulp above 1
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      one + 2.0 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([one, 1.0, -one, one + 2.0 ** -10, 3.0])
    assert torch.equal(tf32(a), want)
    hi = tf32(a)
    assert torch.equal(tf32(a - hi) + hi, a)   # hi + lo is exact here
