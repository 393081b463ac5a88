"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels build and run only on a card); the JAX side runs its Pallas
kernels in interpret mode, as its own tests do.  Inputs are made from a
seed with numpy and handed to both.  The kernels themselves are held
against these plain versions on a card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.calib_mape import calib_mape_grid_pallas  # noqa: E402
from repro.kernels.des_readout import des_readout_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.power_sim import power_sim_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: one bf16 ulp, relative (8 significant bits)
BF16_ULP = 2.0 ** -8


def _calib_inputs(seed, t, h, c, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    u = rng.uniform(0, 1, lead + (t, h)).astype(np.float32)
    real = rng.uniform(1e3, 5e3, lead + (t,)).astype(np.float32)
    pi = rng.uniform(50, 90, (c,)).astype(np.float32)
    pm = rng.uniform(250, 450, (c,)).astype(np.float32)
    r = rng.uniform(1, 6, (c,)).astype(np.float32)
    return u, real, pi, pm, r


def _port_calib(*arrays):
    return ops.calib_mape_grid(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("t,h,c", [
    (64, 16, 8), (100, 64, 33), (288, 277, 64), (512, 128, 200),
])
def test_calib_mape_matches_pallas_sweep(t, h, c):
    """The test_calib_mape_sweep shapes, at that sweep's tolerance."""
    args = _calib_inputs(t * 7 + c, t, h, c)
    want = calib_mape_grid_pallas(*(jnp.asarray(a) for a in args),
                                  interpret=True)
    np.testing.assert_allclose(_port_calib(*args), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def test_calib_mape_all_zero_real_is_nan_and_zero_bins_excluded():
    u, real, pi, pm, r = _calib_inputs(1, 48, 9, 12)
    zeros = np.zeros_like(real)
    assert np.isnan(_port_calib(u, zeros, pi, pm, r)).all()
    assert np.isnan(np.asarray(calib_mape_grid_pallas(
        *(jnp.asarray(a) for a in (u, zeros, pi, pm, r)), interpret=True))).all()
    # zero bins are excluded from the mean, not scored against eps
    real_z = real.copy()
    real_z[::3] = 0.0
    want = calib_mape_grid_pallas(*(jnp.asarray(a) for a in (u, real_z, pi, pm, r)),
                                  interpret=True)
    np.testing.assert_allclose(_port_calib(u, real_z, pi, pm, r),
                               np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b,t,h,c", [(5, 64, 1, 16), (3, 40, 7, 9)])
def test_calib_mape_batched_rows_match_per_row_pallas(b, t, h, c):
    """The batched [B, T, H] form (the per-host refit's one launch) equals
    B separate single-window evaluations, row for row; one all-zero row
    gives NaN in its row only."""
    u, real, pi, pm, r = _calib_inputs(b + t, t, h, c, b=b)
    real[1] = 0.0
    got = _port_calib(u, real, pi, pm, r)
    assert got.shape == (b, c)
    for i in range(b):
        want = calib_mape_grid_pallas(
            *(jnp.asarray(a) for a in (u[i], real[i], pi, pm, r)), interpret=True)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-4, atol=1e-3)
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


def _readout_case(seed, t=97, h=13, axes=("mask", "cap", "carbon", "failures",
                                          "pue", "price")):
    """Randomized readout inputs, as tests/test_des_kernel.py builds them."""
    rng = np.random.default_rng(seed)
    kw = dict(
        p_idle=rng.uniform(40.0, 90.0, h).astype(np.float32),
        p_max=rng.uniform(200.0, 420.0, h).astype(np.float32),
        r=np.float32(rng.uniform(1.2, 3.4)),
        peak_tflops=np.float32(rng.uniform(100.0, 500.0)),
    )
    u = rng.uniform(0.0, 1.15, (t, h)).astype(np.float32)
    if "mask" in axes:
        kw["mask"] = rng.uniform(size=h) < 0.8
    if "cap" in axes:
        rough = float(np.sum(kw["p_idle"]) + 0.4 * np.sum(kw["p_max"]))
        kw["cap_t"] = rng.uniform(0.5 * rough, 1.1 * rough, t).astype(np.float32)
    if "carbon" in axes:
        kw["intensity"] = rng.uniform(50.0, 600.0, t).astype(np.float32)
    if "failures" in axes:
        fs = np.where(rng.uniform(size=h) < 0.4, rng.integers(0, t, h),
                      np.iinfo(np.int32).max).astype(np.int32)
        fe = np.minimum(fs.astype(np.int64) + rng.integers(3, max(t // 2, 4), h),
                        np.iinfo(np.int32).max).astype(np.int32)
        kw.update(fail_start=fs, fail_end=fe,
                  fail_kill=rng.uniform(size=h) < 0.7)
    if "pue" in axes:
        kw.update(pue_base=np.float32(rng.uniform(1.05, 1.4)),
                  pue_amb_coeff=np.float32(rng.uniform(0.0, 0.05)),
                  pue_amb_ref=np.float32(rng.uniform(10.0, 22.0)),
                  pue_load_coeff=np.float32(rng.uniform(0.0, 0.25)),
                  ambient=rng.uniform(-5.0, 38.0, t).astype(np.float32))
    if "price" in axes:
        kw["price"] = rng.uniform(-0.05, 0.45, t).astype(np.float32)
    return u, kw


def _port_readout(u, kw, **extra):
    tkw = {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
               else float(v)) for k, v in kw.items()}
    return ops.des_readout(torch.from_numpy(u), **tkw, **extra)


def _assert_readout_close(got, want, precision="f32"):
    assert set(got) == set(ref.READOUT_FIELDS)
    for k in ref.READOUT_FIELDS:
        g = got[k].numpy().astype(np.float64)
        w = np.asarray(want[k], np.float64)
        if precision == "bf16" and k in ("tflops", "efficiency"):
            assert np.all(np.abs(g - w) <= BF16_ULP * np.abs(w)), k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)


_AXES = ("mask", "cap", "carbon", "failures", "pue", "price")
_AXIS_CASES = [
    ((), 0), (("mask",), 1), (("cap",), 2), (("cap", "carbon"), 3),
    (("failures",), 4), (("pue",), 5), (("price",), 6), (_AXES, 7),
]


@pytest.mark.parametrize("axes,seed", _AXIS_CASES,
                         ids=["+".join(a) or "plain" for a, _ in _AXIS_CASES])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_des_readout_matches_pallas_every_axis(axes, seed, precision):
    u, kw = _readout_case(seed, axes=axes)
    want = des_readout_pallas(u, **kw, precision=precision, tb_t=64,
                              interpret=True)
    _assert_readout_close(_port_readout(u, kw, precision=precision), want,
                          precision)


@pytest.mark.parametrize("model", ["opendc", "linear", "sqrt", "cubic"])
def test_des_readout_matches_pallas_power_models(model):
    u, kw = _readout_case(11, axes=("mask", "cap", "failures"))
    want = des_readout_pallas(u, **kw, model=model, interpret=True)
    _assert_readout_close(_port_readout(u, kw, model=model), want)


def test_des_readout_unknown_model_and_precision_rejected():
    u, kw = _readout_case(0, t=8, h=3, axes=())
    with pytest.raises(ValueError, match="unknown power model"):
        _port_readout(u, kw, model="quartic")
    with pytest.raises(ValueError, match="unknown precision policy"):
        _port_readout(u, kw, precision="f16")


def test_cpu_tensors_take_the_plain_versions_without_counting():
    """CPU tensors run the plain versions; only kernel launches count."""
    ops.reset_launches()
    u, real, pi, pm, r = _calib_inputs(2, 16, 4, 3)
    want = ref.calib_mape_grid_ref(*(torch.from_numpy(a) for a in (u, real, pi, pm, r)))
    assert torch.equal(torch.from_numpy(_port_calib(u, real, pi, pm, r)), want)
    _port_readout(*_readout_case(3, t=8, h=3))
    ops.power_sim(torch.rand(8, 3), p_idle=70.0, p_max=350.0, r=2.0,
                  peak_tflops=1.0, dt_seconds=300.0)
    q = torch.randn(1, 2, 8, 16)
    assert torch.equal(ops.flash_attention(q, q[:, :1], q[:, :1]),
                       ref.flash_attention_ref(q, q[:, :1], q[:, :1]))
    x, dt, a, b, c, d = (torch.rand(shape) for shape in
                         ((2, 8, 2, 4), (2, 8, 2), (2,), (2, 8, 1, 3), (2, 8, 1, 3), (2,)))
    for got, want in zip(ops.ssd_chunk(x, dt, a, b, c, d),
                         ref.ssd_chunk_ref(x, dt, a, b, c, d)):
        assert torch.equal(got, want)
    lanes = [torch.tensor([[0, 0, 1]], dtype=torch.int32), torch.ones(1, 3, dtype=torch.int32),
             torch.ones(1, 3, dtype=torch.int32), torch.ones(1, 3, dtype=torch.bool),
             torch.ones(1, 2, dtype=torch.bool), torch.tensor([2]), torch.tensor([2]),
             torch.tensor([0])]
    start, host, attempts = ops.des_place(*lanes, t_bins=4)
    assert start.tolist() == [[0, 0, 1]] and host.tolist() == [[0, 1, 0]]
    assert attempts.tolist() == [3]          # two placements at bin 0, one at bin 1
    assert ops.LAUNCHES == {"calib_mape_grid": 0, "des_readout": 0,
                            "power_sim": 0, "flash_attention": 0,
                            "ssd_chunk": 0, "des_place": 0}
    with pytest.raises(ValueError, match="no kernel"):
        ops.calib_mape_grid(*(torch.from_numpy(a).to("meta")
                              for a in (u, real, pi, pm, r)))


_POWER = dict(p_idle=70.0, p_max=350.0, r=2.3, peak_tflops=120.0,
              dt_seconds=300.0)


@pytest.mark.parametrize("t,h", [(96, 17), (300, 277), (1024, 64)])
def test_power_sim_matches_pallas_sweep(t, h):
    """The test_power_sim_sweep shapes, at that sweep's tolerance."""
    u = np.random.default_rng(t + h).uniform(0, 1.1, (t, h)).astype(np.float32)
    want = power_sim_pallas(jnp.asarray(u), interpret=True, **_POWER)
    got = ops.power_sim(torch.from_numpy(u), **_POWER)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (t,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-2)


#: the test_flash_attention_sweep cases: (b, hq, hkv, sq, skv, d, causal, bf16)
_FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True, False),       # MHA causal
    (2, 8, 2, 100, 100, 32, True, False),       # GQA ragged seq
    (2, 4, 1, 64, 64, 64, False, False),        # MQA bidirectional
    (1, 6, 2, 1, 96, 64, True, False),          # decode shape
    (2, 4, 2, 128, 128, 64, True, True),        # bf16
    (1, 4, 4, 257, 257, 16, True, False),       # non-tile-aligned
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bf16", _FLASH_CASES)
def test_flash_attention_matches_pallas_sweep(b, hq, hkv, sq, skv, d, causal,
                                              bf16):
    """The attention sweep's shapes and bars (f32 rtol 2e-5 / atol 2e-4,
    bf16 rtol 2e-2 / atol 2e-1), against the Pallas kernel at 64-row
    tiles, the port's tile size."""
    rng = np.random.default_rng(b * 1000 + hq * 100 + sq + d)
    arrays = [rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
              for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]
    jdt = jnp.bfloat16 if bf16 else jnp.float32  # tracecheck: disable=TC005 — attention dtype sweep, not twin math
    tdt = torch.bfloat16 if bf16 else torch.float32  # tracecheck: disable=TC005 — attention dtype sweep, not twin math
    want = flash_attention_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                                  causal=causal, interpret=True, q_blk=64,
                                  k_blk=64)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)
