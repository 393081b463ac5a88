"""The card's ``calib_mape_grid`` order of summation, against the JAX package.

The kernel (``csrc/calib_mape.cu``) sums in an order of its own: each
(bin, distinct r) sum over hosts in chunks of ``HOST_CHUNK``, lane l of a
warp over hosts l, l+32, ... then an xor-shuffle tree (hosts in order when
H < 32), chunk totals in chunk order; each candidate's relative errors in
bin order within a bin tile of :func:`bin_tile`, the tiles' partials in
tile order, then ``* (100 / n)``.  The kernel runs only on a card, so a
float32 numpy model of that arithmetic lives here, on no path, and is held
against the Pallas kernel in interpret mode at the bar ``chip_smoke.py``
holds the card kernel to (rtol 1e-4, atol 1e-3); its argmin on an E2-like
window equals the plain version's.  ``chip_smoke.py`` then holds the card
kernel against its plain version.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.calib_mape import calib_mape_grid_pallas  # noqa: E402
from repro_torch.core.calibrate import CalibrationSpec, candidate_grid  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.kernels import calib_mape as cm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = np.float32
EPS = F32(1e-9)


def _tree(lanes):
    """The xor-shuffle tree over the last axis of 32 lanes, as lane 0 ends it."""
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    return lanes[..., 0]


def host_sum(vals):
    """Sum over the last (host) axis in the kernel's order, float32."""
    h = vals.shape[-1]
    if h < cm.WARP_HOSTS:
        total = np.zeros(vals.shape[:-1], F32)
        for i in range(h):
            total = total + vals[..., i]
        return total
    total = None
    for h0 in range(0, h, cm.HOST_CHUNK):
        chunk = vals[..., h0:h0 + cm.HOST_CHUNK]
        pad = np.zeros(chunk.shape[:-1] + (-chunk.shape[-1] % 32,), F32)
        rows = np.concatenate([chunk, pad], axis=-1)
        rows = rows.reshape(rows.shape[:-1] + (-1, 32))
        lanes = np.zeros(rows.shape[:-2] + (32,), F32)
        for i in range(rows.shape[-2]):        # lane l: hosts l, l+32, ...
            lanes = lanes + rows[..., i, :]
        chunk_total = _tree(lanes)
        total = chunk_total if total is None else total + chunk_total
    return total


def kernel_model(u, real, p_idle, p_max, r):
    """``[B, C]`` MAPE [%] with the card kernel's float32 arithmetic."""
    b, t, h = u.shape
    c = r.shape[0]
    tile = cm.bin_tile(b, t, h, c)
    x = np.clip(u, F32(0), F32(1))
    log_u = np.log(np.maximum(x, F32(1e-30)))
    s2 = host_sum(F32(2) * x)                                    # [B, T]
    bits, slot = np.unique(r.view(np.uint32), return_inverse=True)
    sr = np.stack([host_sum(np.exp(rk * log_u))
                   for rk in bits.view(F32)], axis=-1)[..., slot]  # [B, T, C]
    base = F32(h) * p_idle
    span = p_max - p_idle
    acc = np.zeros((b, c), F32)
    for t0 in range(0, t, tile):                                 # pass 1 tiles
        part = np.zeros((b, c), F32)
        for i in range(t0, min(t, t0 + tile)):
            re_ = real[:, i:i + 1]
            sim = base + span * (s2[:, i:i + 1] - sr[:, i, :])
            rel = np.abs((re_ - sim) / (np.abs(re_) + EPS))
            part = np.where(np.abs(re_) > EPS, part + rel, part)
        acc = acc + part                                         # pass 2
    n = (np.abs(real) > EPS).sum(axis=1)
    scale = F32(100) / np.maximum(n, 1).astype(F32)
    return np.where(n[:, None] > 0, acc * scale[:, None], F32(np.nan))


def _inputs(seed, b, t, h, c):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, t, h)).astype(F32),
            rng.uniform(1e3, 5e3, (b, t)).astype(F32),
            rng.uniform(50, 90, (c,)).astype(F32),
            rng.uniform(250, 450, (c,)).astype(F32),
            rng.uniform(1, 6, (c,)).astype(F32))


def _pallas(u, real, pi, pm, r):
    """Row by row through ``calib_mape_grid_pallas(interpret=True)``."""
    return np.stack([np.asarray(calib_mape_grid_pallas(
        *(jnp.asarray(a) for a in (u[i], real[i], pi, pm, r)), interpret=True))
        for i in range(u.shape[0])])


def _e2_like(seed, mode):
    """An E2-like calibration window (4 windows x 36 bins, 277 hosts) whose
    measured power is the model at a parameter set off the grid, with 2 %
    noise, and the grid that ``candidate_grid`` builds for ``mode``."""
    rng = np.random.default_rng(seed)
    load = rng.uniform(0.1, 0.9, (1, 144, 1))
    u = np.clip(load + rng.normal(0, 0.2, (1, 144, 277)), 0, 1).astype(F32)
    p_idle, p_max, r = 73.0, 338.0, 2.71
    power = (277 * p_idle + (p_max - p_idle) * (2 * u - u ** r).sum(axis=2))
    real = (power * (1 + rng.normal(0, 0.02, power.shape))).astype(F32)
    grid = candidate_grid(CalibrationSpec(mode=mode), PowerParams(), device="cpu")
    return u, real, *(x.numpy() for x in (grid.p_idle, grid.p_max, grid.r))


@pytest.mark.parametrize("t,h,c", [
    (64, 16, 8), (100, 64, 33), (288, 277, 64), (512, 128, 200),
])
def test_kernel_order_matches_pallas_sweep(t, h, c):
    """The test_calib_mape_sweep shapes, at that sweep's tolerance."""
    args = _inputs(t * 7 + c, 1, t, h, c)
    np.testing.assert_allclose(kernel_model(*args), _pallas(*args),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b,t,h,c", [(5, 64, 1, 16), (2, 40, 1100, 7)])
def test_kernel_order_matches_pallas_batched(b, t, h, c):
    """A per-host-refit batch (H=1: one thread per sum) and a window of
    three host chunks (1100 = 512 + 512 + 76) with a zero-real bin."""
    u, real, pi, pm, r = _inputs(b * t + h, b, t, h, c)
    real[:, ::5] = 0.0
    np.testing.assert_allclose(kernel_model(u, real, pi, pm, r),
                               _pallas(u, real, pi, pm, r), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shuffled", [False, True])
def test_kernel_order_matches_pallas_on_the_e2_joint_grid(shuffled):
    """The joint grid as ``candidate_grid`` builds it (9216 candidates, 64
    distinct r in runs of 144, which cross the 256-candidate tiles), and
    the same grid shuffled."""
    u, real, pi, pm, r = _e2_like(3, "joint")
    assert pi.shape == (9216,) and np.unique(r).shape == (64,)
    if shuffled:
        perm = np.random.default_rng(4).permutation(r.shape[0])
        pi, pm, r = pi[perm], pm[perm], r[perm]
    np.testing.assert_allclose(kernel_model(u, real, pi, pm, r),
                               _pallas(u, real, pi, pm, r), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mode", ["r_only", "joint"])
def test_kernel_order_keeps_the_plain_argmin(mode):
    """On an E2-like window the model's best candidate is the plain
    version's, as is its MAPE to the bar."""
    u, real, pi, pm, r = _e2_like(11, mode)
    got = kernel_model(u, real, pi, pm, r)[0]
    want = ref.calib_mape_grid_ref(*(torch.from_numpy(a) for a in (u, real, pi, pm, r)))[0]
    assert int(np.argmin(got)) == int(torch.argmin(want))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-3)
    assert got.min() < 3.0                       # the fit is a real one


def test_wrapper_limits_are_the_sources():
    """The tile limits the wrapper plans with are the kernel source's."""
    src = (pathlib.Path(cm.__file__).parent / "csrc" / "calib_mape.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: consts[k] for k in ("kThreads", "kMaxBins", "kHostChunk", "kStage",
                                   "kSums", "kWarpHosts")} == {
        "kThreads": cm.CAND_TILE, "kMaxBins": cm.MAX_BINS,
        "kHostChunk": cm.HOST_CHUNK, "kStage": cm.STAGE, "kSums": cm.SUMS,
        "kWarpHosts": cm.WARP_HOSTS}


@pytest.mark.parametrize("b,t,h,c", [
    (1, 144, 277, 64), (1, 144, 277, 9216), (277, 144, 1, 64), (1, 97, 33, 130),
    (3, 300, 2500, 5), (2, 1, 277, 64), (1, 144, 277, 1), (1, 0, 277, 64),
])
def test_bin_tile_fits_the_block_and_fills_the_card(b, t, h, c):
    """The bin tile fits the block's shared memory, and pass 1 launches at
    least one wave of an H100's 132 SMs wherever the window has the bins."""
    tile = cm.bin_tile(b, t, h, c)
    assert 1 <= tile <= cm.MAX_BINS
    assert tile * min(h, cm.HOST_CHUNK) <= cm.STAGE
    assert tile * (min(c, cm.CAND_TILE) + 1) <= cm.SUMS
    blocks = b * -(-c // cm.CAND_TILE) * -(-t // tile)
    assert blocks >= min(132, b * -(-c // cm.CAND_TILE) * t)
