"""The card's order of summation in ``des_readout`` and ``power_sim``,
against the JAX package.

Both kernels (``csrc/des_readout.cu``, ``csrc/power_sim.cu``) sum over the
hosts in an order of their own: with ``split`` warps a bin
(:func:`warp_split`), thread (warp part p, lane l) adds the hosts p*32 + l,
p*32 + l + 32*split, ... in increasing order, across the readout's host
chunks of ``HOST_CHUNK`` staged rows; each warp ends with an xor-shuffle
butterfly over its 32 partials, and the bin's warp totals add in warp
order.  The readout's four sums are float64 (exact terms, rounded once at
the end), power_sim's float32.  The kernels run only on a card, so a
numpy model of that arithmetic (float32, float64 where the kernel is)
lives here, on no path, and is
held against the Pallas kernels in interpret mode at the bars
``chip_smoke.py`` holds the card kernels to (readout: rtol 1e-5, that of
``tests/test_torch_kernels.py``; power_sim: rtol 1e-4, atol 1e-2, the JAX
sweep's), at every split and across several host chunks.  ``chip_smoke.py`` then holds the card kernels
against their plain versions.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.power_sim import power_sim_pallas  # noqa: E402
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.kernels import des_readout as dr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_readout_lanes import lane_case, vmapped_pallas  # noqa: E402

F32 = np.float32
NEVER = np.iinfo(np.int32).max


def _tree(lanes):
    """The xor-shuffle butterfly over the last axis of 32 lanes (offsets 16,
    8, 4, 2, 1); float addition commutes, so every lane ends with these bits."""
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    return lanes[..., 0]


def host_sum(vals, split, chunk=dr.HOST_CHUNK):
    """Sum over the last (host) axis in the kernels' order, in ``vals``'s
    float type."""
    step = 32 * split
    acc = np.zeros(vals.shape[:-1] + (split, 32), vals.dtype)  # one per thread
    for h0 in range(0, vals.shape[-1], chunk):               # staged chunks
        part = vals[..., h0:h0 + chunk]
        pad = np.zeros(part.shape[:-1] + (-part.shape[-1] % step,), vals.dtype)
        rounds = np.concatenate([part, pad], axis=-1)
        rounds = rounds.reshape(rounds.shape[:-1] + (-1, split, 32))
        for i in range(rounds.shape[-3]):       # thread (p, l): host i*step + p*32 + l
            acc = acc + rounds[..., i, :, :]
    warps = _tree(acc)                                        # [..., split]
    total = warps[..., 0]
    for p in range(1, split):
        total = total + warps[..., p]
    return total


def _shape(uc, r, model):
    if model == "opendc":
        return F32(2) * uc - np.exp(r * np.log(np.maximum(uc, F32(1e-30))))
    return {"linear": uc, "sqrt": np.sqrt(uc), "cubic": uc * uc * uc}[model]


def readout_model(u, operands, split=None):
    """``[S, T]`` float32 leaves (f32 policy) with the card kernel's
    arithmetic, on ``ops.pack_readout``'s operands as numpy."""
    s, t, h = u.shape
    split = _launch.warp_split(s, t, h) if split is None else split

    def a(name, dtype=F32):
        x = operands[name]
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, dtype)

    def row(name, dtype=F32):
        x = a(name, dtype)
        return x[:, None, :] if x.ndim else x

    def lane(name):
        x = a(name)
        return x[:, None] if x.ndim else x

    pi, kill = row("p_idle"), row("fail_kill") > 0
    span = row("p_max") - pi                                   # staged
    ws = np.where(kill, row("fail_start", np.int32), 0)       # outage window
    we = np.where(kill, row("fail_end", np.int32), 0)
    tt = np.arange(t, dtype=np.int32)[:, None]
    off = (tt >= ws) & (tt < we)
    on = np.broadcast_to(np.where(off, 0.0, 1.0) * row("mask", np.float64), u.shape)
    host_p = pi + span * _shape(np.clip(u, F32(0), F32(1)), row("r"), operands["model"])
    it, idle, us, ons = (host_sum(x.astype(np.float64) * on, split).astype(F32)
                         for x in (host_p, pi, u, np.ones((), F32)))
    util_raw = us / np.maximum(ons, F32(1))
    load = np.clip(util_raw, F32(0), F32(1))
    pue = lane("pue_base") + lane("pue_load_coeff") * (F32(1) - load)
    pue = pue + lane("pue_amb_coeff") * np.maximum(a("ambient") - lane("pue_amb_ref"), F32(0))
    demand, floor = it * pue, idle * pue
    cap = a("cap")
    power = np.minimum(demand, cap)
    throttle = np.clip((cap - floor) / np.maximum(demand - floor, F32(1e-9)), F32(0), F32(1))
    e = power * F32(operands["dt_seconds"] / 3600.0) / F32(1000)
    util = np.where(demand > cap, util_raw * throttle, util_raw)
    tflops = util * lane("peak_tflops")
    eff = tflops / np.maximum(e, F32(1e-9))
    leaves = (power, e, tflops, util, eff, e * a("intensity"), demand, pue, e * a("price"))
    return {k: np.broadcast_to(v, (s, t)) for k, v in zip(ref.READOUT_FIELDS, leaves)}


def _packed(u, lanes, shared, model="opendc"):
    from repro_torch.kernels import ops

    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in {**lanes, **shared}.items()}
    kw["r"] = kw["r"][:, None]
    _, operands = ops.pack_readout(torch.from_numpy(u), **kw, model=model)
    return operands


#: (S, T, H, split): the E2 window and horizon and a what-if batch at the
#: rule's split, every split at three host chunks (2100 = 1024 + 1024 +
#: 52), hosts not a multiple of 32, one host, one bin
READOUT_CASES = [(1, 36, 277, None), (1, 200, 277, None), (3, 24, 424, None),
                 (3, 20, 2100, 1), (3, 20, 2100, 2), (3, 20, 2100, 4),
                 (3, 20, 2100, 8), (2, 30, 33, 2), (4, 9, 1, 1), (2, 1, 277, 8)]


@pytest.mark.parametrize("s,t,h,split", READOUT_CASES)
def test_readout_order_matches_vmapped_pallas(s, t, h, split):
    u, lanes, shared = lane_case(s * 1000 + t + h, s=s, t=t, h=h)
    got = readout_model(u, _packed(u, lanes, shared), split)
    want = vmapped_pallas(u, lanes, shared)
    for k in ref.READOUT_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("model", ["linear", "sqrt", "cubic"])
def test_readout_order_matches_vmapped_pallas_power_models(model):
    u, lanes, shared = lane_case(9, s=2, t=16, h=300)
    got = readout_model(u, _packed(u, lanes, shared, model), 4)
    want = vmapped_pallas(u, lanes, shared, model=model)
    for k in ref.READOUT_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


_POWER = dict(p_idle=70.0, p_max=350.0, r=2.3, peak_tflops=120.0, dt_seconds=300.0)


def power_sim_model(u, split=None, **kw):
    """``(power, energy, tflops)`` with the card kernel's float32 arithmetic."""
    t, h = u.shape
    split = _launch.warp_split(1, t, h) if split is None else split
    c = ref.power_sim_constants(h, p_idle=kw["p_idle"], p_max=kw["p_max"],
                                peak_tflops=kw["peak_tflops"], dt_seconds=kw["dt_seconds"])
    x = np.clip(u, F32(0), F32(1))
    shape = host_sum(F32(2) * x - np.exp(F32(kw["r"]) * np.log(np.maximum(x, F32(1e-30)))),
                     split)
    power = F32(c["base"]) + F32(c["span"]) * shape
    return power, power * F32(c["e_factor"]), host_sum(x, split) / F32(h) * F32(c["peak"])


@pytest.mark.parametrize("t,h,split", [
    (96, 17, None), (300, 277, None), (1024, 64, None), (2016, 277, None),
    (40, 300, 1), (40, 300, 2), (40, 300, 4), (40, 300, 8),
])
def test_power_sim_order_matches_pallas(t, h, split):
    """The JAX sweep's shapes and the E2 horizon at the rule's split, and
    every split, at the sweep's bar."""
    u = np.random.default_rng(t + h).uniform(0, 1.1, (t, h)).astype(F32)
    want = power_sim_pallas(jnp.asarray(u), interpret=True, **_POWER)
    for g, w in zip(power_sim_model(u, split, **_POWER), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("s,t,h,want", [
    (1, 36, 277, 8), (1, 2016, 277, 2), (16, 576, 424, 1), (64, 2016, 277, 1),
    (1, 600, 277, 4), (1, 36, 1, 1), (1, 36, 33, 2), (1, 36, 130, 4),
    (3, 40, 5000, 8), (1, 0, 277, 8), (1, 36, 0, 1),
])
def test_warp_split_fills_the_card_where_it_can(s, t, h, want):
    """A warp per bin where that launches ``TARGET_BLOCKS`` blocks; else the
    least split that does, never more warps than 32-host slices."""
    split = _launch.warp_split(s, t, h)
    assert split == want
    assert split in (1, 2, 4, 8) and split <= max(1, -(-h // 32))
    blocks = lambda k: s * -(-t // (_launch.WARPS // k))  # noqa: E731
    if split > 1:
        assert blocks(split // 2) < _launch.TARGET_BLOCKS


def test_wrapper_limits_are_the_sources():
    """The limits the wrappers and the models plan with are the sources'."""
    csrc = pathlib.Path(dr.__file__).parent / "csrc"
    want = {"kWarps": _launch.WARPS, "kUnroll": _launch.UNROLL}
    for name, extra in (("des_readout", {"kHostChunk": dr.HOST_CHUNK,
                                         "kMaxLanes": dr.MAX_LANES}),
                        ("power_sim", {})):
        src = (csrc / f"{name}.cu").read_text()
        consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
        assert {k: consts[k] for k in {**want, **extra}} == {**want, **extra}, name
    assert dr.HOST_CHUNK % (32 * _launch.WARPS) == 0      # chunks keep each thread's hosts
